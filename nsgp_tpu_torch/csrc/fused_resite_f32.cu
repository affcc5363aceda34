// K9 (fused_resite.cuh) in float32.

#include "fused_resite.cuh"

NSGP_DEFINE_FUSED_RESITE(f32, float)
