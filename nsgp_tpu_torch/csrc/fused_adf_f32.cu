// K3 (fused_adf.cuh) in float32.

#include "fused_adf.cuh"

NSGP_DEFINE_FUSED_ADF(f32, float)
