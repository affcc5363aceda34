// K9 (fused_resite.cuh) in float64.

#include "fused_resite.cuh"

NSGP_DEFINE_FUSED_RESITE(f64, double)
