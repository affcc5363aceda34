// K6 (fused_ihgp_smooth.cuh) in float64.

#include "fused_ihgp_smooth.cuh"

NSGP_DEFINE_FUSED_IHGP_SMOOTH(f64, double)
