// K2 (fused_kalman.cuh) in float64.

#include "fused_kalman.cuh"

NSGP_DEFINE_FUSED_BWD(f64, double)
