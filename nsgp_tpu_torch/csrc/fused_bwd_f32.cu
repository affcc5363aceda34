// K2 (fused_kalman.cuh) in float32.

#include "fused_kalman.cuh"

NSGP_DEFINE_FUSED_BWD(f32, float)
