// K1 (fused_kalman.cuh) in float32.

#include "fused_kalman.cuh"

NSGP_DEFINE_FUSED_FWD(f32, float)
