// K5 (fused_ihgp_adf.cuh) in float32.

#include "fused_ihgp_adf.cuh"

NSGP_DEFINE_FUSED_IHGP_ADF(f32, float)
