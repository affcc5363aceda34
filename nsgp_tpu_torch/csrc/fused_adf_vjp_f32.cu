// K7 (fused_adf_vjp.cuh) in float32.

#include "fused_adf_vjp.cuh"

NSGP_DEFINE_FUSED_ADF_VJP(f32, float)
