// K4 (fused_adf_mb.cuh) in float32.

#include "fused_adf_mb.cuh"

NSGP_DEFINE_FUSED_ADF_MB(f32, float)
