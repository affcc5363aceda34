// K4 (fused_adf_mb.cuh) in float64.

#include "fused_adf_mb.cuh"

NSGP_DEFINE_FUSED_ADF_MB(f64, double)
