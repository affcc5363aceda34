// K3 (fused_adf.cuh) in float64.

#include "fused_adf.cuh"

NSGP_DEFINE_FUSED_ADF(f64, double)
