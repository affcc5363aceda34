// K5 (fused_ihgp_adf.cuh) in float64.

#include "fused_ihgp_adf.cuh"

NSGP_DEFINE_FUSED_IHGP_ADF(f64, double)
