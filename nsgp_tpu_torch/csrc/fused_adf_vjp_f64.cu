// K7 (fused_adf_vjp.cuh) in float64.

#include "fused_adf_vjp.cuh"

NSGP_DEFINE_FUSED_ADF_VJP(f64, double)
