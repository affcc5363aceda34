// K8 (fused_ihgp_adf_vjp.cuh) in float64.

#include "fused_ihgp_adf_vjp.cuh"

NSGP_DEFINE_FUSED_IHGP_ADF_VJP(f64, double)
