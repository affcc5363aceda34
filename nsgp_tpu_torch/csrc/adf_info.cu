// What the wrappers of the ADF kernels (K3, K4, K5, K7, K8) ask before a
// launch: the thread count, the widest model, the cluster size for S sigma
// points, the number of probe phases and the float64 scratch of K7 and K8.

#include "fused_adf_vjp.cuh"
#include "fused_ihgp_adf_vjp.cuh"

extern "C" {

int nsgp_adf_threads() { return ADF_THREADS; }
int nsgp_adf_max_width() { return ADF_MAX_WIDTH; }
int nsgp_adf_cluster(int S) { return adf_cluster_size(S); }
int nsgp_adf_probe_phases() { return ADF_PROBE_PHASES; }
long long nsgp_adf_vjp_scratch(int D, int N, int bs) {
  return (long long)vjp_scratch_doubles(D, N, bs);
}
long long nsgp_ihgp_adf_vjp_scratch(int D, int N, int bs, int G) {
  return (long long)ihgp_vjp_scratch_doubles(D, N, bs, G);
}

}  // extern "C"
