// What the wrappers of the ADF kernels (K3, K4, K5, K7, K8) ask before a
// launch: the thread count, the widest model, the cluster size for S sigma
// points, the number of probe phases, the float64 scratch of K7 and K8 and
// K7's record.

#include "fused_adf_vjp.cuh"
#include "fused_ihgp_adf_vjp.cuh"

extern "C" {

int nsgp_adf_threads() { return ADF_THREADS; }
int nsgp_adf_max_width() { return ADF_MAX_WIDTH; }
int nsgp_adf_cluster(int S) { return adf_cluster_size(S); }
int nsgp_adf_probe_phases() { return ADF_PROBE_PHASES; }
int nsgp_adf_vjp_probe_slots() { return VJP_PROBE_SLOTS; }
long long nsgp_adf_vjp_scratch(int D, int N, int bs) {
  return (long long)vjp_scratch_doubles(D, N, bs);
}
// Values of K7's record a step, with the per-point part (stash) or without;
// -1 where the walk cannot read a per-point part at these widths.
long long nsgp_adf_vjp_record(int D, int N, int S, int bs, int elem, int stash) {
  if (stash && !vjp_can_stash(D, N, S, bs, (size_t)elem)) return -1;
  return (long long)vjp_layout(D, N, S, bs, (size_t)elem, stash).R.blk;
}
long long nsgp_ihgp_adf_vjp_scratch(int D, int N, int bs, int G) {
  return (long long)ihgp_vjp_scratch_doubles(D, N, bs, G);
}

}  // extern "C"
