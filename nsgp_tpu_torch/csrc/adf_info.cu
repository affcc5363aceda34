// What the wrappers of the ADF kernels (K3, K4) ask before a launch: the
// thread count, the widest model, the cluster size for S sigma points and the
// number of probe phases.

#include "adf_step.cuh"

extern "C" {

int nsgp_adf_threads() { return ADF_THREADS; }
int nsgp_adf_max_width() { return ADF_MAX_WIDTH; }
int nsgp_adf_cluster(int S) { return adf_cluster_size(S); }
int nsgp_adf_probe_phases() { return ADF_PROBE_PHASES; }

}  // extern "C"
