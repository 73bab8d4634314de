// K1 (the threshold families' pipeline), K3 (the FIR pipeline) and K3b
// (its mode with fir_packed): the time2 datapath.
// One translation unit of the kernel library: the fused tick's
// instantiations for this encoding (the kernels are in tpg.cuh).
#include "tpg.cuh"

cudaError_t tpg::launch_time2(const Params& p, const Variant& v, cudaStream_t s) {
  return dispatch_fused<kTime2>(p, v, s);
}
