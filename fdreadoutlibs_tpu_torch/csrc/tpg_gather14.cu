// K4b-gather: words14 rows staged into the pipeline's ring, each warp's
// words read once and shared through shared memory, for every family (the
// threshold families' pipeline, K3's for FIR, K3b's with fir_packed).
// One translation unit of the kernel library: the fused tick's
// instantiations for this encoding (the kernels are in tpg.cuh).
#include "tpg.cuh"

cudaError_t tpg::launch_gather14(const Params& p, const Variant& v, cudaStream_t s) {
  return dispatch_fused<kGather14>(p, v, s);
}
