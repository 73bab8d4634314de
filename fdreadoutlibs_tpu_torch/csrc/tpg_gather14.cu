// K4b-gather (and K3, K3b): words14 rows, the words shared by a warp
// shuffle.
// One translation unit of the kernel library: the fused tick's
// instantiations for this encoding (the kernels are in tpg.cuh).
#include "tpg.cuh"

cudaError_t tpg::launch_gather14(const Params& p, const Variant& v, cudaStream_t s) {
  return dispatch_fused<kGather14>(p, v, s);
}
