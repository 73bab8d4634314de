// K4 (and K3, K3b): packed 14-bit words, frame words or words14 rows.
// One translation unit of the kernel library: the fused tick's
// instantiations for this encoding (the kernels are in tpg.cuh).
#include "tpg.cuh"

cudaError_t tpg::launch_packed14(const Params& p, const Variant& v, cudaStream_t s) {
  return dispatch_fused<kPacked14>(p, v, s);
}
