// K4b-slab (and K3, K3b): words14 rows, unpacked a chunk at a time
// into a shared-memory slab.
// One translation unit of the kernel library: the fused tick's
// instantiations for this encoding (the kernels are in tpg.cuh).
#include "tpg.cuh"

cudaError_t tpg::launch_slab14(const Params& p, const Variant& v, cudaStream_t s) {
  return dispatch_fused<kSlab14>(p, v, s);
}
