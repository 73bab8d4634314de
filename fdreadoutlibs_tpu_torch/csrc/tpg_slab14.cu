// K4b-slab: words14 rows staged into the pipeline's ring and unpacked a
// stage at a time into a time2 slab, for every family (the threshold
// families' pipeline, K3's for FIR; K3b's slab kernel with fir_packed).
// One translation unit of the kernel library: the fused tick's
// instantiations for this encoding (the kernels are in tpg.cuh).
#include "tpg.cuh"

cudaError_t tpg::launch_slab14(const Params& p, const Variant& v, cudaStream_t s) {
  return dispatch_fused<kSlab14>(p, v, s);
}
