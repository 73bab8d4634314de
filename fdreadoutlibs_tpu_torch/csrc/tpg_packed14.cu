// K4: packed 14-bit words, frame words or words14 rows, staged into the
// pipeline's ring and decoded there, for every family (the threshold
// families' pipeline, K3's for FIR; K3b's fused tick with fir_packed).
// One translation unit of the kernel library: the fused tick's
// instantiations for this encoding (the kernels are in tpg.cuh).
#include "tpg.cuh"

cudaError_t tpg::launch_packed14(const Params& p, const Variant& v, cudaStream_t s) {
  return dispatch_fused<kPacked14>(p, v, s);
}
