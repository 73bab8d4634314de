// K2b: every family on an int16 state and feed (plain datapath).
// One translation unit of the kernel library: the fused tick's
// instantiations for this encoding (the kernels are in tpg.cuh).
#include "tpg.cuh"

cudaError_t tpg::launch_int16(const Params& p, const Variant& v, cudaStream_t s) {
  return dispatch_fused<kPlain16>(p, v, s);
}
