// K2b: every family on an int16 state and feed (plain datapath), the
// pipeline's threshold mode and its FIR mode (K3's) on the int16 arithmetic.
// One translation unit of the kernel library: the fused tick's
// instantiations for this encoding (the kernels are in tpg.cuh).
#include "tpg.cuh"

cudaError_t tpg::launch_int16(const Params& p, const Variant& v, cudaStream_t s) {
  return dispatch_fused<kPlain16>(p, v, s);
}
