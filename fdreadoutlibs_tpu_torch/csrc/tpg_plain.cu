// K2 (the threshold families' pipeline), K3 (the FIR pipeline) and K3b
// (its mode with fir_packed): the plain-sample datapath on an int32 state.
// One translation unit of the kernel library: the fused tick's
// instantiations for this encoding (the kernels are in tpg.cuh).
#include "tpg.cuh"

cudaError_t tpg::launch_plain(const Params& p, const Variant& v, cudaStream_t s) {
  return dispatch_fused<kPlain>(p, v, s);
}
