// K2 (and K3, K3b): the plain-sample datapath on an int32 state,
// with the SLOT_WORD_CARRY emission layout (CarrySlots in tpg.cuh).
// One translation unit of the kernel library: the fused tick's
// instantiations for this encoding with the carry layout, apart from the
// direct-store unit so both build in parallel.
#include "tpg.cuh"

cudaError_t tpg::launch_carry_plain(const Params& p, const Variant& v,
                                    cudaStream_t s) {
  return dispatch_fused<kPlain, true>(p, v, s);
}
