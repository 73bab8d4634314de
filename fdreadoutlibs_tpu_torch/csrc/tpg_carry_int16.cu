// K2b: the int16 state and feed,
// with the SLOT_WORD_CARRY emission layout (CarrySlots in tpg.cuh; in
// columns of 32 in the pipeline).
// One translation unit of the kernel library: the fused tick's
// instantiations for this encoding with the carry layout, apart from the
// direct-store unit so both build in parallel.
#include "tpg.cuh"

cudaError_t tpg::launch_carry_int16(const Params& p, const Variant& v,
                                    cudaStream_t s) {
  return dispatch_fused<kPlain16, true>(p, v, s);
}
