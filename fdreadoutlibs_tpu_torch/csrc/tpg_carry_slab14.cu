// K4b-slab (the pipeline; K3b's slab kernel with fir_packed): words14 rows
// unpacked into time2 slabs, with the SLOT_WORD_CARRY emission layout
// (CarrySlots in tpg.cuh).
// One translation unit of the kernel library: the fused tick's
// instantiations for this encoding with the carry layout, apart from the
// direct-store unit so both build in parallel.
#include "tpg.cuh"

cudaError_t tpg::launch_carry_slab14(const Params& p, const Variant& v,
                                     cudaStream_t s) {
  return dispatch_fused<kSlab14, true>(p, v, s);
}
