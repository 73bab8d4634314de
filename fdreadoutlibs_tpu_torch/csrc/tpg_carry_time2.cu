// K1 (and K3, K3b): the time2 datapath,
// with the SLOT_WORD_CARRY emission layout (CarrySlots in tpg.cuh; in
// columns of 32 in the pipelines).
// One translation unit of the kernel library: the fused tick's
// instantiations for this encoding with the carry layout, apart from the
// direct-store unit so both build in parallel.
#include "tpg.cuh"

cudaError_t tpg::launch_carry_time2(const Params& p, const Variant& v,
                                    cudaStream_t s) {
  return dispatch_fused<kTime2, true>(p, v, s);
}
