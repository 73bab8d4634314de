// K5, the two-pass FIR schedule, on packed 14-bit words (K4's decode and K4b-gather's).
// One translation unit of the kernel library (the kernel is in tpg.cuh).
#include "tpg.cuh"

cudaError_t tpg::launch_fir2_packed(const Params& p, const Variant& v,
                                     int encoding, bool lift,
                                     cudaStream_t s) {
  switch (encoding) {
    case kPacked14:
      return dispatch_fir2<kPacked14>(p, v, lift, s);
    case kGather14:
      return dispatch_fir2<kGather14>(p, v, lift, s);
    default:
      return cudaErrorInvalidValue;
  }
}
