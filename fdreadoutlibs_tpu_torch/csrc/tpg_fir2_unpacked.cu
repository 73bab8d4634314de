// K5, the two-pass FIR schedule, on plain and time2 feeds.
// One translation unit of the kernel library (the kernel is in tpg.cuh).
#include "tpg.cuh"

cudaError_t tpg::launch_fir2_unpacked(const Params& p, const Variant& v,
                                       int encoding, bool lift,
                                       cudaStream_t s) {
  switch (encoding) {
    case kPlain:
      return dispatch_fir2<kPlain>(p, v, lift, s);
    case kTime2:
      return dispatch_fir2<kTime2>(p, v, lift, s);
    default:
      return cudaErrorInvalidValue;
  }
}
