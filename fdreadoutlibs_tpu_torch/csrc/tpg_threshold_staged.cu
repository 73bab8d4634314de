// The threshold pipeline's staged arm: one warp per 32 channels copies the
// feed into the shared-memory ring ahead of its chain and runs
// ThresholdChannel's whole fused tick, on time2 rows, plain samples, packed
// 14-bit words and int16 samples (on the int16 state).  Not on any entry
// of ops/tpg.py: the probes measure it against K1, K2, K4 and K2b (the
// feed staging without the warp split).
// One translation unit of the kernel library (the kernel is in tpg.cuh).
#include "tpg.cuh"

cudaError_t tpg::launch_threshold_staged(const Params& p, const Variant& v,
                                         int encoding, cudaStream_t s) {
  switch (encoding) {
    case kPlain:
      return dispatch_threshold_staged<kPlain>(p, v, s);
    case kTime2:
      return dispatch_threshold_staged<kTime2>(p, v, s);
    case kPlain16:
      return dispatch_threshold_staged<kPlain16>(p, v, s);
    case kPacked14:
      return dispatch_threshold_staged<kPacked14>(p, v, s);
    default:
      return cudaErrorInvalidValue;
  }
}
