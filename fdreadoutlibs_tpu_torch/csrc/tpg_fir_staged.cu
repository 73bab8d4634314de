// The pipeline's staged arm: one warp per 32 channels copies the feed into
// the shared-memory ring ahead of its chain and runs the whole FIR tick, on
// plain and time2 feeds.  Not on any entry of ops/tpg.py: the probes
// measure it against K3 (the feed staging without the warp split).
// One translation unit of the kernel library (the kernel is in tpg.cuh).
#include "tpg.cuh"

cudaError_t tpg::launch_fir_staged(const Params& p, const Variant& v,
                                   int encoding, cudaStream_t s) {
  switch (encoding) {
    case kPlain:
      return dispatch_pipe<kPlain, kPipeStaged>(p, v, s);
    case kTime2:
      return dispatch_pipe<kTime2, kPipeStaged>(p, v, s);
    default:
      return cudaErrorInvalidValue;
  }
}
