// The C entries of the SWTPG kernel library (ctypes, ops/tpg.py).  The
// kernels are in tpg.cuh; each tpg_<encoding>.cu instantiates them for one
// input encoding (tpg_int16.cu for the int16 state, tpg_fir2_*.cu for K5),
// so the units build in parallel and link into one library
// (ops/_build.py; tpg_fir_staged.cu and tpg_threshold_staged.cu the
// pipeline's staged arms).
#include "device_scope.cuh"
#include "tpg.cuh"

namespace {

// The C entries' shared arguments -> Params; false on a value the kernels
// do not take.
bool make_params(Params& p, const void* feed, int feed_stride, int encoding,
                 int groups_per_row, int group_outer, int group_inner,
                 int word_stride, int n_chunks, int ticks_per_chunk,
                 void* state, int n_channels, void* slots, void* nclose,
                 int k_slots, int threshold, int accumulator_limit,
                 int rs_scale_factor_x10, const int* taps, int tap_exponent,
                 int adc_max, int sigma_cap, int thr_mult) {
  const bool packed = encoding == kPacked14 || encoding == kGather14 ||
                      encoding == kSlab14;
  const bool bad_layout =
      packed ? (n_channels % 16 || groups_per_row <= 0 || group_outer < 0 ||
                group_inner < 0 || word_stride <= 0 || feed_stride <= 0)
             : feed_stride < n_channels;
  // K4b-slab unpacks whole groups of ticks
  const bool bad_slab = encoding == kSlab14 && ticks_per_chunk % kGroup;
  if (n_channels <= 0 || n_chunks <= 0 || ticks_per_chunk <= 0 ||
      k_slots <= 0 || bad_layout || bad_slab ||
      (encoding == kTime2 && ticks_per_chunk % 2) || tap_exponent < 0 ||
      tap_exponent > 15 || taps == nullptr)
    return false;
  p = Params{};
  p.feed = feed;
  p.feed_stride = feed_stride;
  p.groups_per_row = groups_per_row;
  p.group_outer = group_outer;
  p.group_inner = group_inner;
  p.word_stride = word_stride;
  p.n_chunks = n_chunks;
  p.ticks_per_chunk = ticks_per_chunk;
  p.state = state;
  p.n_channels = n_channels;
  p.slots = static_cast<int32_t*>(slots);
  p.nclose = static_cast<int32_t*>(nclose);
  p.k_slots = k_slots;
  p.threshold = threshold;
  p.accumulator_limit = accumulator_limit;
  p.rs_scale_factor_x10 = rs_scale_factor_x10;
  for (int j = 0; j < kTaps; ++j) p.taps[j] = taps[j];
  p.tap_exponent = tap_exponent;
  p.adc_max = adc_max;
  p.sigma_cap = sigma_cap;
  p.thr_mult = thr_mult;
  return true;
}

}  // namespace

// Plain C entries for ctypes.  Each returns the cudaError_t of the launch
// (cudaGetLastError right after it); the caller raises when it is not 0.
// `taps` is a host array of 8 ints (read only for the FIR family).
// `encoding` is kPlain or kTime2 (rows of feed_stride >= n_channels
// values) or a packed one, kPacked14, kGather14 or kSlab14: word (t, j) of
// channel group g sits at (g / groups_per_row) * group_outer +
// (g % groups_per_row) * group_inner + t * feed_stride + j * word_stride
// (the group_* and word_stride arguments are read only for those).
// `int16` selects the int16 state and feed (kPlain only), `fir_packed` the
// SWAR carry (FIR on an int32 state), `rs_float` the float running sum (the
// RS families; ignored for the others), `slot_word_carry` the emission
// layout that keeps a chunk's records in registers and shared memory until
// its end (ops/tpg.py::SLOT_WORD_CARRY; the launch is refused when that
// staging does not fit a block's shared memory).
//
// tpg_launch: K1-K4 and K2b, K3b, K4b, the fused tick of every family,
// each a mode of the pipeline of tpg.cuh.
extern "C" int tpg_launch(const void* feed, int feed_stride, int encoding,
                          int groups_per_row, int group_outer,
                          int group_inner, int word_stride, int n_chunks,
                          int ticks_per_chunk, void* state, int n_channels,
                          void* slots, void* nclose, int k_slots, int family,
                          int peak_gated, int charge_floor, int track_peaks,
                          int avx, int threshold, int accumulator_limit,
                          int rs_scale_factor_x10, const int* taps,
                          int tap_exponent, int adc_max, int sigma_cap,
                          int thr_mult, int int16, int fir_packed,
                          int rs_float, int slot_word_carry, int device,
                          void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess)
    return static_cast<int>(scope.error());
  Params p;
  if (family < kSimpleThreshold || family > kFIR ||
      (fir_packed && (family != kFIR || int16)) ||
      (int16 && encoding != kPlain) ||
      !make_params(p, feed, feed_stride, encoding, groups_per_row,
                   group_outer, group_inner, word_stride, n_chunks,
                   ticks_per_chunk, state, n_channels, slots, nclose, k_slots,
                   threshold, accumulator_limit, rs_scale_factor_x10, taps,
                   tap_exponent, adc_max, sigma_cap, thr_mult))
    return static_cast<int>(cudaErrorInvalidValue);
  const Variant v{family,          peak_gated != 0, charge_floor != 0,
                  track_peaks != 0, avx != 0,       fir_packed != 0,
                  rs_float != 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool carry = slot_word_carry != 0;
  if (int16)
    return static_cast<int>(carry ? launch_carry_int16(p, v, s)
                                  : launch_int16(p, v, s));
  switch (encoding) {
    case kPlain:
      return static_cast<int>(carry ? launch_carry_plain(p, v, s)
                                    : launch_plain(p, v, s));
    case kTime2:
      return static_cast<int>(carry ? launch_carry_time2(p, v, s)
                                    : launch_time2(p, v, s));
    case kPacked14:
      return static_cast<int>(carry ? launch_carry_packed14(p, v, s)
                                    : launch_packed14(p, v, s));
    case kGather14:
      return static_cast<int>(carry ? launch_carry_gather14(p, v, s)
                                    : launch_gather14(p, v, s));
    case kSlab14:
      return static_cast<int>(carry ? launch_carry_slab14(p, v, s)
                                    : launch_slab14(p, v, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// tpg_fir2_launch: K5, the two-pass FIR schedule (the FIR family on an
// int32 state only, without fir_packed or the slab; `family`,
// `charge_floor`, `rs_float` and `slot_word_carry` are taken for a common
// argument list: the two-pass schedule has the direct store only, as
// _fir2_kernel never reads SLOT_WORD_CARRY).  `lift` selects
// fir_twopass=2.  Its slabs are the pipeline's shared-memory ring: it takes
// no scratch.
extern "C" int tpg_fir2_launch(
    const void* feed, int feed_stride, int encoding, int groups_per_row,
    int group_outer, int group_inner, int word_stride, int n_chunks,
    int ticks_per_chunk, void* state, int n_channels, void* slots,
    void* nclose, int k_slots, int family, int peak_gated, int charge_floor,
    int track_peaks, int avx, int threshold, int accumulator_limit,
    int rs_scale_factor_x10, const int* taps, int tap_exponent, int adc_max,
    int sigma_cap, int thr_mult, int int16, int fir_packed, int rs_float,
    int slot_word_carry, int lift, int device, void* stream) {
  (void)charge_floor;
  (void)rs_float;
  (void)slot_word_carry;
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess)
    return static_cast<int>(scope.error());
  Params p;
  if (family != kFIR || int16 || fir_packed ||
      !make_params(p, feed, feed_stride, encoding, groups_per_row,
                   group_outer, group_inner, word_stride, n_chunks,
                   ticks_per_chunk, state, n_channels, slots, nclose, k_slots,
                   threshold, accumulator_limit, rs_scale_factor_x10, taps,
                   tap_exponent, adc_max, sigma_cap, thr_mult))
    return static_cast<int>(cudaErrorInvalidValue);
  const Variant v{family, peak_gated != 0, false, track_peaks != 0,
                  avx != 0, false, false};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (encoding) {
    case kPlain:
    case kTime2:
      return static_cast<int>(
          launch_fir2_unpacked(p, v, encoding, lift != 0, s));
    case kPacked14:
    case kGather14:
      return static_cast<int>(
          launch_fir2_packed(p, v, encoding, lift != 0, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The pipeline's staged arms (one warp, the whole fused tick on a staged
// feed, direct store), with tpg_launch's arguments; the probes
// time them against the pipeline.  Same outputs as the fused tick.
//
// tpg_fir_staged_launch: the FIR family on plain or time2 rows, against K3.
extern "C" int tpg_fir_staged_launch(
    const void* feed, int feed_stride, int encoding, int groups_per_row,
    int group_outer, int group_inner, int word_stride, int n_chunks,
    int ticks_per_chunk, void* state, int n_channels, void* slots,
    void* nclose, int k_slots, int family, int peak_gated, int charge_floor,
    int track_peaks, int avx, int threshold, int accumulator_limit,
    int rs_scale_factor_x10, const int* taps, int tap_exponent, int adc_max,
    int sigma_cap, int thr_mult, int int16, int fir_packed, int rs_float,
    int slot_word_carry, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess)
    return static_cast<int>(scope.error());
  Params p;
  if (family != kFIR || int16 || fir_packed || slot_word_carry ||
      (encoding != kPlain && encoding != kTime2) ||
      !make_params(p, feed, feed_stride, encoding, groups_per_row,
                   group_outer, group_inner, word_stride, n_chunks,
                   ticks_per_chunk, state, n_channels, slots, nclose, k_slots,
                   threshold, accumulator_limit, rs_scale_factor_x10, taps,
                   tap_exponent, adc_max, sigma_cap, thr_mult))
    return static_cast<int>(cudaErrorInvalidValue);
  const Variant v{family, peak_gated != 0, charge_floor != 0,
                  track_peaks != 0, avx != 0, false, rs_float != 0};
  return static_cast<int>(launch_fir_staged(
      p, v, encoding, static_cast<cudaStream_t>(stream)));
}

// tpg_threshold_staged_launch: SimpleThreshold, AbsRS and StandardRS
// (rs_float included) on time2 rows, plain samples or packed 14-bit words
// (kPacked14), on an int32 state, or on int16 samples with `int16` (the
// int16 state, kPlain only), against K1, K2, K4 and K2b.
extern "C" int tpg_threshold_staged_launch(
    const void* feed, int feed_stride, int encoding, int groups_per_row,
    int group_outer, int group_inner, int word_stride, int n_chunks,
    int ticks_per_chunk, void* state, int n_channels, void* slots,
    void* nclose, int k_slots, int family, int peak_gated, int charge_floor,
    int track_peaks, int avx, int threshold, int accumulator_limit,
    int rs_scale_factor_x10, const int* taps, int tap_exponent, int adc_max,
    int sigma_cap, int thr_mult, int int16, int fir_packed, int rs_float,
    int slot_word_carry, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess)
    return static_cast<int>(scope.error());
  Params p;
  if (family < kSimpleThreshold || family >= kFIR || fir_packed ||
      slot_word_carry ||
      (encoding != kPlain && encoding != kTime2 && encoding != kPacked14) ||
      (int16 && encoding != kPlain) ||
      !make_params(p, feed, feed_stride, encoding, groups_per_row,
                   group_outer, group_inner, word_stride, n_chunks,
                   ticks_per_chunk, state, n_channels, slots, nclose, k_slots,
                   threshold, accumulator_limit, rs_scale_factor_x10, taps,
                   tap_exponent, adc_max, sigma_cap, thr_mult))
    return static_cast<int>(cudaErrorInvalidValue);
  const Variant v{family, peak_gated != 0, charge_floor != 0,
                  track_peaks != 0, avx != 0, false, rs_float != 0};
  return static_cast<int>(launch_threshold_staged(
      p, v, int16 ? kPlain16 : encoding, static_cast<cudaStream_t>(stream)));
}

// The shared memory one block of tpg_launch's kernel takes for these
// arguments, in bytes, as the launch counts it (tpg.cuh::
// fused_shared_bytes: the pipeline's ring, its carry staging and its
// mbarriers; fir_packed takes K3's), and through `max_bytes` the most a
// launch may take before it is refused.  No launch.
extern "C" long long tpg_shared_bytes(int ticks_per_chunk, int k_slots,
                                      int encoding, int family,
                                      int track_peaks, int carry,
                                      int* max_bytes) {
  Params p{};
  p.ticks_per_chunk = ticks_per_chunk;
  p.k_slots = k_slots;
  if (max_bytes != nullptr) *max_bytes = kMaxSharedBytes;
  const Variant v{family, false, false, track_peaks != 0, false, false,
                  false};
  return fused_shared_bytes(p, v, encoding, carry != 0);
}
