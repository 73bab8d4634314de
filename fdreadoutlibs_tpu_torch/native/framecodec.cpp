// Copied from fdreadoutlibs_tpu/native/framecodec.cpp:1-519.  The port's
// own: the time2 worker stages each 64-tick block from an address rule
// (Time2Source), so wibeth_relayout_time2_frames(_mt) read the ADC
// regions of (L, N, 7200) frames where they lie, with no words copy.
//
// Native frame codec: host-side WIBEth framing at streaming rates.
//
// The ingest path must sustain multi-GB/s host-side framing (SURVEY.md §7
// hard part (d)); numpy's per-channel Python loop tops out well below a
// production link aggregate.  These kernels are written as flat loops over
// 64-channel rows so the compiler auto-vectorizes them; they are the C++
// analogue of the reference's expand_wibeth_adcs (FrameExpand.hpp:192-246)
// in natural channel order.
//
// Layout contract (formats/wibeth.py): frame = 7200 B, 4 x u64 header
// words, ADC rows of 14 u64 words (64 ch x 14 bit, little-endian).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {
constexpr int kFrameBytes = 7200;
constexpr int kHeaderBytes = 32;
constexpr int kRowBytes = 112;  // 64 * 14 / 8
constexpr int kRows = 64;
constexpr int kChannels = 64;
}  // namespace

extern "C" {

// Unpack n_frames WIBEth frames -> out[n_frames*64][64] uint16 ADCs.
void wibeth_unpack(const uint8_t* frames, uint64_t n_frames, uint16_t* out) {
  for (uint64_t f = 0; f < n_frames; ++f) {
    const uint8_t* base = frames + f * kFrameBytes + kHeaderBytes;
    uint16_t* orow = out + f * kRows * kChannels;
    for (int t = 0; t < kRows; ++t) {
      const uint8_t* row = base + t * kRowBytes;
      uint16_t* o = orow + t * kChannels;
      for (int c = 0; c < kChannels; ++c) {
        int bit = c * 14;
        int byte = bit >> 3;
        int sh = bit & 7;
        uint32_t v;
        std::memcpy(&v, row + byte, sizeof(v));  // little-endian
        o[c] = static_cast<uint16_t>((v >> sh) & 0x3FFF);
      }
    }
  }
}

// Pack adcs[n_frames*64][64] uint16 -> frames' ADC regions (headers kept).
void wibeth_pack(uint8_t* frames, uint64_t n_frames, const uint16_t* adcs) {
  for (uint64_t f = 0; f < n_frames; ++f) {
    uint8_t* base = frames + f * kFrameBytes + kHeaderBytes;
    const uint16_t* irow = adcs + f * kRows * kChannels;
    for (int t = 0; t < kRows; ++t) {
      uint8_t* row = base + t * kRowBytes;
      std::memset(row, 0, kRowBytes);
      const uint16_t* in = irow + t * kChannels;
      for (int c = 0; c < kChannels; ++c) {
        int bit = c * 14;
        int byte = bit >> 3;
        int sh = bit & 7;
        uint32_t v;
        std::memcpy(&v, row + byte, sizeof(v));
        v |= (static_cast<uint32_t>(in[c] & 0x3FFF)) << sh;
        std::memcpy(row + byte, &v, sizeof(v));
      }
    }
  }
}

// Extract the 64-bit timestamps (header word 1) of n frames.
void wibeth_timestamps(const uint8_t* frames, uint64_t n_frames,
                       uint64_t* out) {
  for (uint64_t f = 0; f < n_frames; ++f) {
    std::memcpy(&out[f], frames + f * kFrameBytes + 8, sizeof(uint64_t));
  }
}

// Relayout packed ADC words into the words14 feed order consumed by the
// fused in-kernel-unpack TPG kernel (ops/pallas_tpg.py words14_positions):
// in  = (L, T, 28) uint32 link-major packed rows (host_words output),
// out = (T, WR, 7, 128) int32,  WR = ceil(4L / 128).
// 16 channels span exactly 7 words, so group g = 4*link + q (q = word
// quartet within the link row) lands at out[t][g/128][w][g%128] with
// w = word-in-group; dead lanes (g >= 4L) are zeroed.  This is the
// stride-7 gather that costs ~0.35 ms/window on-device for EVERY XLA/jnp
// formulation (BENCH_NOTES r3) moved to the host/NIC stage, where it is
// a cache-resident strided copy — a words14-ordered feed runs the kernel
// at its pre-transposed figure (6.5x vs 4.1-4.9x ingest RTF).
namespace {
// Tick-range worker (see relayout_time2_range for the range contract:
// t_begin 64-aligned, disjoint ranges need no synchronization).
void relayout_words14_range(const uint32_t* in, uint64_t L, uint64_t T,
                            int32_t* out, uint64_t t_begin, uint64_t t_end) {
  const uint64_t G = 4 * L;
  const uint64_t WR = (G + 127) / 128;
  const uint64_t row = WR * 7 * 128;
  const uint64_t B = 64;  // tick block: staging is L*B*112 B, L2-resident
  // source offset (within a staged block, at tb=0) per output position,
  // dead lanes marked; the hot loop is then a branch-free gather from the
  // staging buffer.  Staging per tick-block turns the L strided read
  // streams (one per link; more than the prefetcher tracks at APA scale)
  // into sequential memcpys, measured +11% over gathering from `in`.
  int64_t* off = new int64_t[row];
  for (uint64_t j = 0; j < row; ++j) {
    const uint64_t wr = j / (7 * 128), w = (j / 128) % 7, lane = j % 128;
    const uint64_t g = wr * 128 + lane;
    off[j] = g < G
                 ? static_cast<int64_t>((g / 4) * B * 28 + (g % 4) * 7 + w)
                 : -1;
  }
#if defined(__AVX512F__)
  // per-16-output-block closed form of the same table: within a block
  // (fixed wr, w; 16 consecutive lanes) the 16 sources are
  // base + {(k/4)*B*28 + (k%4)*7}, so ONE masked hardware gather with a
  // static index vector replaces 16 scalar loads + a staging roundtrip
  // (dead lanes gather nothing and emit 0 via the mask default).
  const uint64_t nblk = row / 16;
  int32_t* bbase = new int32_t[nblk];
  uint16_t* bmask = new uint16_t[nblk];
  for (uint64_t jb = 0; jb < nblk; ++jb) {
    const uint64_t wr = jb / (7 * 8), w = (jb / 8) % 7;
    const uint64_t g0 = wr * 128 + (jb % 8) * 16;
    // fully-dead blocks (mask 0) keep base 0 so the gather pointer never
    // points past the staging buffer
    bbase[jb] = g0 < G ? static_cast<int32_t>((g0 / 4) * B * 28 + w) : 0;
    uint16_t m = 0;
    for (int k = 0; k < 16; ++k) m |= (g0 + k < G) ? (1u << k) : 0;
    bmask[jb] = m;
  }
  alignas(64) int32_t gidx[16];
  for (int k = 0; k < 16; ++k) gidx[k] = (k / 4) * B * 28 + (k % 4) * 7;
#endif
  uint32_t* stage = new uint32_t[L * B * 28];
  for (uint64_t t0 = t_begin; t0 < t_end; t0 += B) {
    const uint64_t nb = (t0 + B <= t_end) ? B : (t_end - t0);
    for (uint64_t l = 0; l < L; ++l) {
      std::memcpy(stage + l * B * 28, in + (l * T + t0) * 28,
                  nb * 28 * sizeof(uint32_t));
    }
#if defined(__AVX512F__)
    // the (T, WR, 7, 128) output is ~59 MB/APA-window, written once and
    // next touched by the device DMA: non-temporal stores skip its
    // write-allocate read (the loop is memory-bound — BENCH_NOTES r3
    // host codec).  row = WR*7*128 is a multiple of 16 and row*4 of 64,
    // so every 64-byte store is aligned iff the output base is.
    const bool nt = (reinterpret_cast<uintptr_t>(out) & 63) == 0;
#endif
    for (uint64_t tb = 0; tb < nb; ++tb) {
      const uint32_t* irow = stage + tb * 28;
      int32_t* orow = out + (t0 + tb) * row;
#if defined(__AVX512F__)
      if (nt) {
        const __m512i vidx = _mm512_load_si512(gidx);
        const __m512i zero = _mm512_setzero_si512();
        for (uint64_t jb = 0; jb < nblk; ++jb) {
          const __m512i v = _mm512_mask_i32gather_epi32(
              zero, bmask[jb], vidx, irow + bbase[jb], 4);
          _mm512_stream_si512(reinterpret_cast<__m512i*>(orow + jb * 16),
                              v);
        }
        continue;
      }
#endif
      for (uint64_t j = 0; j < row; ++j) {
        orow[j] = off[j] >= 0 ? static_cast<int32_t>(irow[off[j]]) : 0;
      }
    }
  }
  delete[] stage;
  delete[] off;
#if defined(__AVX512F__)
  delete[] bbase;
  delete[] bmask;
  _mm_sfence();  // drain the streaming stores before the caller reads
#endif
}
}  // namespace

void wibeth_relayout_words14(const uint32_t* in, uint64_t L, uint64_t T,
                             int32_t* out) {
  relayout_words14_range(in, L, T, out, 0, T);
}

// Multithreaded variant; see relayout_time2_run.
void wibeth_relayout_words14_mt(const uint32_t* in, uint64_t L, uint64_t T,
                                int32_t* out, uint64_t nthreads) {
  const uint64_t blocks = (T + 63) / 64;
  if (nthreads > blocks) nthreads = blocks;
  if (nthreads <= 1) {
    relayout_words14_range(in, L, T, out, 0, T);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(nthreads);
  const uint64_t per = (blocks + nthreads - 1) / nthreads;
  for (uint64_t i = 0; i < nthreads; ++i) {
    const uint64_t t0 = i * per * 64;
    const uint64_t t1 = (i + 1) * per * 64 < T ? (i + 1) * per * 64 : T;
    if (t0 >= t1) break;
    workers.emplace_back(relayout_words14_range, in, L, T, out, t0, t1);
  }
  for (auto& w : workers) w.join();
}

namespace {
// Unpack one 7-word quartet (16 channels x 14 bit, lcm(14,32)=224 bits)
// with compile-time-constant shifts; the constant-shift ladder
// auto-vectorizes.  Bit positions: channel r occupies bits [14r, 14r+14)
// of the 224-bit group (formats/bitpack.py).
inline void unpack16_scalar(const uint32_t* w, uint32_t* o) {
  o[0] = w[0] & 0x3FFF;
  o[1] = (w[0] >> 14) & 0x3FFF;
  o[2] = ((w[0] >> 28) | (w[1] << 4)) & 0x3FFF;
  o[3] = (w[1] >> 10) & 0x3FFF;
  o[4] = ((w[1] >> 24) | (w[2] << 8)) & 0x3FFF;
  o[5] = (w[2] >> 6) & 0x3FFF;
  o[6] = ((w[2] >> 20) | (w[3] << 12)) & 0x3FFF;
  o[7] = (w[3] >> 2) & 0x3FFF;
  o[8] = (w[3] >> 16) & 0x3FFF;
  o[9] = ((w[3] >> 30) | (w[4] << 2)) & 0x3FFF;
  o[10] = (w[4] >> 12) & 0x3FFF;
  o[11] = ((w[4] >> 26) | (w[5] << 6)) & 0x3FFF;
  o[12] = (w[5] >> 8) & 0x3FFF;
  o[13] = ((w[5] >> 22) | (w[6] << 10)) & 0x3FFF;
  o[14] = (w[6] >> 4) & 0x3FFF;
  o[15] = (w[6] >> 18) & 0x3FFF;
}

#if defined(__AVX512F__)
// Explicit-SIMD quartet unpack: all 16 channels in ONE 512-bit vector.
// The uniform formulation of the scalar ladder is
//   o[k] = ((w[wi] >> s) | (w[wi+1] << (32 - s))) & 0x3FFF,
// where wi = 14k/32, s = 14k%32: the carry term contributes only when the
// value actually crosses a word boundary (32-s <= 13); otherwise its bits
// land above the mask, and s = 0 maps to a shift count of 32, which
// _mm512_sllv_epi32 defines as 0.  One 8-word load + two permutexvar
// gathers + two variable shifts replaces 16 scalar chains (~45 ops); the
// measured relayout_time2 throughput gain is recorded in BENCH_NOTES.
// CONTRACT: reads 8 words (one PAST the 7-word group) — callers must
// guarantee the extra word is readable (padded staging buffers below).
alignas(64) constexpr uint32_t kWordIdx[16] = {0, 0, 0, 1, 1, 2, 2, 3,
                                               3, 3, 4, 4, 5, 5, 6, 6};
alignas(64) constexpr uint32_t kShift[16] = {0, 14, 28, 10, 24, 6, 20, 2,
                                             16, 30, 12, 26, 8, 22, 4, 18};
alignas(64) constexpr uint32_t kCarry[16] = {32, 18, 4, 22, 8, 26, 12, 30,
                                             16, 2, 20, 6, 24, 10, 28, 14};

inline __m512i unpack16_v(const uint32_t* w) {
  // upper half explicitly zeroed (the permute indices only touch lanes
  // 0..7; insert-into-zero is the one spelling GCC 12 compiles without a
  // maybe-uninitialized warning — cast/zext both warn)
  const __m512i W = _mm512_inserti64x4(
      _mm512_setzero_si512(),
      _mm256_loadu_si256(reinterpret_cast<const __m256i*>(w)), 0);
  const __m512i wi = _mm512_load_si512(kWordIdx);
  const __m512i lo = _mm512_srlv_epi32(_mm512_permutexvar_epi32(wi, W),
                                       _mm512_load_si512(kShift));
  const __m512i hi = _mm512_sllv_epi32(
      _mm512_permutexvar_epi32(_mm512_add_epi32(wi, _mm512_set1_epi32(1)), W),
      _mm512_load_si512(kCarry));
  return _mm512_and_si512(_mm512_or_si512(lo, hi), _mm512_set1_epi32(0x3FFF));
}

inline void unpack16(const uint32_t* w, uint32_t* o) {
  _mm512_storeu_si512(o, unpack16_v(w));
}

// Paired variant: extract the same 16 channels from two consecutive tick
// rows and emit adc(t0) | adc(t1) << 16 directly (the time2 relayout hot
// loop).
inline void unpack16_pair(const uint32_t* a, const uint32_t* b, int32_t* o) {
  _mm512_storeu_si512(
      o, _mm512_or_si512(unpack16_v(a), _mm512_slli_epi32(unpack16_v(b), 16)));
}

// Non-temporal variant: the (T/2, S, 128) output is ~50 MB/APA-window and
// is next touched by the device DMA, never re-read by the host — a
// streaming store skips the write-allocate read of every output line,
// cutting DRAM traffic ~37% (the codec is memory-bound on one core:
// memcpy ceiling ~10 GB/s; measured 2.1x over regular stores at equal
// SIMD arithmetic, 3.9x total vs the scalar ladder — BENCH_NOTES r3).
// Requires o 64-byte aligned; caller fences once at the end.
inline void unpack16_pair_nt(const uint32_t* a, const uint32_t* b,
                             int32_t* o) {
  _mm512_stream_si512(
      reinterpret_cast<__m512i*>(o),
      _mm512_or_si512(unpack16_v(a), _mm512_slli_epi32(unpack16_v(b), 16)));
}
#else
inline void unpack16(const uint32_t* w, uint32_t* o) {
  unpack16_scalar(w, o);
}

inline void unpack16_pair(const uint32_t* a, const uint32_t* b, int32_t* o) {
  uint32_t va[16], vb[16];
  unpack16_scalar(a, va);
  unpack16_scalar(b, vb);
  for (int k = 0; k < 16; ++k) {
    o[k] = static_cast<int32_t>(va[k] | (vb[k] << 16));
  }
}
#endif
}  // namespace

// Host-side 14-bit unpack + time-pairing into the kernel's time_packed
// canonical layout (ops/pallas_tpg.py pack_adcs_time2):
// in  = (L, T, 28) uint32 link-major packed rows (host_words output),
// out = (T/2, S, 128) int32, channel c = 64*link + ch at flat lane index
// c, value = adc(2t) | adc(2t+1) << 16; dead positions (c >= 64L) zeroed.
// T must be even (WIBEth frames carry 64 ticks).  Unlike words14 this is
// not a pure byte permutation — the host pays the unpack ALU — but the
// device then runs the plain int32 kernel datapath at ~half the HBM
// traffic (time_packed measured ~15% over kernel-only vs ~2x for the
// in-kernel words14 unpack; BENCH_NOTES).
void relayout_time2_chmajor(const uint32_t* in, uint64_t L, uint64_t T,
                            uint64_t cpl, uint64_t S, int32_t* out);

void wibeth_relayout_time2(const uint32_t* in, uint64_t L, uint64_t T,
                           uint64_t S, int32_t* out) {
  relayout_time2_chmajor(in, L, T, 64, S, out);
}

namespace {
// Where the time2 worker stages from: block k (ticks [64k, 64k + 64)) of
// link l is nb*nw contiguous words at base + l*link_stride +
// k*block_stride bytes.  Packed (L, T, nw) words: link_stride T*nw*4,
// block_stride 64*nw*4.  WIBEth frames: base at the first frame's ADC
// region (byte 32), a frame's 64 ticks x 28 words being one block, so
// block_stride is the frame stride.  Signed strides: any numpy view.
struct Time2Source {
  const uint8_t* base;
  int64_t link_stride;
  int64_t block_stride;
};

Time2Source words_source(const uint32_t* in, uint64_t T, uint64_t nw) {
  return {reinterpret_cast<const uint8_t*>(in),
          static_cast<int64_t>(T * nw * sizeof(uint32_t)),
          static_cast<int64_t>(64 * nw * sizeof(uint32_t))};
}

// Tick-range worker for the channel-major time2 relayout: processes
// absolute ticks [t_begin, t_end) of the source into the full (T/2, S,
// 128) output.  t_begin must be a multiple of the 64-tick staging block
// so pairing and block staging stay aligned; ranges are disjoint in both
// input reads and output rows, so threads need no synchronization
// beyond join.
void relayout_time2_range(Time2Source src, uint64_t L, uint64_t cpl,
                          uint64_t S, int32_t* out, uint64_t t_begin,
                          uint64_t t_end) {
  const uint64_t row = S * 128;
  const uint64_t C = cpl * L;
  const uint64_t nw = cpl * 7 / 16;  // words per tick row
  const uint64_t nq = cpl / 16;      // quartets per tick row
  const uint64_t B = 64;  // tick block: staging is L2-resident
  // +1 word: the SIMD unpack reads one word past the final 7-word group
  // (zero-initialized so sanitizers don't flag the masked-away read)
  uint32_t* stage = new uint32_t[L * B * nw + 1];
  stage[L * B * nw] = 0;
  for (uint64_t t0 = t_begin; t0 < t_end; t0 += B) {
    const uint64_t nb = (t0 + B <= t_end) ? B : (t_end - t0);
    const uint8_t* block =
        src.base + static_cast<int64_t>(t0 / B) * src.block_stride;
    for (uint64_t l = 0; l < L; ++l) {
      std::memcpy(stage + l * B * nw,
                  block + static_cast<int64_t>(l) * src.link_stride,
                  nb * nw * sizeof(uint32_t));
    }
#if defined(__AVX512F__)
    // every store in this loop is 64-byte aligned iff the output base is
    // (row*4 and cpl*4 are multiples of 64): use non-temporal stores then
    const bool nt = (reinterpret_cast<uintptr_t>(out) & 63) == 0;
#endif
    for (uint64_t tb = 0; tb + 1 < nb; tb += 2) {  // nb even (T even)
      int32_t* orow = out + ((t0 + tb) / 2) * row;
#if defined(__AVX512F__)
      if (nt) {
        const __m512i z = _mm512_setzero_si512();
        for (uint64_t j = C; j < row; j += 16) {
          _mm512_stream_si512(reinterpret_cast<__m512i*>(orow + j), z);
        }
      } else
#endif
        std::memset(orow + C, 0, (row - C) * sizeof(int32_t));
      for (uint64_t l = 0; l < L; ++l) {
        const uint32_t* r0 = stage + (l * B + tb) * nw;
        const uint32_t* r1 = r0 + nw;
        int32_t* o = orow + l * cpl;
#if defined(__AVX512F__)
        if (nt) {
          for (uint64_t q = 0; q < nq; ++q) {
            unpack16_pair_nt(r0 + q * 7, r1 + q * 7, o + q * 16);
          }
          continue;
        }
#endif
        for (uint64_t q = 0; q < nq; ++q) {
          unpack16_pair(r0 + q * 7, r1 + q * 7, o + q * 16);
        }
      }
    }
  }
  delete[] stage;
#if defined(__AVX512F__)
  _mm_sfence();  // drain the streaming stores before the caller reads
#endif
}

// The time2 relayout of T ticks from src: ticks are split into
// 64-aligned contiguous ranges, one std::thread each — ranges are
// disjoint in input reads and output rows, so the only synchronization
// is the join.  nthreads <= 1 runs inline.
void relayout_time2_run(Time2Source src, uint64_t L, uint64_t T,
                        uint64_t cpl, uint64_t S, int32_t* out,
                        uint64_t nthreads) {
  const uint64_t blocks = (T + 63) / 64;
  if (nthreads > blocks) nthreads = blocks;
  if (nthreads <= 1) {
    relayout_time2_range(src, L, cpl, S, out, 0, T);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(nthreads);
  const uint64_t per = (blocks + nthreads - 1) / nthreads;
  for (uint64_t i = 0; i < nthreads; ++i) {
    const uint64_t t0 = i * per * 64;
    const uint64_t t1 = (i + 1) * per * 64 < T ? (i + 1) * per * 64 : T;
    if (t0 >= t1) break;
    workers.emplace_back(relayout_time2_range, src, L, cpl, S, out, t0, t1);
  }
  for (auto& w : workers) w.join();
}
}  // namespace

// Generic channel-major variant: each tick row of link l is cpl
// channels x 14 bit = cpl*7/16 uint32 words in channel order (WIBEth
// cpl=64, WIB2 cpl=256); channel c = cpl*link + ch.
void relayout_time2_chmajor(const uint32_t* in, uint64_t L, uint64_t T,
                            uint64_t cpl, uint64_t S, int32_t* out) {
  relayout_time2_run(words_source(in, T, cpl * 7 / 16), L, T, cpl, S, out,
                     1);
}

// Multithreaded variant for production hosts (an APA's 8.75 GB/s raw
// rate needs ~2 cores at the measured 6.3 GB/s/core).
void relayout_time2_chmajor_mt(const uint32_t* in, uint64_t L, uint64_t T,
                               uint64_t cpl, uint64_t S, int32_t* out,
                               uint64_t nthreads) {
  relayout_time2_run(words_source(in, T, cpl * 7 / 16), L, T, cpl, S, out,
                     nthreads);
}

// WIBEth time2 relayout straight from the frames: (L, N, 7200) bytes with
// link_stride and frame_stride bytes between links and frames (the last
// axis contiguous) -> the (N*32, S, 128) output of wibeth_relayout_time2
// on the frames' packed words.  A frame's ADC region (byte 32 on, 64
// ticks x 28 words) is one staging block, so each block is one memcpy
// from the frame where it lies.
void wibeth_relayout_time2_frames(const uint8_t* frames, uint64_t L,
                                  uint64_t N, int64_t link_stride,
                                  int64_t frame_stride, uint64_t S,
                                  int32_t* out) {
  relayout_time2_run({frames + kHeaderBytes, link_stride, frame_stride}, L,
                     N * kRows, kChannels, S, out, 1);
}

void wibeth_relayout_time2_frames_mt(const uint8_t* frames, uint64_t L,
                                     uint64_t N, int64_t link_stride,
                                     int64_t frame_stride, uint64_t S,
                                     int32_t* out, uint64_t nthreads) {
  relayout_time2_run({frames + kHeaderBytes, link_stride, frame_stride}, L,
                     N * kRows, kChannels, S, out, nthreads);
}

// DAPHNE stream variant: each frame row of link l is 64 ticks x 4
// channels x 14 bit = 112 uint32 words in TIME-major value order
// (value index = 4*t + ch); channel c = 4*link + ch.
// in = (L, N, 112) uint32, out = (N*32, S, 128) int32 (64 ticks/frame).
void daphne_relayout_time2(const uint32_t* in, uint64_t L, uint64_t N,
                           uint64_t S, int32_t* out) {
  const uint64_t row = S * 128;
  const uint64_t C = 4 * L;
  uint32_t v[256];
  uint32_t fr[113];  // +1 word: SIMD unpack over-reads the last group
  fr[112] = 0;       // (zeroed so sanitizers don't flag the masked read)
  for (uint64_t n = 0; n < N; ++n) {
    for (uint64_t l = 0; l < L; ++l) {
      const uint32_t* f = in + (l * N + n) * 112;
      std::memcpy(fr, f, 112 * sizeof(uint32_t));
      for (int q = 0; q < 16; ++q) unpack16(fr + q * 7, v + q * 16);
      for (uint64_t t2 = 0; t2 < 32; ++t2) {
        int32_t* orow = out + (n * 32 + t2) * row;
        if (l == 0) std::memset(orow + C, 0, (row - C) * sizeof(int32_t));
        int32_t* o = orow + l * 4;
        const uint32_t* a = v + 8 * t2;      // tick 2*t2 (4 values)
        const uint32_t* b = a + 4;           // tick 2*t2 + 1
        for (int k = 0; k < 4; ++k) {
          o[k] = static_cast<int32_t>(a[k] | (b[k] << 16));
        }
      }
    }
  }
}

// ProtoWIB plane-subset time2 feed: frames (T, 464 B) -> (T/2, S, 128)
// int32 canonical time-paired feed over a caller-supplied in-frame
// channel list (the COLLECTION/INDUCTION register tables live in python
// as data; formats/protowib.py).  The 12-bit nibble codec reads, per
// channel, (lo_byte, nibble_byte) for even in-pair position or
// (nibble_byte, hi_byte) for odd — the byte offsets mirror
// formats/protowib.py get_adcs/_channel_byte_offsets.  Scalar: a
// ProtoWIB link is ~0.93 GB/s raw, far below the codec's ceiling.
void protowib_relayout_time2(const uint8_t* frames, uint64_t T,
                             const uint16_t* chan_list, uint64_t C,
                             uint64_t S, int32_t* out) {
  struct Off {
    uint16_t lo, mid, hi;
    uint8_t pos;
  };
  Off offs[256];
  for (int c = 0; c < 256; ++c) {
    const int block = c / 64, r1 = c % 64;
    const int segment = r1 / 8, r2 = r1 % 8;
    const int adc = r2 / 4, ch = r2 % 4;
    const int grp = ch / 2, pos = ch % 2;
    const int base = 16 + block * 112 + 16 + segment * 12 + grp * 6 + adc;
    offs[c] = {static_cast<uint16_t>(base), static_cast<uint16_t>(base + 2),
               static_cast<uint16_t>(base + 4), static_cast<uint8_t>(pos)};
  }
  const uint64_t row = S * 128;
  for (uint64_t t = 0; t + 1 < T; t += 2) {
    const uint8_t* f0 = frames + t * 464;
    const uint8_t* f1 = f0 + 464;
    int32_t* orow = out + (t / 2) * row;
    std::memset(orow + C, 0, (row - C) * sizeof(int32_t));
    for (uint64_t j = 0; j < C; ++j) {
      const Off& o = offs[chan_list[j]];
      uint32_t v0, v1;
      if (o.pos == 0) {
        v0 = f0[o.lo] | (static_cast<uint32_t>(f0[o.mid] & 0x0F) << 8);
        v1 = f1[o.lo] | (static_cast<uint32_t>(f1[o.mid] & 0x0F) << 8);
      } else {
        v0 = (f0[o.mid] >> 4) | (static_cast<uint32_t>(f0[o.hi]) << 4);
        v1 = (f1[o.mid] >> 4) | (static_cast<uint32_t>(f1[o.hi]) << 4);
      }
      orow[j] = static_cast<int32_t>(v0 | (v1 << 16));
    }
  }
}

// Set perfectly incrementing timestamps + sequence ids (emulator repair).
void wibeth_fake_headers(uint8_t* frames, uint64_t n_frames, uint64_t first_ts,
                         uint64_t tick, uint64_t first_seq) {
  for (uint64_t f = 0; f < n_frames; ++f) {
    uint8_t* hdr = frames + f * kFrameBytes;
    uint64_t ts = first_ts + f * tick;
    std::memcpy(hdr + 8, &ts, sizeof(ts));
    uint64_t w0;
    std::memcpy(&w0, hdr, sizeof(w0));
    uint64_t seq = (first_seq + f) & 0xFFFULL;
    w0 = (w0 & ~(0xFFFULL << 40)) | (seq << 40);
    std::memcpy(hdr, &w0, sizeof(w0));
  }
}

}  // extern "C"
