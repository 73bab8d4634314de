// Copied from fdreadoutlibs_tpu/native/latency_buffer.cpp:1-196; the code is unchanged.
//
// Native timestamp-ordered latency buffer.
//
// C++ replacement for the folly ConcurrentSkipList the reference uses via
// readoutlibs::SkipListLatencyBufferModel (SURVEY.md §2.6 item 2): ordered
// insertion of fixed-size records keyed by a uint64 timestamp at byte
// offset 0, head/tail queries, non-consuming windowed extraction
// (get_fragment_pieces), front cleanup (pop_until / max-ts-diff trim).
//
// Implementation: an ordered std::multimap<key, record-offset> over an
// append-only byte arena, guarded by a mutex.  Insertions arrive in large
// batches (the TPU-native arrival pattern), so per-batch locking costs are
// amortized; record payloads are copied once into the arena and once out on
// extraction.  Arena space of popped records is reclaimed on compaction.
//
// C ABI for ctypes; all functions are thread-safe per buffer.

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

namespace {

struct Buffer {
  std::mutex mu;
  size_t record_size = 0;
  size_t capacity = 0;  // 0 = unbounded, in records
  std::vector<uint8_t> arena;
  std::vector<size_t> free_slots;
  std::multimap<uint64_t, size_t> index;  // key -> arena offset

  uint64_t key_at(size_t off) const {
    uint64_t k;
    std::memcpy(&k, arena.data() + off, sizeof(k));
    return k;
  }

  size_t alloc_slot() {
    if (!free_slots.empty()) {
      size_t off = free_slots.back();
      free_slots.pop_back();
      return off;
    }
    size_t off = arena.size();
    arena.resize(off + record_size);
    return off;
  }
};

}  // namespace

extern "C" {

void* lb_create(uint64_t record_size, uint64_t capacity) {
  Buffer* b = new Buffer();
  b->record_size = static_cast<size_t>(record_size);
  b->capacity = static_cast<size_t>(capacity);
  return b;
}

void lb_destroy(void* h) { delete static_cast<Buffer*>(h); }

// Insert n records (concatenated blobs, key = first 8 bytes of each).
// Returns the number accepted (capacity-limited).
uint64_t lb_insert(void* h, const uint8_t* records, uint64_t n) {
  Buffer* b = static_cast<Buffer*>(h);
  std::lock_guard<std::mutex> lock(b->mu);
  uint64_t accepted = 0;
  for (uint64_t i = 0; i < n; ++i) {
    if (b->capacity && b->index.size() >= b->capacity) break;
    const uint8_t* rec = records + i * b->record_size;
    uint64_t key;
    std::memcpy(&key, rec, sizeof(key));
    size_t off = b->alloc_slot();
    std::memcpy(b->arena.data() + off, rec, b->record_size);
    b->index.emplace(key, off);
    ++accepted;
  }
  return accepted;
}

uint64_t lb_occupancy(void* h) {
  Buffer* b = static_cast<Buffer*>(h);
  std::lock_guard<std::mutex> lock(b->mu);
  return b->index.size();
}

// Returns 0 if empty, else 1 and writes the oldest/newest keys.
int lb_bounds(void* h, uint64_t* oldest, uint64_t* newest) {
  Buffer* b = static_cast<Buffer*>(h);
  std::lock_guard<std::mutex> lock(b->mu);
  if (b->index.empty()) return 0;
  *oldest = b->index.begin()->first;
  *newest = b->index.rbegin()->first;
  return 1;
}

// Count records with start <= key < end.
uint64_t lb_count_window(void* h, uint64_t start, uint64_t end) {
  Buffer* b = static_cast<Buffer*>(h);
  std::lock_guard<std::mutex> lock(b->mu);
  auto lo = b->index.lower_bound(start);
  auto hi = b->index.lower_bound(end);
  return static_cast<uint64_t>(std::distance(lo, hi));
}

// Copy up to max_n records with start <= key < end into out (ordered,
// non-consuming).  Returns the number copied.
uint64_t lb_extract_window(void* h, uint64_t start, uint64_t end,
                           uint8_t* out, uint64_t max_n) {
  Buffer* b = static_cast<Buffer*>(h);
  std::lock_guard<std::mutex> lock(b->mu);
  uint64_t n = 0;
  for (auto it = b->index.lower_bound(start);
       it != b->index.end() && it->first < end && n < max_n; ++it, ++n) {
    std::memcpy(out + n * b->record_size, b->arena.data() + it->second,
                b->record_size);
  }
  return n;
}

// Copy ALL records in key order into out (up to max_n, non-consuming).
// Distinct from lb_extract_window because the window's half-open
// [start, end) bound cannot express "everything including key
// UINT64_MAX" — a snapshot built on a window silently dropped
// top-bit-set timestamps (found by scripts/fuzz_tp_path.py).
uint64_t lb_extract_all(void* h, uint8_t* out, uint64_t max_n) {
  Buffer* b = static_cast<Buffer*>(h);
  std::lock_guard<std::mutex> lock(b->mu);
  uint64_t n = 0;
  for (auto it = b->index.begin(); it != b->index.end() && n < max_n;
       ++it, ++n) {
    std::memcpy(out + n * b->record_size, b->arena.data() + it->second,
                b->record_size);
  }
  return n;
}

// Drop records with key < ts; returns the number dropped.
uint64_t lb_pop_until(void* h, uint64_t ts) {
  Buffer* b = static_cast<Buffer*>(h);
  std::lock_guard<std::mutex> lock(b->mu);
  uint64_t dropped = 0;
  auto it = b->index.begin();
  while (it != b->index.end() && it->first < ts) {
    b->free_slots.push_back(it->second);
    it = b->index.erase(it);
    ++dropped;
  }
  return dropped;
}

// Drop the n oldest records; returns the number dropped.  Exact-count
// trimming (occupancy caps) — duplicate keys make pop_until inexact.
uint64_t lb_pop_n(void* h, uint64_t n) {
  Buffer* b = static_cast<Buffer*>(h);
  std::lock_guard<std::mutex> lock(b->mu);
  uint64_t dropped = 0;
  auto it = b->index.begin();
  while (it != b->index.end() && dropped < n) {
    b->free_slots.push_back(it->second);
    it = b->index.erase(it);
    ++dropped;
  }
  return dropped;
}

// Key of the idx-th oldest record (0 if out of range, rc 0).  O(idx) walk,
// NO record copies — the occupancy-trim path reads one key instead of
// snapshotting the whole buffer.
int lb_key_at(void* h, uint64_t idx, uint64_t* key) {
  Buffer* b = static_cast<Buffer*>(h);
  std::lock_guard<std::mutex> lock(b->mu);
  if (idx >= b->index.size()) return 0;
  auto it = b->index.begin();
  std::advance(it, static_cast<ptrdiff_t>(idx));
  *key = it->first;
  return 1;
}

// DAPHNEListRequestHandler-style trim: pop oldest until newest - oldest
// <= max_diff (DAPHNEListRequestHandler.cpp:37-50).
uint64_t lb_cleanup_max_ts_diff(void* h, uint64_t max_diff) {
  Buffer* b = static_cast<Buffer*>(h);
  uint64_t newest;
  {
    std::lock_guard<std::mutex> lock(b->mu);
    if (b->index.empty()) return 0;
    newest = b->index.rbegin()->first;
  }
  uint64_t cutoff = newest > max_diff ? newest - max_diff : 0;
  return lb_pop_until(h, cutoff);
}

}  // extern "C"
