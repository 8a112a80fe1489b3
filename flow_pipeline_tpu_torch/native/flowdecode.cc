// The port's native host code: the frame codec (length-prefixed
// FlowMessage protobuf frames <-> struct-of-arrays columns, in one pass
// each way) and the hash-group kernel of the host-grouped pipeline.
//
// A copy of the decode, encode, frame-count and hash-group parts of the
// JAX package's native/flowdecode.cc (same field map, same varint and
// address rules, same emit order, same grouping hash and order). Host
// code, built with g++ at first use by
// flow_pipeline_tpu_torch/native/__init__.py into one library with
// hostsketch.cc (the sketch engine) and flowfused.cc (the fused pass).
//
// C ABI (ctypes):
//   fpt_count_frames(data, len)               -> frames, or -(errpos+1)
//   fpt_decode_stream(data, len, cols, cap)   -> rows, or -(frame+1)
//   fpt_encode_stream(cols, n, out, cap)      -> bytes written, or -1
//   fpt_hash_group(lanes, n, w, perm, starts, collided, stats)
//                                             -> groups, or -1
//   fpt_hash_group_mt(lanes, n, w, perm, starts, collided, threads, stats)
//                                             -> groups, or -1
//
// ``stats`` is the nullable phase-counter buffer of ffstat.h (the fused
// pass, flowfused.cc, passes it through; the Python binding passes NULL).
//
// Column pointer layout (schema/batch.py COLUMNS order and widths, then
// ADDR_COLUMNS): 24 scalar columns, then 3 address columns of [N, 4]
// uint32 words (big-endian word order, addresses right-aligned to 16
// bytes). The buffers are zeroed by the caller, so absent fields stay 0.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

#include "ffstat.h"  // phase-counter slots and ff_now_ns

namespace {

enum ScalarCol {
  COL_TYPE = 0,
  COL_TIME_RECEIVED,
  COL_SAMPLING_RATE,
  COL_SEQUENCE_NUM,
  COL_TIME_FLOW_START,
  COL_TIME_FLOW_END,
  COL_BYTES,
  COL_PACKETS,
  COL_SRC_AS,
  COL_DST_AS,
  COL_IN_IF,
  COL_OUT_IF,
  COL_PROTO,
  COL_SRC_PORT,
  COL_DST_PORT,
  COL_IP_TOS,
  COL_FORWARDING_STATUS,
  COL_IP_TTL,
  COL_TCP_FLAGS,
  COL_ETYPE,
  COL_ICMP_TYPE,
  COL_ICMP_CODE,
  COL_IPV6_FLOW_LABEL,
  COL_FLOW_DIRECTION,
  N_SCALAR_COLS
};

// bytes per element of each scalar column (uint64 wire fields keep 8)
constexpr int kColWidth[N_SCALAR_COLS] = {
    4, 8, 8, 4, 8, 8, 8, 8, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
};

enum AddrCol { ADDR_SRC = 0, ADDR_DST, ADDR_SAMPLER, N_ADDR_COLS };

// proto field number -> scalar column (-1: not a scalar field)
int scalar_col_for_field(uint32_t field) {
  switch (field) {
    case 1: return COL_TYPE;
    case 2: return COL_TIME_RECEIVED;
    case 3: return COL_SAMPLING_RATE;
    case 4: return COL_SEQUENCE_NUM;
    case 5: return COL_TIME_FLOW_END;
    case 9: return COL_BYTES;
    case 10: return COL_PACKETS;
    case 14: return COL_SRC_AS;
    case 15: return COL_DST_AS;
    case 18: return COL_IN_IF;
    case 19: return COL_OUT_IF;
    case 20: return COL_PROTO;
    case 21: return COL_SRC_PORT;
    case 22: return COL_DST_PORT;
    case 23: return COL_IP_TOS;
    case 24: return COL_FORWARDING_STATUS;
    case 25: return COL_IP_TTL;
    case 26: return COL_TCP_FLAGS;
    case 30: return COL_ETYPE;
    case 31: return COL_ICMP_TYPE;
    case 32: return COL_ICMP_CODE;
    case 37: return COL_IPV6_FLOW_LABEL;
    case 38: return COL_TIME_FLOW_START;
    case 42: return COL_FLOW_DIRECTION;
    default: return -1;
  }
}

int addr_col_for_field(uint32_t field) {
  switch (field) {
    case 6: return ADDR_SRC;
    case 7: return ADDR_DST;
    case 11: return ADDR_SAMPLER;
    default: return -1;
  }
}

// Parse a varint; false on truncation or more than 10 bytes. Values keep
// their low 64 bits, as canonical parsers (and schema/wire.py) do.
inline bool get_varint(const uint8_t* data, int64_t len, int64_t* pos,
                       uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len) {
    uint8_t b = data[*pos];
    ++*pos;
    if (shift < 64) result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

// A 16-byte (right-aligned) address as 4 big-endian uint32 words; longer
// input keeps its trailing 16 bytes, as schema/batch.py addr_to_words does.
inline void put_addr(uint32_t* dst, const uint8_t* src, int64_t n) {
  uint8_t padded[16] = {0};
  if (n > 16) {
    src += n - 16;
    n = 16;
  }
  std::memcpy(padded + (16 - n), src, static_cast<size_t>(n));
  for (int w = 0; w < 4; ++w) {
    dst[w] = (static_cast<uint32_t>(padded[4 * w]) << 24) |
             (static_cast<uint32_t>(padded[4 * w + 1]) << 16) |
             (static_cast<uint32_t>(padded[4 * w + 2]) << 8) |
             static_cast<uint32_t>(padded[4 * w + 3]);
  }
}

inline void store_scalar(void* col, int width, int64_t row, uint64_t value) {
  if (width == 8) {
    static_cast<uint64_t*>(col)[row] = value;
  } else {
    static_cast<uint32_t*>(col)[row] =
        static_cast<uint32_t>(value & 0xFFFFFFFFu);
  }
}

// One message body into row `row`. Unknown fields are skipped; a field
// whose wire type does not match its schema kind is skipped too.
bool decode_body(const uint8_t* data, int64_t len, void** cols, int64_t row) {
  int64_t pos = 0;
  uint32_t* addr_base[N_ADDR_COLS];
  for (int a = 0; a < N_ADDR_COLS; ++a) {
    addr_base[a] = static_cast<uint32_t*>(cols[N_SCALAR_COLS + a]) + 4 * row;
  }
  while (pos < len) {
    uint64_t tag;
    if (!get_varint(data, len, &pos, &tag)) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wt = static_cast<uint32_t>(tag & 0x7);
    if (wt == 0) {
      uint64_t value;
      if (!get_varint(data, len, &pos, &value)) return false;
      int col = scalar_col_for_field(field);
      if (col >= 0) store_scalar(cols[col], kColWidth[col], row, value);
    } else if (wt == 2) {
      uint64_t blen;
      if (!get_varint(data, len, &pos, &blen)) return false;
      // compared as uint64: a huge length must not wrap the int64 cast
      if (blen > static_cast<uint64_t>(len - pos)) return false;
      int acol = addr_col_for_field(field);
      if (acol >= 0) {
        put_addr(addr_base[acol], data + pos, static_cast<int64_t>(blen));
      }
      pos += static_cast<int64_t>(blen);
    } else if (wt == 5) {
      if (pos + 4 > len) return false;
      pos += 4;
    } else if (wt == 1) {
      if (pos + 8 > len) return false;
      pos += 8;
    } else {
      return false;
    }
  }
  return true;
}

// ---- encode (the bulk frame encoder) ---------------------------------------

// Append a varint; *ok turns false when it would pass `cap`.
inline void put_varint(uint8_t* out, int64_t cap, int64_t* pos, uint64_t v,
                       bool* ok) {
  while (true) {
    if (*pos >= cap) {
      *ok = false;
      return;
    }
    uint8_t b = v & 0x7F;
    v >>= 7;
    out[(*pos)++] = v ? (b | 0x80) : b;
    if (!v) return;
  }
}

inline uint64_t load_scalar(void** cols, int col, int64_t row) {
  return kColWidth[col] == 8
             ? static_cast<uint64_t*>(cols[col])[row]
             : static_cast<uint64_t>(static_cast<uint32_t*>(cols[col])[row]);
}

// Fields in ascending field number, as schema/wire.py emits them.
struct FieldSpec {
  uint32_t field;
  int col;   // scalar column, or -1
  int addr;  // address column, or -1
};
constexpr FieldSpec kEmitOrder[] = {
    {1, COL_TYPE, -1},         {2, COL_TIME_RECEIVED, -1},
    {3, COL_SAMPLING_RATE, -1}, {4, COL_SEQUENCE_NUM, -1},
    {5, COL_TIME_FLOW_END, -1}, {6, -1, ADDR_SRC},
    {7, -1, ADDR_DST},          {9, COL_BYTES, -1},
    {10, COL_PACKETS, -1},      {11, -1, ADDR_SAMPLER},
    {14, COL_SRC_AS, -1},       {15, COL_DST_AS, -1},
    {18, COL_IN_IF, -1},        {19, COL_OUT_IF, -1},
    {20, COL_PROTO, -1},        {21, COL_SRC_PORT, -1},
    {22, COL_DST_PORT, -1},     {23, COL_IP_TOS, -1},
    {24, COL_FORWARDING_STATUS, -1}, {25, COL_IP_TTL, -1},
    {26, COL_TCP_FLAGS, -1},    {30, COL_ETYPE, -1},
    {31, COL_ICMP_TYPE, -1},    {32, COL_ICMP_CODE, -1},
    {37, COL_IPV6_FLOW_LABEL, -1}, {38, COL_TIME_FLOW_START, -1},
    {42, COL_FLOW_DIRECTION, -1},
};

// ---- hash-group (ops/hostgroup.py's native twin) --------------------------
//
// One pass: the 64-bit key hash of ops/hostgroup.py hash_u64 (same
// multiplier/seed pairs), a stable sort of (hash, row) pairs, group
// boundaries, and a verify of every row against its group's first row.

inline uint32_t mix_lanes(const uint32_t* row, int64_t w, uint32_t mult,
                          uint32_t seed) {
  uint32_t h = seed;
  for (int64_t i = 0; i < w; ++i) {
    h = (h ^ row[i]) * mult;
    h = (h << 13) | (h >> 19);
  }
  h ^= h >> 16;
  h *= 0x85EBCA6BU;
  h ^= h >> 13;
  h *= 0xC2B2AE35U;
  h ^= h >> 16;
  return h;
}

inline uint64_t row_hash(const uint32_t* row, int64_t w) {
  uint64_t hi = mix_lanes(row, w, 0x9E3779B1U, 0x2545F491U);
  uint64_t lo = mix_lanes(row, w, 0x85EBCA77U, 0x27220A95U);
  return (hi << 32) | lo;
}

// Work-stealing task loop: fn(t) for t in [0, n_tasks) over up to
// `threads` workers, spawned and joined per call. Tasks write disjoint
// data, so the interleaving never changes a value.
template <typename F>
void parallel_tasks(long long n_tasks, int threads, F fn) {
  if (threads <= 1 || n_tasks <= 1) {
    for (long long t = 0; t < n_tasks; ++t) fn(t);
    return;
  }
  int nt = static_cast<int>(std::min<long long>(threads, n_tasks));
  std::atomic<long long> next{0};
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int i = 0; i < nt; ++i) {
    pool.emplace_back([&next, n_tasks, &fn] {
      long long t;
      while ((t = next.fetch_add(1, std::memory_order_relaxed)) < n_tasks) {
        fn(t);
      }
    });
  }
  for (auto& th : pool) th.join();
}

constexpr long long kRowBlock = 2048;

}  // namespace

extern "C" {

// Hash-group [n, w] uint32 key lanes: the row permutation ordering rows
// by their 64-bit key hash (ascending, original order on equal hashes)
// into `perm`, group start offsets into `starts` (caller-allocated, n
// int32 each), and *collided = 1 when two DISTINCT rows share a hash.
// `stats` (nullable) accumulates the radix and refine wall ns and the
// row and group counts. Returns the number of groups, or -1 when n
// exceeds int32 indexing.
long long fpt_hash_group(const uint32_t* lanes, long long n, long long w,
                         int32_t* perm, int32_t* starts, int32_t* collided,
                         int64_t* stats) {
  *collided = 0;
  if (n <= 0) return 0;
  if (n > INT32_MAX) return -1;
  int64_t t0 = ff_now_ns(stats);
  // hash + index pairs, double-buffered for the LSD radix passes
  uint64_t* h = new uint64_t[2 * n];
  uint32_t* idx = new uint32_t[2 * n];
  uint64_t* hb = h + n;
  uint32_t* ib = idx + n;
  for (int64_t r = 0; r < n; ++r) {
    h[r] = row_hash(lanes + r * w, w);
    idx[r] = static_cast<uint32_t>(r);
  }
  // stable LSD radix on the HIGH 32 bits (4 passes); equal-high runs are
  // refined by the full hash below, which gives ascending 64-bit hash
  // with original order on full ties
  int64_t count[256];
  for (int shift = 32; shift < 64; shift += 8) {
    std::memset(count, 0, sizeof(count));
    for (int64_t r = 0; r < n; ++r) ++count[(h[r] >> shift) & 0xFF];
    int64_t pos = 0;
    for (int d = 0; d < 256; ++d) {
      int64_t c = count[d];
      count[d] = pos;
      pos += c;
    }
    for (int64_t r = 0; r < n; ++r) {
      int64_t dst = count[(h[r] >> shift) & 0xFF]++;
      hb[dst] = h[r];
      ib[dst] = idx[r];
    }
    uint64_t* th = h; h = hb; hb = th;
    uint32_t* ti = idx; idx = ib; ib = ti;
  }
  int64_t t1 = ff_now_ns(stats);
  for (int64_t i = 0; i < n;) {
    int64_t j = i + 1;
    while (j < n && (h[j] >> 32) == (h[i] >> 32)) ++j;
    int64_t run = j - i;
    if (run > 64) {
      // a long run is identical keys (nothing to sort) or crafted
      // collisions: an O(r log r) stable sort either way
      bool all_equal = true;
      for (int64_t r = i + 1; r < j && all_equal; ++r) {
        all_equal = h[r] == h[i];
      }
      if (!all_equal) {
        std::vector<std::pair<uint64_t, uint32_t>> tmp;
        tmp.reserve(static_cast<size_t>(run));
        for (int64_t r = i; r < j; ++r) tmp.emplace_back(h[r], idx[r]);
        std::stable_sort(tmp.begin(), tmp.end(),
                         [](const std::pair<uint64_t, uint32_t>& a,
                            const std::pair<uint64_t, uint32_t>& b) {
                           return a.first < b.first;
                         });
        for (int64_t r = i; r < j; ++r) {
          h[r] = tmp[static_cast<size_t>(r - i)].first;
          idx[r] = tmp[static_cast<size_t>(r - i)].second;
        }
      }
    } else if (run > 1) {
      // stable insertion sort by the full hash
      for (int64_t k = i + 1; k < j; ++k) {
        uint64_t hk = h[k];
        uint32_t ik = idx[k];
        int64_t m = k - 1;
        while (m >= i && h[m] > hk) {
          h[m + 1] = h[m];
          idx[m + 1] = idx[m];
          --m;
        }
        h[m + 1] = hk;
        idx[m + 1] = ik;
      }
    }
    i = j;
  }
  long long n_groups = 0;
  const uint32_t* rep = nullptr;  // the current group's first row
  for (int64_t r = 0; r < n; ++r) {
    perm[r] = static_cast<int32_t>(idx[r]);
    const uint32_t* row = lanes + static_cast<int64_t>(idx[r]) * w;
    if (r == 0 || h[r] != h[r - 1]) {
      starts[n_groups++] = static_cast<int32_t>(r);
      rep = row;
    } else if (!*collided &&
               std::memcmp(row, rep, w * sizeof(uint32_t)) != 0) {
      *collided = 1;
    }
  }
  // an even number of passes (4): the data ended in the first halves
  delete[] (h < hb ? h : hb);
  delete[] (idx < ib ? idx : ib);
  if (stats != nullptr) {
    stats[FF_STAT_RADIX_NS] += t1 - t0;
    stats[FF_STAT_REFINE_NS] += ff_now_ns(stats) - t1;
    stats[FF_STAT_ROWS] += n;
    stats[FF_STAT_GROUPS] += n_groups;
    stats[FF_STAT_RADIX_PASSES] += 4;
  }
  return n_groups;
}

// fpt_hash_group over `threads` workers, with the same output at any
// thread count: rows are hashed in parallel blocks, scattered into 256
// partitions by the hash's top byte (block-ascending, so each partition
// holds its rows in original order and no hash value spans two), each
// partition is stable-sorted by the full hash on its own, and the
// partitions concatenate in index order into the serial kernel's order.
// The serial kernel serves under 2 threads or 4,096 rows.
long long fpt_hash_group_mt(const uint32_t* lanes, long long n, long long w,
                            int32_t* perm, int32_t* starts,
                            int32_t* collided, int threads,
                            int64_t* stats) {
  if (threads <= 1 || n < 4096) {
    return fpt_hash_group(lanes, n, w, perm, starts, collided, stats);
  }
  *collided = 0;
  if (n > INT32_MAX) return -1;
  int64_t t0 = ff_now_ns(stats);
  constexpr int kParts = 256;
  int nblk = static_cast<int>(std::min<long long>(
      std::min(threads, 16), (n + kRowBlock - 1) / kRowBlock));
  std::vector<uint64_t> h(static_cast<size_t>(n));
  std::vector<int64_t> cnt(static_cast<size_t>(nblk) * kParts, 0);
  parallel_tasks(nblk, threads, [&](long long b) {
    int64_t lo = n * b / nblk, hi = n * (b + 1) / nblk;
    int64_t* c = cnt.data() + b * kParts;
    for (int64_t r = lo; r < hi; ++r) {
      h[static_cast<size_t>(r)] = row_hash(lanes + r * w, w);
      ++c[h[static_cast<size_t>(r)] >> 56];
    }
  });
  // partition-major, block-ascending prefix sums: the scatter cursors
  std::vector<int64_t> part_base(kParts + 1);
  int64_t pos = 0;
  for (int p = 0; p < kParts; ++p) {
    part_base[p] = pos;
    for (int b = 0; b < nblk; ++b) {
      int64_t c = cnt[static_cast<size_t>(b) * kParts + p];
      cnt[static_cast<size_t>(b) * kParts + p] = pos;
      pos += c;
    }
  }
  part_base[kParts] = n;
  std::vector<uint64_t> hs(static_cast<size_t>(n));
  std::vector<uint32_t> is(static_cast<size_t>(n));
  parallel_tasks(nblk, threads, [&](long long b) {
    int64_t lo = n * b / nblk, hi = n * (b + 1) / nblk;
    int64_t* c = cnt.data() + b * kParts;
    for (int64_t r = lo; r < hi; ++r) {
      int64_t dst = c[h[static_cast<size_t>(r)] >> 56]++;
      hs[static_cast<size_t>(dst)] = h[static_cast<size_t>(r)];
      is[static_cast<size_t>(dst)] = static_cast<uint32_t>(r);
    }
  });
  // per-partition stable sort, group count and collision scan; `coll`
  // is the one shared word (a monotonic flag)
  std::vector<int64_t> pgroups(kParts, 0);
  std::atomic<int> coll{0};
  parallel_tasks(kParts, threads, [&](long long p) {
    int64_t lo = part_base[p], hi = part_base[p + 1];
    if (lo >= hi) return;
    std::vector<std::pair<uint64_t, uint32_t>> tmp;
    tmp.reserve(static_cast<size_t>(hi - lo));
    for (int64_t r = lo; r < hi; ++r) {
      tmp.emplace_back(hs[static_cast<size_t>(r)],
                       is[static_cast<size_t>(r)]);
    }
    std::stable_sort(tmp.begin(), tmp.end(),
                     [](const std::pair<uint64_t, uint32_t>& a,
                        const std::pair<uint64_t, uint32_t>& b) {
                       return a.first < b.first;
                     });
    int64_t g = 0;
    const uint32_t* rep = nullptr;
    int c = 0;
    for (int64_t i = 0; i < hi - lo; ++i) {
      const auto& e = tmp[static_cast<size_t>(i)];
      hs[static_cast<size_t>(lo + i)] = e.first;
      is[static_cast<size_t>(lo + i)] = e.second;
      const uint32_t* row = lanes + static_cast<int64_t>(e.second) * w;
      if (i == 0 || e.first != tmp[static_cast<size_t>(i - 1)].first) {
        ++g;
        rep = row;
      } else if (!c && std::memcmp(row, rep, static_cast<size_t>(w) *
                                                   sizeof(uint32_t)) != 0) {
        c = 1;
      }
    }
    pgroups[static_cast<size_t>(p)] = g;
    if (c) coll.store(1, std::memory_order_relaxed);
  });
  int64_t t1 = ff_now_ns(stats);
  std::vector<int64_t> gbase(kParts);
  long long n_groups = 0;
  for (int p = 0; p < kParts; ++p) {
    gbase[p] = n_groups;
    n_groups += pgroups[static_cast<size_t>(p)];
  }
  parallel_tasks(kParts, threads, [&](long long p) {
    int64_t lo = part_base[p], hi = part_base[p + 1];
    int64_t g = gbase[static_cast<size_t>(p)];
    for (int64_t r = lo; r < hi; ++r) {
      perm[r] = static_cast<int32_t>(is[static_cast<size_t>(r)]);
      if (r == lo || hs[static_cast<size_t>(r)] !=
                         hs[static_cast<size_t>(r - 1)]) {
        starts[g++] = static_cast<int32_t>(r);
      }
    }
  });
  *collided = coll.load(std::memory_order_relaxed);
  if (stats != nullptr) {
    stats[FF_STAT_RADIX_NS] += t1 - t0;
    stats[FF_STAT_REFINE_NS] += ff_now_ns(stats) - t1;
    stats[FF_STAT_ROWS] += n;
    stats[FF_STAT_GROUPS] += n_groups;
  }
  return n_groups;
}

long long fpt_count_frames(const char* cdata, long long len) {
  const uint8_t* data = reinterpret_cast<const uint8_t*>(cdata);
  int64_t pos = 0;
  long long frames = 0;
  while (pos < len) {
    uint64_t flen;
    int64_t start = pos;
    if (!get_varint(data, len, &pos, &flen) ||
        flen > static_cast<uint64_t>(len - pos)) {
      return -(start + 1);
    }
    pos += static_cast<int64_t>(flen);
    ++frames;
  }
  return frames;
}

long long fpt_decode_stream(const char* cdata, long long len, void** cols,
                            long long cap) {
  const uint8_t* data = reinterpret_cast<const uint8_t*>(cdata);
  int64_t pos = 0;
  long long row = 0;
  while (pos < len) {
    uint64_t flen;
    if (!get_varint(data, len, &pos, &flen) ||
        flen > static_cast<uint64_t>(len - pos) || row >= cap) {
      return -(row + 1);
    }
    if (!decode_body(data + pos, static_cast<int64_t>(flen), cols, row)) {
      return -(row + 1);
    }
    pos += static_cast<int64_t>(flen);
    ++row;
  }
  return row;
}

// n rows to length-prefixed frames. Zero scalars and all-zero addresses
// are omitted (proto3 defaults). Returns the bytes written, or -1 when
// the output buffer is too small.
long long fpt_encode_stream(void** cols, long long n, char* cout,
                            long long cap) {
  uint8_t* out = reinterpret_cast<uint8_t*>(cout);
  int64_t pos = 0;
  uint8_t body[512];  // worst case: 27 fields * 12 + 3 * 18 < 512
  for (long long row = 0; row < n; ++row) {
    int64_t bpos = 0;
    bool ok = true;
    for (const FieldSpec& fs : kEmitOrder) {
      if (fs.col >= 0) {
        uint64_t v = load_scalar(cols, fs.col, row);
        if (!v) continue;
        put_varint(body, sizeof(body), &bpos, (fs.field << 3) | 0, &ok);
        put_varint(body, sizeof(body), &bpos, v, &ok);
      } else {
        const uint32_t* words =
            static_cast<const uint32_t*>(cols[N_SCALAR_COLS + fs.addr]) +
            4 * row;
        if (!(words[0] | words[1] | words[2] | words[3])) continue;
        put_varint(body, sizeof(body), &bpos, (fs.field << 3) | 2, &ok);
        put_varint(body, sizeof(body), &bpos, 16, &ok);
        if (bpos + 16 > static_cast<int64_t>(sizeof(body))) {
          ok = false;
        } else {
          for (int w = 0; w < 4; ++w) {
            body[bpos++] = static_cast<uint8_t>(words[w] >> 24);
            body[bpos++] = static_cast<uint8_t>(words[w] >> 16);
            body[bpos++] = static_cast<uint8_t>(words[w] >> 8);
            body[bpos++] = static_cast<uint8_t>(words[w]);
          }
        }
      }
      if (!ok) return -1;
    }
    put_varint(out, cap, &pos, static_cast<uint64_t>(bpos), &ok);
    if (!ok || pos + bpos > cap) return -1;
    std::memcpy(out + pos, body, static_cast<size_t>(bpos));
    pos += bpos;
  }
  return pos;
}

}  // extern "C"
