// The port's host sketch engine: a copy of the JAX package's
// native/hostsketch.cc with its C exports renamed fpt_hs_* (so both
// packages' libraries load into one process without sharing a symbol).
// Built into the port's one native library with flowdecode.cc and
// flowfused.cc by flow_pipeline_tpu_torch/native/__init__.py.
//
// Multi-threaded uint64 count-min update (plain and conservative), the
// CMS point query, the table prefilter and the space-saving top-K
// admission merge of the table family, the invertible family's update
// and decode, and the spread family's register fold, driven through the
// same group tables the device step consumes
// (flow_pipeline_tpu_torch/hostsketch/). Their plain versions are the
// numpy twins in hostsketch/engine.py.
//
// Parity: every routine reproduces its device twin (ops/cms.py,
// ops/topk.py) bit for bit on the uint64-exact envelope: counters are
// integer-valued and per-cell totals stay below 2^24, where float32
// arithmetic is exact, so the f32 (device) and u64 (host) monoids
// coincide. Concretely:
//
// - buckets use the identical murmur3_x86_32 word-lane hash
//   (schema/keys.py hash_words), seed = depth row;
// - conservative update computes every target against the PRE-update
//   sketch then applies scatter-max: order-free, so threads need no
//   ordering discipline to be deterministic;
// - plain update adds uint64 addends: associative, so any thread
//   interleaving over disjoint (plane, depth) rows is deterministic;
// - the merge reproduces topk_merge_est's ranking exactly: groups form
//   in lexicographic key order and rank by (primary desc, lex key asc),
//   a stable argsort(-primary)'s tie behavior.
//
// Threading: parallel work is partitioned so no two threads ever write
// the same cell ((plane, depth) rows own disjoint sketch cells, row
// ranges own disjoint scratch) and joined before return. No locks, no
// atomics beyond the work-stealing task counter.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#include "ffpar.h"   // shared spawn-and-join task helpers
#include "ffstat.h"  // flowtrace stats out-struct: slots + ff_now_ns

namespace {

// ---- murmur3_x86_32 over uint32 word lanes (schema/keys.py twin) ----------

inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

inline uint32_t hash_words(const uint32_t* w, long long kw, uint32_t seed) {
  uint32_t h = seed;
  for (long long i = 0; i < kw; ++i) {
    uint32_t k = w[i];
    k *= 0xCC9E2D51u;
    k = rotl32(k, 15);
    k *= 0x1B873593u;
    h ^= k;
    h = rotl32(h, 13);
    h = h * 5u + 0xE6546B64u;
  }
  h ^= static_cast<uint32_t>(kw * 4);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// f32 addend -> u64, matching what the f32 sketch accumulates on the
// exact envelope: values are integer-valued and non-negative by
// construction (group sums of saturated u32 counters x rate); clamp
// anything outside that envelope instead of hitting UB in the cast.
inline uint64_t addend_u64(float v) {
  if (!(v > 0.0f)) return 0;  // negatives and NaN contribute nothing
  if (v >= 18446744073709551615.0f) return UINT64_MAX;
  return static_cast<uint64_t>(v);
}

// Work-stealing task loop (ffpar.h): spawn-and-join per call keeps the
// engine state-free (no persistent pool to leak or race); tasks must
// write disjoint data.
template <typename F>
void parallel_tasks(long long n_tasks, int threads, F fn) {
  ff_parallel_tasks(n_tasks, threads, fn);
}

// Row-range task shape for per-row work (bucket hashing, queries).
constexpr long long kRowBlock = kFfRowBlock;

inline long long n_blocks(long long n) {
  return ff_n_blocks(n);
}

// Precompute the u64 addends for every (row, plane) once, in one
// vectorization-friendly pass (r19 flowspeed): the scatter loops
// previously re-ran the branchy f32->u64 clamp DEPTH times per plane —
// hoisting it makes the CMS inner loop a pure gather/add/store the
// compiler can keep in registers, and costs one n*planes u64 buffer.
// Invalid rows contribute 0 (exactly what addend_u64 returns for the
// values a masked row would have added — the scatter still skips them
// via `valid`, this is belt-and-braces for the hoisted layout).
void fill_addends(const float* vals, long long n, long long planes,
                  int threads, std::vector<uint64_t>& add) {
  add.resize(static_cast<size_t>(n * planes));
  ff_parallel_rows(n, threads, [&](long long lo, long long hi) {
    for (long long i = lo * planes; i < hi * planes; ++i) {
      add[static_cast<size_t>(i)] = addend_u64(vals[i]);
    }
  });
}

// Per-depth bucket table [depth, n] — one hash pass, shared by update
// and query.
void fill_buckets(const uint32_t* keys, long long n, long long kw,
                  long long depth, long long width, int threads,
                  uint32_t* buckets) {
  parallel_tasks(n_blocks(n) * depth, threads,
                 [&](long long task) {
    long long d = task % depth;
    long long blk = task / depth;
    long long lo = blk * kRowBlock;
    long long hi = std::min(n, lo + kRowBlock);
    uint32_t seed = static_cast<uint32_t>(d);
    uint32_t w = static_cast<uint32_t>(width);
    for (long long r = lo; r < hi; ++r) {
      buckets[d * n + r] = hash_words(keys + r * kw, kw, seed) % w;
    }
  });
}

// ---- invertible-sketch key checksum (protocol constant) -------------------
//
// 64-bit lane-fold hash verifying a decoded key against its bucket's
// checksum plane. Mirrored EXACTLY by hostsketch/engine.py
// np_inv_key_hash and ops/invsketch.py inv_key_hash — all arithmetic is
// mod 2^64 (wrap), so per-occurrence checksum contributions stay a
// linear u64 monoid (merge = element sum) like every other inv plane.
inline uint64_t inv_key_hash(const uint32_t* w, long long kw) {
  uint64_t h = 0x9E3779B97F4A7C15ull;
  for (long long i = 0; i < kw; ++i) {
    h ^= static_cast<uint64_t>(w[i]);
    h *= 0xFF51AFD7ED558CCDull;
    h ^= h >> 33;
  }
  h *= 0xC4CEB9FE1A85EC53ull;
  h ^= h >> 29;
  return h;
}

// h1 of ops.hostgroup.hash_u64 / ops.segment.hash_lanes: the 32-bit mix
// the table prefilter's membership test rides (same constants as
// flowdecode.cc's mix_lanes pair 0).
inline uint32_t mix_h1(const uint32_t* row, long long w) {
  uint32_t h = 0x2545F491u;
  for (long long i = 0; i < w; ++i) {
    h = (h ^ row[i]) * 0x9E3779B1u;
    h = (h << 13) | (h >> 19);
  }
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

}  // namespace

extern "C" {

// Multi-threaded uint64 CMS update over pre-aggregated unique keys —
// the native twin of ops.cms.cms_add / cms_add_conservative.
//
//   cms:    [planes, depth, width] uint64, updated in place
//   keys:   [n, kw] uint32 unique key lanes
//   vals:   [n, planes] float32 per-key addends (integer-valued)
//   valid:  [n] uint8 mask (NULL = all valid)
//   conservative: 0 = linear add, 1 = conservative (scatter-max to
//                 pre-update estimate + addend)
//
// Returns 0, or -1 on degenerate shapes (width/depth/planes < 1, n < 0,
// kw < 0). n == 0 is a clean no-op.
long long fpt_hs_cms_update(uint64_t* cms, long long planes, long long depth,
                        long long width, const uint32_t* keys, long long n,
                        long long kw, const float* vals,
                        const uint8_t* valid, int conservative,
                        int threads, int64_t* stats) {
  if (planes < 1 || depth < 1 || width < 1 || n < 0 || kw < 0) return -1;
  if (n == 0) return 0;
  int64_t t0 = ff_now_ns(stats);
  std::vector<uint32_t> buckets(static_cast<size_t>(depth * n));
  fill_buckets(keys, n, kw, depth, width, threads, buckets.data());

  if (!conservative) {
    // Linear add: each (plane, depth) row owns a disjoint cell range;
    // u64 addition is associative so the task order is irrelevant.
    // Addends are hoisted out of the scatter (fill_addends): the inner
    // loop is a pure gather/add/store instead of re-running the branchy
    // clamp depth times per plane.
    std::vector<uint64_t> add;
    fill_addends(vals, n, planes, threads, add);
    parallel_tasks(planes * depth, threads, [&](long long task) {
      long long p = task / depth, d = task % depth;
      uint64_t* row = cms + (p * depth + d) * width;
      const uint32_t* b = buckets.data() + d * n;
      const uint64_t* a = add.data() + p;
      for (long long r = 0; r < n; ++r) {
        if (valid && !valid[r]) continue;
        row[b[r]] += a[r * planes];
      }
    });
    if (stats != nullptr) stats[FF_STAT_CMS_NS] += ff_now_ns(stats) - t0;
    return 0;
  }

  // Conservative update, two phases exactly like the XLA graph: every
  // target reads the PRE-update sketch (cms_query before any write),
  // then the scatter-max applies — max is order-free, so the result is
  // independent of both key order and thread interleaving.
  // No fill_addends hoist here: the target pass reads each addend
  // exactly ONCE (unlike the plain scatter, which reuses them depth
  // times per plane), so the hoist would only add an n*planes buffer
  // and an extra memory pass to the gather-dominated loop.
  std::vector<uint64_t> target(static_cast<size_t>(n * planes));
  parallel_tasks(n_blocks(n), threads, [&](long long blk) {
    long long lo = blk * kRowBlock;
    long long hi = std::min(n, lo + kRowBlock);
    for (long long r = lo; r < hi; ++r) {
      if (valid && !valid[r]) continue;
      for (long long p = 0; p < planes; ++p) {
        uint64_t est = UINT64_MAX;
        for (long long d = 0; d < depth; ++d) {
          uint64_t cell = cms[(p * depth + d) * width + buckets[d * n + r]];
          if (cell < est) est = cell;
        }
        target[r * planes + p] = est + addend_u64(vals[r * planes + p]);
      }
    }
  });
  parallel_tasks(planes * depth, threads, [&](long long task) {
    long long p = task / depth, d = task % depth;
    uint64_t* row = cms + (p * depth + d) * width;
    const uint32_t* b = buckets.data() + d * n;
    for (long long r = 0; r < n; ++r) {
      if (valid && !valid[r]) continue;
      uint64_t t = target[r * planes + p];
      if (t > row[b[r]]) row[b[r]] = t;
    }
  });
  if (stats != nullptr) stats[FF_STAT_CMS_NS] += ff_now_ns(stats) - t0;
  return 0;
}

// CMS point query: min over depth rows per plane, as float32 — the
// native twin of ops.cms.cms_query. out: [n, planes] float32.
long long fpt_hs_cms_query(const uint64_t* cms, long long planes,
                       long long depth, long long width,
                       const uint32_t* keys, long long n, long long kw,
                       float* out, int threads, int64_t* stats) {
  if (planes < 1 || depth < 1 || width < 1 || n < 0 || kw < 0) return -1;
  if (n == 0) return 0;
  int64_t t0 = ff_now_ns(stats);
  std::vector<uint32_t> buckets(static_cast<size_t>(depth * n));
  fill_buckets(keys, n, kw, depth, width, threads, buckets.data());
  parallel_tasks(n_blocks(n), threads, [&](long long blk) {
    long long lo = blk * kRowBlock;
    long long hi = std::min(n, lo + kRowBlock);
    for (long long r = lo; r < hi; ++r) {
      for (long long p = 0; p < planes; ++p) {
        uint64_t est = UINT64_MAX;
        for (long long d = 0; d < depth; ++d) {
          uint64_t cell = cms[(p * depth + d) * width + buckets[d * n + r]];
          if (cell < est) est = cell;
        }
        out[r * planes + p] = static_cast<float>(est);
      }
    }
  });
  // query time counts toward the admission/top-K phase: the only
  // in-pipeline caller is the `est` admission's pre-merge estimate
  if (stats != nullptr) stats[FF_STAT_TOPK_NS] += ff_now_ns(stats) - t0;
  return 0;
}

// Table-aware candidate prefilter — the native twin of
// _apply_grouped's prefilter block (models/heavy_hitter.py).
//
// Boosts groups whose key hash is already in the table's hash set
// (residents are NEVER starved of their increments), then selects the
// top 2*cap candidates by (metric desc, index asc) — lax.top_k's
// lowest-index tie-break. Writes the selected row indices, in that
// exact order, into sel_out (caller-allocated, 2*cap entries) and
// returns how many were written (min(n, 2*cap)), or -1 on degenerate
// shapes. Membership rides the same h1 hash lane as the jitted path:
// one false positive per ~cap/2^32 groups merely spends a candidate
// slot on a loser.
long long fpt_hs_hh_prefilter(const uint32_t* table_keys, long long cap,
                          long long kw, const uint32_t* uniq,
                          const float* sums, long long n, long long planes,
                          int32_t* sel_out, int threads, int64_t* stats) {
  if (cap < 1 || kw < 1 || planes < 1 || n < 0) return -1;
  if (n == 0) return 0;
  int64_t t0 = ff_now_ns(stats);
  std::vector<uint32_t> th(static_cast<size_t>(cap));
  for (long long c = 0; c < cap; ++c) {
    th[static_cast<size_t>(c)] = mix_h1(table_keys + c * kw, kw);
  }
  std::sort(th.begin(), th.end());
  // metric: plane-0 sum, residents boosted to +inf (matches
  // jnp.where(resident, inf, sums[:, 0]))
  std::vector<float> metric(static_cast<size_t>(n));
  parallel_tasks(n_blocks(n), threads, [&](long long blk) {
    long long lo = blk * kRowBlock;
    long long hi = std::min(n, lo + kRowBlock);
    for (long long r = lo; r < hi; ++r) {
      uint32_t gh = mix_h1(uniq + r * kw, kw);
      bool resident = std::binary_search(th.begin(), th.end(), gh);
      metric[static_cast<size_t>(r)] =
          resident ? std::numeric_limits<float>::infinity()
                   : sums[r * planes];
    }
  });
  long long m = std::min(n, 2 * cap);
  std::vector<int32_t> idx(static_cast<size_t>(n));
  for (long long r = 0; r < n; ++r) idx[static_cast<size_t>(r)] = static_cast<int32_t>(r);
  auto cmp = [&metric](int32_t a, int32_t b) {
    float ma = metric[static_cast<size_t>(a)];
    float mb = metric[static_cast<size_t>(b)];
    if (ma != mb) return ma > mb;
    return a < b;
  };
  std::partial_sort(idx.begin(), idx.begin() + m, idx.end(), cmp);
  std::memcpy(sel_out, idx.data(), static_cast<size_t>(m) * sizeof(int32_t));
  if (stats != nullptr) stats[FF_STAT_PREFILTER_NS] += ff_now_ns(stats) - t0;
  return m;
}

// Space-saving admission merge — the native twin of
// ops.topk.topk_merge_est, in place on the table buffers.
//
//   table_keys: [cap, kw] uint32 (all-0xFFFFFFFF rows = empty slots)
//   table_vals: [cap, planes] float32
//   cand_keys:  [n, kw] uint32 unique candidate keys
//   cand_sums:  [n, planes] float32 batch sums (resident increment)
//   cand_est:   [n, planes] float32 CMS estimates (new-key entry value;
//               pass cand_sums here for the "plain" batch-sum merge)
//   cand_valid: [n] uint8
//
// A key already resident takes table + sums; a new key enters with est.
// The rewritten table is ranked by vals[:, 0] descending with ties in
// lexicographic key order — jnp.argsort(-primary)'s stable order over
// sort_groupby_float's lex-ordered groups. Returns the number of real
// rows, or -1 on degenerate shapes.
long long fpt_hs_topk_merge(uint32_t* table_keys, float* table_vals,
                        long long cap, long long kw, long long planes,
                        const uint32_t* cand_keys, const float* cand_sums,
                        const float* cand_est, const uint8_t* cand_valid,
                        long long n, int64_t* stats) {
  if (cap < 1 || kw < 1 || planes < 1 || n < 0) return -1;
  int64_t t0 = ff_now_ns(stats);

  // Snapshot the table first: the merge rewrites the buffers in place.
  std::vector<uint32_t> old_keys(table_keys,
                                 table_keys + cap * kw);
  std::vector<float> old_vals(table_vals, table_vals + cap * planes);

  auto is_sentinel = [kw](const uint32_t* key) {
    for (long long i = 0; i < kw; ++i) {
      if (key[i] != 0xFFFFFFFFu) return false;
    }
    return true;
  };

  struct Tagged {
    const uint32_t* key;
    long long table_row;  // -1 when candidate
    long long cand_row;   // -1 when table
  };
  std::vector<Tagged> rows;
  rows.reserve(static_cast<size_t>(cap + n));
  for (long long c = 0; c < cap; ++c) {
    const uint32_t* key = old_keys.data() + c * kw;
    if (!is_sentinel(key)) rows.push_back({key, c, -1});
  }
  for (long long r = 0; r < n; ++r) {
    if (cand_valid && !cand_valid[r]) continue;
    const uint32_t* key = cand_keys + r * kw;
    if (!is_sentinel(key)) rows.push_back({key, -1, r});
  }
  auto key_less = [kw](const uint32_t* a, const uint32_t* b) {
    for (long long i = 0; i < kw; ++i) {
      if (a[i] != b[i]) return a[i] < b[i];
    }
    return false;
  };
  std::sort(rows.begin(), rows.end(),
            [&key_less](const Tagged& a, const Tagged& b) {
              return key_less(a.key, b.key);
            });

  struct Group {
    const uint32_t* key;
    std::vector<float> vals;
  };
  std::vector<Group> groups;
  groups.reserve(rows.size());
  size_t i = 0;
  while (i < rows.size()) {
    size_t j = i + 1;
    while (j < rows.size() &&
           std::memcmp(rows[j].key, rows[i].key,
                       static_cast<size_t>(kw) * sizeof(uint32_t)) == 0) {
      ++j;
    }
    long long trow = -1, crow = -1;
    for (size_t k = i; k < j; ++k) {
      if (rows[k].table_row >= 0) trow = rows[k].table_row;
      if (rows[k].cand_row >= 0) crow = rows[k].cand_row;
    }
    Group g;
    g.key = rows[i].key;
    g.vals.resize(static_cast<size_t>(planes));
    bool resident = trow >= 0;
    for (long long p = 0; p < planes; ++p) {
      float t = resident ? old_vals[trow * planes + p] : 0.0f;
      float c = 0.0f;
      if (crow >= 0) {
        c = resident ? cand_sums[crow * planes + p]
                     : cand_est[crow * planes + p];
      }
      g.vals[static_cast<size_t>(p)] = t + c;  // one f32 add, like the jit
    }
    groups.push_back(std::move(g));
    i = j;
  }

  // Rank: primary value descending; equal primaries keep lexicographic
  // key order (groups are already lex-ordered, so a stable sort on the
  // primary alone reproduces argsort(-primary)'s tie behavior).
  std::stable_sort(groups.begin(), groups.end(),
                   [](const Group& a, const Group& b) {
                     return a.vals[0] > b.vals[0];
                   });

  long long real = static_cast<long long>(
      std::min<size_t>(groups.size(), static_cast<size_t>(cap)));
  for (long long c = 0; c < real; ++c) {
    std::memcpy(table_keys + c * kw, groups[static_cast<size_t>(c)].key,
                static_cast<size_t>(kw) * sizeof(uint32_t));
    std::memcpy(table_vals + c * planes,
                groups[static_cast<size_t>(c)].vals.data(),
                static_cast<size_t>(planes) * sizeof(float));
  }
  for (long long c = real; c < cap; ++c) {
    for (long long w = 0; w < kw; ++w) table_keys[c * kw + w] = 0xFFFFFFFFu;
    for (long long p = 0; p < planes; ++p) table_vals[c * planes + p] = 0.0f;
  }
  if (stats != nullptr) stats[FF_STAT_TOPK_NS] += ff_now_ns(stats) - t0;
  return real;
}

// Invertible-sketch update (-hh.sketch=invertible): one pure per-bucket
// fold with NO admission machinery — no candidate table, no admission
// CMS query, no prefilter. Per group row r and depth row d (bucket b =
// the SAME murmur3 word-lane hash the CMS planes use):
//
//   cms[p, d, b]        += addend_u64(vals[r, p])        (all planes)
//   keysum[d, b, l]     += key[r, l] * cnt   (wrap, per key lane l)
//   keycheck[d, b]      += inv_key_hash(key[r]) * cnt    (wrap)
//
// where cnt is the count-plane addend. Every cell is a plain u64 wrap
// sum — linear in the stream — so (a) merging shards is an element-wise
// u64 sum, (b) update order is irrelevant (associative + commutative:
// deterministic at ANY thread count with no ordering discipline), and
// (c) heavy keys are recovered from the sketch itself at window close
// (fpt_hs_inv_decode below; the 1910.10441 network-wide invertibility
// model). The count planes are always PLAIN-updated: conservative
// update would break the per-bucket exactness the decode divides by.
//
//   cms:      [planes, depth, width] uint64, in place
//   keysum:   [depth, width, kw] uint64, in place
//   keycheck: [depth, width] uint64, in place
//   keys:     [n, kw] uint32 unique key lanes
//   vals:     [n, planes] float32 addends (count plane LAST)
//   valid:    [n] uint8 mask (NULL = all valid)
//
// Returns 0, or -1 on degenerate shapes. n == 0 is a clean no-op.
long long fpt_hs_inv_update(uint64_t* cms, long long planes, long long depth,
                        long long width, uint64_t* keysum,
                        uint64_t* keycheck, const uint32_t* keys,
                        long long n, long long kw, const float* vals,
                        const uint8_t* valid, int threads,
                        int64_t* stats) {
  if (planes < 1 || depth < 1 || width < 1 || n < 0 || kw < 1) return -1;
  if (n == 0) return 0;
  int64_t t0 = ff_now_ns(stats);
  std::vector<uint32_t> buckets(static_cast<size_t>(depth * n));
  fill_buckets(keys, n, kw, depth, width, threads, buckets.data());
  // per-row count weight + 64-bit checksum hash, once per row (shared
  // by every depth task below)
  std::vector<uint64_t> cnt(static_cast<size_t>(n));
  std::vector<uint64_t> h64(static_cast<size_t>(n));
  parallel_tasks(n_blocks(n), threads, [&](long long blk) {
    long long lo = blk * kRowBlock;
    long long hi = std::min(n, lo + kRowBlock);
    for (long long r = lo; r < hi; ++r) {
      cnt[static_cast<size_t>(r)] =
          addend_u64(vals[r * planes + (planes - 1)]);
      h64[static_cast<size_t>(r)] = inv_key_hash(keys + r * kw, kw);
    }
  });
  // count/value planes: each (plane, depth) row owns disjoint cells
  // (addends hoisted once per (row, plane) — fill_addends)
  std::vector<uint64_t> add;
  fill_addends(vals, n, planes, threads, add);
  parallel_tasks(planes * depth, threads, [&](long long task) {
    long long p = task / depth, d = task % depth;
    uint64_t* row = cms + (p * depth + d) * width;
    const uint32_t* b = buckets.data() + d * n;
    const uint64_t* a = add.data() + p;
    for (long long r = 0; r < n; ++r) {
      if (valid && !valid[r]) continue;
      row[b[r]] += a[r * planes];
    }
  });
  // key-recovery planes: task d owns the WHOLE depth row — keysum
  // lanes AND checksum — so each bucket's kw+1 contiguous cells are
  // touched in one pass per row with a vectorizable per-lane
  // mul-accumulate over l (r19 flowspeed: the pre-r19 (d, l) column
  // split walked the row kw+1 times with a stride-kw inner loop, which
  // is exactly the layout autovectorizers refuse). Wrap adds stay
  // order-free and rows of different depths stay disjoint, so the
  // determinism contract is unchanged at any thread count.
  parallel_tasks(depth, threads, [&](long long d) {
    const uint32_t* b = buckets.data() + d * n;
    uint64_t* ks_row = keysum + d * width * kw;
    uint64_t* kc_row = keycheck + d * width;
    for (long long r = 0; r < n; ++r) {
      if (valid && !valid[r]) continue;
      uint64_t c = cnt[static_cast<size_t>(r)];
      uint64_t* cell = ks_row + static_cast<long long>(b[r]) * kw;
      const uint32_t* k = keys + r * kw;
      for (long long l = 0; l < kw; ++l) {
        cell[l] += static_cast<uint64_t>(k[l]) * c;
      }
      kc_row[b[r]] += h64[static_cast<size_t>(r)] * c;
    }
  });
  if (stats != nullptr) stats[FF_STAT_INV_NS] += ff_now_ns(stats) - t0;
  return 0;
}

// Heavy-key recovery from an invertible sketch — IBLT-style peeling
// over PURE buckets. A bucket holding exactly one distinct key decodes
// exactly: every keysum lane divides evenly by the count cell, the
// quotient re-hashes to this bucket, and the checksum plane equals
// inv_key_hash(key) * count (mod 2^64 — a false decode survives all
// three checks with probability ~2^-64). Each decoded key's exact
// contribution is subtracted from its bucket in EVERY depth row, which
// may make further buckets pure; the peel iterates to a fixpoint. The
// recoverable key SET is order-independent (peeling is confluent), so
// the caller's canonical lex sort + ranking makes native and numpy
// decodes bit-identical.
//
// Inputs are read-only (the peel works on copies). Outputs are
// caller-allocated at depth*width rows (each decode zeroes its own
// bucket, so decodes can never exceed the bucket count):
//   keys_out: [depth*width, kw] uint32
//   vals_out: [depth*width, planes] uint64 (exact per-key sums,
//             count plane last)
// Returns the number of decoded keys, or -1 on degenerate shapes.
long long fpt_hs_inv_decode(const uint64_t* cms, long long planes,
                        long long depth, long long width,
                        const uint64_t* keysum, const uint64_t* keycheck,
                        long long kw, uint32_t* keys_out,
                        uint64_t* vals_out, int64_t* stats) {
  if (planes < 1 || depth < 1 || width < 1 || kw < 1) return -1;
  int64_t t0 = ff_now_ns(stats);
  std::vector<uint64_t> c(cms, cms + planes * depth * width);
  std::vector<uint64_t> ks(keysum, keysum + depth * width * kw);
  std::vector<uint64_t> kc(keycheck, keycheck + depth * width);
  auto cnt_at = [&](long long d, long long b) -> uint64_t& {
    return c[((planes - 1) * depth + d) * width + b];
  };
  std::vector<long long> work;
  std::vector<uint8_t> queued(static_cast<size_t>(depth * width), 0);
  work.reserve(static_cast<size_t>(depth * width));
  for (long long d = 0; d < depth; ++d) {
    for (long long b = 0; b < width; ++b) {
      if (cnt_at(d, b) != 0) {
        work.push_back(d * width + b);
        queued[static_cast<size_t>(d * width + b)] = 1;
      }
    }
  }
  std::vector<uint32_t> key(static_cast<size_t>(kw));
  long long n_out = 0;
  while (!work.empty()) {
    long long db = work.back();
    work.pop_back();
    queued[static_cast<size_t>(db)] = 0;
    long long d = db / width, b = db % width;
    uint64_t cnt = cnt_at(d, b);
    if (cnt == 0) continue;
    const uint64_t* krow = ks.data() + (d * width + b) * kw;
    bool pure = true;
    for (long long l = 0; l < kw; ++l) {
      uint64_t v = krow[l];
      if (v % cnt != 0 || v / cnt > 0xFFFFFFFFull) {
        pure = false;
        break;
      }
      key[static_cast<size_t>(l)] = static_cast<uint32_t>(v / cnt);
    }
    if (!pure) continue;
    uint64_t h = inv_key_hash(key.data(), kw);
    if (h * cnt != kc[d * width + b]) continue;
    if (hash_words(key.data(), kw, static_cast<uint32_t>(d)) %
            static_cast<uint32_t>(width) !=
        static_cast<uint32_t>(b)) {
      continue;
    }
    if (n_out >= depth * width) {
      // honest states cannot get here (each decode zeroes its own
      // bucket), but this kernel also runs on member-SUPPLIED mesh
      // payloads at the coordinator: a crafted state whose wrap
      // subtractions keep re-activating buckets must exhaust the
      // caller's depth*width-row buffers, not overflow them
      break;
    }
    // exact per-key sums = this pure bucket's plane cells
    uint64_t* out_v = vals_out + n_out * planes;
    for (long long p = 0; p < planes; ++p) {
      out_v[p] = c[(p * depth + d) * width + b];
    }
    std::memcpy(keys_out + n_out * kw, key.data(),
                static_cast<size_t>(kw) * sizeof(uint32_t));
    ++n_out;
    // peel the key from every depth row (wrap subtraction — exact for
    // true decodes), re-queueing touched buckets
    for (long long d2 = 0; d2 < depth; ++d2) {
      long long b2 = hash_words(key.data(), kw,
                                static_cast<uint32_t>(d2)) %
                     static_cast<uint32_t>(width);
      for (long long p = 0; p < planes; ++p) {
        c[(p * depth + d2) * width + b2] -= out_v[p];
      }
      uint64_t* k2 = ks.data() + (d2 * width + b2) * kw;
      for (long long l = 0; l < kw; ++l) {
        k2[l] -= static_cast<uint64_t>(key[static_cast<size_t>(l)]) *
                 out_v[planes - 1];
      }
      kc[d2 * width + b2] -= h * out_v[planes - 1];
      long long db2 = d2 * width + b2;
      if (cnt_at(d2, b2) != 0 && !queued[static_cast<size_t>(db2)]) {
        work.push_back(db2);
        queued[static_cast<size_t>(db2)] = 1;
      }
    }
  }
  if (stats != nullptr) stats[FF_STAT_INV_NS] += ff_now_ns(stats) - t0;
  return n_out;
}

// Distinct-count (flowspread) register update — the native twin of
// hostsketch/engine.py np_spread_update and ops/spread.py
// spread_update. Per pre-grouped (key, element) pair row r and depth
// row d (bucket b = the SAME murmur3 word-lane hash the CMS rows use):
//
//   reg = hash_words(elem, SPREAD_REG_SEED) % m
//   rho = clz32(hash_words(elem, SPREAD_RHO_SEED)) + 1   (h == 0 -> 33)
//   regs[d, b, reg] = max(regs[d, b, reg], rho)
//
// Every cell is a u8 max — commutative, associative, IDEMPOTENT — so
// (a) merging shards is an element-wise u8 max, (b) neither update
// order nor duplicate pairs can change a bit (callers pre-group for
// throughput, not correctness), and (c) per-depth task ownership makes
// the threaded update deterministic at any thread count with no
// atomics (rows of different depths write disjoint register blocks).
//
//   regs:   [depth, width, m] uint8, in place
//   keys:   [n, kw] uint32 key lanes (pre-grouped unique pairs)
//   elems:  [n, ew] uint32 element lanes (the counted dimension)
//   valid:  [n] uint8 mask (NULL = all valid)
//
// Returns 0, or -1 on degenerate shapes. n == 0 is a clean no-op.
long long fpt_hs_spread_update(uint8_t* regs, long long depth, long long width,
                           long long m, const uint32_t* keys, long long n,
                           long long kw, const uint32_t* elems,
                           long long ew, const uint8_t* valid, int threads,
                           int64_t* stats) {
  if (depth < 1 || width < 1 || m < 1 || n < 0 || kw < 1 || ew < 1) {
    return -1;
  }
  if (n == 0) return 0;
  int64_t t0 = ff_now_ns(stats);
  std::vector<uint32_t> buckets(static_cast<size_t>(depth * n));
  fill_buckets(keys, n, kw, depth, width, threads, buckets.data());
  // per-row (register index, rho) once, shared by every depth task —
  // protocol constants mirrored bit-for-bit by ops/spread.py
  std::vector<uint32_t> reg(static_cast<size_t>(n));
  std::vector<uint8_t> rho(static_cast<size_t>(n));
  parallel_tasks(n_blocks(n), threads, [&](long long blk) {
    long long lo = blk * kRowBlock;
    long long hi = std::min(n, lo + kRowBlock);
    uint32_t mm = static_cast<uint32_t>(m);
    for (long long r = lo; r < hi; ++r) {
      const uint32_t* e = elems + r * ew;
      reg[static_cast<size_t>(r)] = hash_words(e, ew, 0x9E3779B9u) % mm;
      uint32_t h2 = hash_words(e, ew, 0x85EBCA6Bu);
      // rho = clz32(h2) + 1 in [1, 33]; __builtin_clz(0) is UB, so the
      // zero hash takes the explicit 33 branch (ops.spread's twin rule)
      rho[static_cast<size_t>(r)] =
          h2 == 0 ? 33 : static_cast<uint8_t>(__builtin_clz(h2) + 1);
    }
  });
  // scatter-max: task d owns the whole [width, m] register block of
  // depth row d — disjoint writes, and max is order-free anyway
  parallel_tasks(depth, threads, [&](long long d) {
    const uint32_t* b = buckets.data() + d * n;
    uint8_t* block = regs + d * width * m;
    for (long long r = 0; r < n; ++r) {
      if (valid && !valid[r]) continue;
      uint8_t* cell = block + static_cast<long long>(b[r]) * m +
                      reg[static_cast<size_t>(r)];
      uint8_t v = rho[static_cast<size_t>(r)];
      if (v > *cell) *cell = v;
    }
  });
  if (stats != nullptr) stats[FF_STAT_SPREAD_NS] += ff_now_ns(stats) - t0;
  return 0;
}

}  // extern "C"
