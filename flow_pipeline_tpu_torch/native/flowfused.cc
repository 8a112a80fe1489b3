// The port's fused native pass: a copy of the JAX package's
// native/flowfused.cc with its C exports renamed fpt_ff_* and its
// in-library calls naming the port's renamed kernels (fpt_hash_group,
// fpt_hs_*). One native call takes a decoded chunk's key lanes and
// value planes and
//
//   (a) radix hash-groups the finest ("own") family with the same
//       64-bit lane hash as fpt_hash_group / ops.hostgroup.hash_u64,
//   (b) regroups every strict-subset family from its parent's group
//       table (the cascade engine/hostfused.py runs in numpy),
//   (c) feeds each family's group table straight into the host sketch
//       CMS update -> table prefilter -> admission merge
//       (hostsketch.cc, called in-library),
//
// without surfacing any intermediate group rows to Python. The only
// side output is the DDoS per-dst cascade table, whose consumer (the
// torch _accumulate_grouped) stays on the device step.
//
// Parity: byte-identical inputs produce bit-exact outputs against the
// staged path (hostsketch/pipeline.py with -ingest.fused off):
//
// - grouping reuses fpt_hash_group (stable LSD radix, hash-ascending
//   group order, first-row representative), the kernel the staged
//   -ingest.native_group path runs;
// - per-group value sums accumulate in double in permutation order
//   (np.add.reduceat's sequential order over p[perm].astype(f64)) and
//   round to f32 once, exactly where engine/hostfused.py _prep_device
//   casts; counts accumulate in uint64;
// - the sketch step calls the SAME fpt_hs_* kernels the staged engine
//   calls, with the same thread gate (serial under 2048 groups) and the
//   same prefilter condition: the staged path tests its padded
//   power-of-two bucket against 2*capacity, but with n_groups <=
//   2*capacity both branches are output-equal (hostsketch/engine.py
//   update docstring), so testing the REAL group count is bit-exact.
//
// Threading: the whole pass is deterministic at ANY thread count.
// Grouping rides fpt_hash_group_mt (per-key-range partitioning,
// per-partition stable sort, bit-identical to the serial kernel);
// group-table folds parallelize over GROUP ranges (each group's
// permutation-order double accumulation is untouched, so the f64
// rounding sequence per group cannot change); the fpt_hs_* sketch
// kernels partition per (plane, depth) row. Everything joins before
// returning; no state outlives a call.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "ffpar.h"   // shared spawn-and-join task helpers
#include "ffstat.h"  // flowtrace stats out-struct: slots + ff_now_ns

extern "C" {
// in-library kernels (definitions in flowdecode.cc / hostsketch.cc)
long long fpt_hash_group(const uint32_t* lanes, long long n, long long w,
                          int32_t* perm, int32_t* starts, int32_t* collided,
                          int64_t* stats);
long long fpt_hash_group_mt(const uint32_t* lanes, long long n,
                             long long w, int32_t* perm, int32_t* starts,
                             int32_t* collided, int threads,
                             int64_t* stats);
long long fpt_hs_cms_update(uint64_t* cms, long long planes, long long depth,
                        long long width, const uint32_t* keys, long long n,
                        long long kw, const float* vals,
                        const uint8_t* valid, int conservative, int threads,
                        int64_t* stats);
long long fpt_hs_cms_query(const uint64_t* cms, long long planes,
                       long long depth, long long width,
                       const uint32_t* keys, long long n, long long kw,
                       float* out, int threads, int64_t* stats);
long long fpt_hs_hh_prefilter(const uint32_t* table_keys, long long cap,
                          long long kw, const uint32_t* uniq,
                          const float* sums, long long n, long long planes,
                          int32_t* sel_out, int threads, int64_t* stats);
long long fpt_hs_topk_merge(uint32_t* table_keys, float* table_vals,
                        long long cap, long long kw, long long planes,
                        const uint32_t* cand_keys, const float* cand_sums,
                        const float* cand_est, const uint8_t* cand_valid,
                        long long n, int64_t* stats);
long long fpt_hs_inv_update(uint64_t* cms, long long planes, long long depth,
                        long long width, uint64_t* keysum,
                        uint64_t* keycheck, const uint32_t* keys,
                        long long n, long long kw, const float* vals,
                        const uint8_t* valid, int threads, int64_t* stats);
}  // extern "C"

namespace {

// flowtrace stats (ffstat.h): the fused pass attributes root grouping
// to radix/refine (inside fpt_hash_group), cascade work to regroup,
// group-table accumulation to fold, and passes the buffer through to
// the hs_* kernels for the sketch phases.

// One family's group table, host-resident for the duration of a call.
// Value sums stay double until the sketch addends are built — the
// staged path's numpy reduceat accumulates float64 and casts to f32
// only when padding the device tables; rounding earlier would break
// bit-parity off the integer envelope.
struct FamTable {
  std::vector<uint32_t> keys;  // [g, wk]
  std::vector<double> vsum;    // [g, p]
  std::vector<uint64_t> cnt;   // [g]
  long long g = 0;
  long long wk = 0;
};

// Group [m, wk] lanes via the shared radix kernel. Returns group count
// or -1 (int32 overflow). Collisions are reported, not resolved — the
// sketch families run exact=False semantics (hash identity), matching
// ops.hostgroup.grouping_perm; exactness-contract callers use
// fpt_ff_group_sum below, which surfaces the collision instead.
long long group_lanes(const uint32_t* lanes, long long m, long long wk,
                      std::vector<int32_t>& perm,
                      std::vector<int32_t>& starts, int32_t* collided,
                      int threads, int64_t* stats) {
  perm.resize(static_cast<size_t>(m));
  starts.resize(static_cast<size_t>(std::max<long long>(m, 1)));
  *collided = 0;
  return fpt_hash_group_mt(lanes, m, wk, perm.data(), starts.data(),
                            collided, threads, stats);
}

// Serial gate shared by every fold below: under a few thousand rows
// the spawn/join overhead exceeds the win (the hostsketch engine's
// serial-under-2048-groups discipline applied to the fused folds).
inline int fold_threads(long long rows, int threads) {
  return rows < 4096 ? 1 : threads;
}

// Fold a grouping into a FamTable: representative keys, double value
// sums in permutation order (reduceat parity), uint64 counts. Exactly
// one of fsrc (raw f32 planes) / parent (cascade) provides the values.
// Threaded over GROUP ranges: tasks own disjoint group indices, and a
// group's rows still accumulate in permutation order inside one task,
// so the f64 rounding sequence — the thing reduceat parity hangs on —
// is independent of the thread count.
void accumulate(const uint32_t* lanes, long long m, long long wk,
                long long p, const float* fsrc, const FamTable* parent,
                const std::vector<int32_t>& perm,
                const std::vector<int32_t>& starts, long long g,
                int threads, FamTable& out) {
  out.g = g;
  out.wk = wk;
  out.keys.assign(static_cast<size_t>(g * wk), 0);
  out.vsum.assign(static_cast<size_t>(g * p), 0.0);
  out.cnt.assign(static_cast<size_t>(g), 0);
  ff_parallel_rows(g, fold_threads(m, threads),
                   [&](long long glo, long long ghi) {
    for (long long gi = glo; gi < ghi; ++gi) {
      long long lo = starts[static_cast<size_t>(gi)];
      long long hi = gi + 1 < g ? starts[static_cast<size_t>(gi + 1)] : m;
      std::memcpy(out.keys.data() + gi * wk,
                  lanes + static_cast<long long>(perm[lo]) * wk,
                  static_cast<size_t>(wk) * sizeof(uint32_t));
      double* acc = out.vsum.data() + gi * p;
      uint64_t cnt = 0;
      for (long long r = lo; r < hi; ++r) {
        long long row = perm[static_cast<size_t>(r)];
        if (parent != nullptr) {
          const double* src = parent->vsum.data() + row * p;
          for (long long pi = 0; pi < p; ++pi) acc[pi] += src[pi];
          cnt += parent->cnt[static_cast<size_t>(row)];
        } else {
          const float* src = fsrc + row * p;
          for (long long pi = 0; pi < p; ++pi)
            acc[pi] += static_cast<double>(src[pi]);
          ++cnt;
        }
      }
      out.cnt[static_cast<size_t>(gi)] = cnt;
    }
  });
}

// The sketch step for one family — hostsketch/engine.py update(),
// minus the Python: CMS update over all groups, prefilter when the
// candidate set exceeds 2*capacity, admission merge. All arithmetic
// delegated to the hs_* kernels the staged engine calls.
long long sketch_family(const FamTable& fam, long long p, long long depth,
                        long long width, long long cap, int conservative,
                        int prefilter, int admission_plain, int invertible,
                        uint64_t* cms, uint32_t* tkeys, float* tvals,
                        uint64_t* inv_keysum, uint64_t* inv_keycheck,
                        int threads, int64_t* stats) {
  long long g = fam.g;
  if (g <= 0) return 0;  // all-invalid chunk: CMS and table both no-ops
  long long planes = p + 1;  // + count plane
  // same serial gate as HostSketchEngine.update: under 2048 groups the
  // spawn/join overhead exceeds the win
  int t = g < 2048 ? 1 : threads;
  // f32 addend planes, cast exactly where _prep_device casts (per-group
  // work on disjoint rows — threadable at the same gate)
  std::vector<float> sums(static_cast<size_t>(g * planes));
  ff_parallel_rows(g, t, [&](long long glo, long long ghi) {
    for (long long gi = glo; gi < ghi; ++gi) {
      for (long long pi = 0; pi < p; ++pi) {
        sums[static_cast<size_t>(gi * planes + pi)] =
            static_cast<float>(fam.vsum[static_cast<size_t>(gi * p + pi)]);
      }
      sums[static_cast<size_t>(gi * planes + p)] =
          static_cast<float>(fam.cnt[static_cast<size_t>(gi)]);
    }
  });
  if (invertible) {
    // the whole admission path (prefilter -> admission CMS query ->
    // top-K merge) does not exist for the invertible family: one pure
    // per-bucket fold, heavy keys recovered at window close
    return fpt_hs_inv_update(cms, planes, depth, width, inv_keysum,
                         inv_keycheck, fam.keys.data(), g, fam.wk,
                         sums.data(), nullptr, t, stats) == 0 ? 0 : -1;
  }
  long long rc = fpt_hs_cms_update(cms, planes, depth, width, fam.keys.data(),
                               g, fam.wk, sums.data(), nullptr,
                               conservative, t, stats);
  if (rc != 0) return -1;
  const uint32_t* cand_keys = fam.keys.data();
  const float* cand_sums = sums.data();
  long long m = g;
  std::vector<uint32_t> sel_keys;
  std::vector<float> sel_sums;
  if (prefilter && g > 2 * cap) {
    std::vector<int32_t> sel(static_cast<size_t>(2 * cap));
    m = fpt_hs_hh_prefilter(tkeys, cap, fam.wk, fam.keys.data(), sums.data(),
                        g, planes, sel.data(), t, stats);
    if (m < 0) return -1;
    sel_keys.resize(static_cast<size_t>(m * fam.wk));
    sel_sums.resize(static_cast<size_t>(m * planes));
    for (long long r = 0; r < m; ++r) {
      long long src = sel[static_cast<size_t>(r)];
      std::memcpy(sel_keys.data() + r * fam.wk,
                  fam.keys.data() + src * fam.wk,
                  static_cast<size_t>(fam.wk) * sizeof(uint32_t));
      std::memcpy(sel_sums.data() + r * planes, sums.data() + src * planes,
                  static_cast<size_t>(planes) * sizeof(float));
    }
    cand_keys = sel_keys.data();
    cand_sums = sel_sums.data();
  }
  std::vector<float> est;
  const float* cand_est = cand_sums;  // admission "plain": est = sums
  if (!admission_plain) {
    est.resize(static_cast<size_t>(m * planes));
    rc = fpt_hs_cms_query(cms, planes, depth, width, cand_keys, m, fam.wk,
                      est.data(), t, stats);
    if (rc != 0) return -1;
    cand_est = est.data();
  }
  rc = fpt_hs_topk_merge(tkeys, tvals, cap, fam.wk, planes, cand_keys,
                     cand_sums, cand_est, nullptr, m, stats);
  return rc < 0 ? -1 : 0;
}

}  // namespace

extern "C" {

// Single-pass exact groupby-sum: fpt_hash_group + per-group uint64
// plane sums + counts in one call — the native twin of
// ops.hostgroup.group_by_key(exact=True) for integer planes (the
// flows_5m path). Outputs are caller-allocated at capacity n rows:
// uniq_out [n, w] uint32, sums_out [n, p] uint64, counts_out [n] int64.
// `stats` (nullable) accumulates the flowtrace phase counters (radix/
// refine via fpt_hash_group, the group fold under fold_ns). Returns
// the group count; -1 on degenerate shapes / int32 overflow;
// -2 when two DISTINCT key rows share a 64-bit hash (the caller falls
// back to the lexicographic regroup, same contract as the numpy path).
long long fpt_ff_group_sum_mt(const uint32_t* lanes, long long n, long long w,
                          const uint64_t* vals, long long p,
                          uint32_t* uniq_out, uint64_t* sums_out,
                          int64_t* counts_out, int threads,
                          int64_t* stats) {
  if (n < 0 || w < 1 || p < 0) return -1;
  if (n == 0) return 0;
  std::vector<int32_t> perm, starts;
  int32_t collided = 0;
  long long g = group_lanes(lanes, n, w, perm, starts, &collided,
                            threads, stats);
  if (g < 0) return -1;
  if (collided) return -2;
  int64_t t_fold = ff_now_ns(stats);
  // u64 fold over disjoint group ranges — exact integer sums, so the
  // thread partition cannot change a bit (the wagg exactness contract)
  ff_parallel_rows(g, fold_threads(n, threads),
                   [&](long long glo, long long ghi) {
    for (long long gi = glo; gi < ghi; ++gi) {
      long long lo = starts[static_cast<size_t>(gi)];
      long long hi = gi + 1 < g ? starts[static_cast<size_t>(gi + 1)] : n;
      std::memcpy(uniq_out + gi * w,
                  lanes + static_cast<long long>(perm[lo]) * w,
                  static_cast<size_t>(w) * sizeof(uint32_t));
      uint64_t* acc = sums_out + gi * p;
      for (long long pi = 0; pi < p; ++pi) acc[pi] = 0;
      for (long long r = lo; r < hi; ++r) {
        const uint64_t* src =
            vals +
            static_cast<long long>(perm[static_cast<size_t>(r)]) * p;
        for (long long pi = 0; pi < p; ++pi) acc[pi] += src[pi];
      }
      counts_out[gi] = hi - lo;
    }
  });
  if (stats != nullptr) {
    stats[FF_STAT_FOLD_NS] += ff_now_ns(stats) - t_fold;
  }
  return g;
}

// The single-threaded entry (fpt_ff_group_sum_mt with one thread).
long long fpt_ff_group_sum(const uint32_t* lanes, long long n, long long w,
                       const uint64_t* vals, long long p,
                       uint32_t* uniq_out, uint64_t* sums_out,
                       int64_t* counts_out, int64_t* stats) {
  return fpt_ff_group_sum_mt(lanes, n, w, vals, p, uniq_out, sums_out,
                         counts_out, 1, stats);
}

// The fused sketch dataplane over one family tree: group the root
// family's raw [n, w] lanes, cascade-regroup each child from its
// parent's group table, and run every family's CMS/prefilter/top-K
// update in place on its state buffers — plus the optional DDoS
// per-dst side table.
//
//   lanes:  [n, w] uint32 raw key lanes of the ROOT family
//   vals:   [n, p] float32 value planes (pre-scaled; count appended
//           internally, so sketch states carry p+1 planes)
//   nf:     families in the tree; family 0 is the root
//   parent: [nf] parent index within this call (-1 for the root);
//           parents must precede children
//   sel / sel_off: [sel_off[nf]] / [nf+1] — child i's key lanes are
//           parent's key columns sel[sel_off[i]:sel_off[i+1]]
//   fdepth/fwidth/fcap: [nf] per-family CMS depth/width + table cap
//   fconserv/fprefilter/fplain: [nf] per-family update flavor
//   cms_ptrs/tkey_ptrs/tval_ptrs: [nf] state buffers, updated in place
//           ([p+1, depth, width] u64 / [cap, wk] u32 / [cap, p+1] f32);
//           ignored (may be NULL) when do_sketch == 0
//   do_sketch: 0 skips every state update — grouping only, for late
//           parts that still need the DDoS side table
//   ddos_parent: family index whose table feeds the DDoS per-dst
//           cascade, or -1; ddos_sel [ddos_sel_w] selects its key
//           columns; ddos_plane picks the value plane
//   ddos_keys_out/ddos_sums_out: caller-allocated [n, ddos_sel_w]
//           uint32 / [n] float32 side-table outputs
//
// `stats` (nullable) accumulates the flowtrace phase counters — root
// grouping under radix/refine, cascade regroups (incl. the ddos side
// table) under regroup_ns, group-table folds under fold_ns, and the
// sketch phases inside the hs_* kernels the buffer rides through.
// Returns the DDoS side-table group count (0 when ddos_parent < 0), or
// -1 on degenerate shapes / kernel failure.
// Invertible families (-hh.sketch=invertible) ride the same tree:
// `finv` (nullable = all-table) marks them, `inv_ks_ptrs`/`inv_kc_ptrs`
// carry their keysum/keycheck planes, and their table/prefilter
// parameters are ignored — the admission path is simply never entered.
long long fpt_ff_fused_update(const uint32_t* lanes, long long n, long long w,
                          const float* vals, long long p, long long nf,
                          const int64_t* parent, const int64_t* sel,
                          const int64_t* sel_off, const int64_t* fdepth,
                          const int64_t* fwidth, const int64_t* fcap,
                          const uint8_t* fconserv,
                          const uint8_t* fprefilter, const uint8_t* fplain,
                          void** cms_ptrs, void** tkey_ptrs,
                          void** tval_ptrs, int do_sketch,
                          long long ddos_parent, const int64_t* ddos_sel,
                          long long ddos_sel_w, long long ddos_plane,
                          uint32_t* ddos_keys_out, float* ddos_sums_out,
                          int threads, int64_t* stats,
                          const uint8_t* finv, void** inv_ks_ptrs,
                          void** inv_kc_ptrs) {
  if (n < 0 || w < 1 || p < 0 || nf < 1 || parent[0] != -1) return -1;
  if (ddos_parent >= nf ||
      (ddos_parent >= 0 &&
       (ddos_sel_w < 1 || ddos_plane < 0 || ddos_plane >= p))) {
    return -1;
  }
  std::vector<FamTable> fams(static_cast<size_t>(nf));
  std::vector<int32_t> perm, starts;
  std::vector<uint32_t> child_lanes;
  int32_t collided = 0;
  for (long long f = 0; f < nf; ++f) {
    long long par = parent[f];
    if (par >= f) return -1;  // parents precede children
    int64_t t_gather = ff_now_ns(stats);  // cascade regroup starts here
    const uint32_t* src_lanes;
    long long m, wk;
    const float* fsrc = nullptr;
    const FamTable* ptab = nullptr;
    if (par < 0) {
      src_lanes = lanes;
      m = n;
      wk = w;
      fsrc = vals;
    } else {
      const FamTable& pt = fams[static_cast<size_t>(par)];
      wk = sel_off[f + 1] - sel_off[f];
      if (wk < 1) return -1;
      const int64_t* csel = sel + sel_off[f];
      for (long long c = 0; c < wk; ++c) {
        // a lane index past the parent's key width would read (and feed
        // the in-place sketch update) out-of-bounds memory — reject the
        // plan before any state is touched
        if (csel[c] < 0 || csel[c] >= pt.wk) return -1;
      }
      m = pt.g;
      child_lanes.resize(static_cast<size_t>(m * wk));
      ff_parallel_rows(m, fold_threads(m, threads),
                       [&](long long rlo, long long rhi) {
        for (long long r = rlo; r < rhi; ++r) {
          for (long long c = 0; c < wk; ++c) {
            child_lanes[static_cast<size_t>(r * wk + c)] =
                pt.keys[static_cast<size_t>(r * pt.wk + csel[c])];
          }
        }
      });
      src_lanes = child_lanes.data();
      ptab = &pt;
    }
    if (m == 0) {
      fams[static_cast<size_t>(f)].g = 0;
      fams[static_cast<size_t>(f)].wk = wk;
      continue;
    }
    // phase attribution: the root family's grouping is the radix/refine
    // phases (fpt_hash_group self-reports them); a cascade child's
    // whole pass — lane gather above + grouping + fold — is "regroup"
    bool is_root = par < 0;
    long long g = group_lanes(src_lanes, m, wk, perm, starts, &collided,
                              threads, is_root ? stats : nullptr);
    if (g < 0) return -1;
    // collisions merge hash-identical tuples — the sketch families'
    // documented exact=False trade (ops.hostgroup.group_by_key)
    int64_t t_fold = ff_now_ns(stats);
    accumulate(src_lanes, m, wk, p, fsrc, ptab, perm, starts, g,
               threads, fams[static_cast<size_t>(f)]);
    if (stats != nullptr) {
      if (is_root) {
        stats[FF_STAT_FOLD_NS] += ff_now_ns(stats) - t_fold;
      } else {
        stats[FF_STAT_REGROUP_NS] += ff_now_ns(stats) - t_gather;
        stats[FF_STAT_GROUPS] += g;
      }
    }
    if (do_sketch) {
      int inv = finv != nullptr && finv[f];
      long long rc = sketch_family(
          fams[static_cast<size_t>(f)], p, fdepth[f], fwidth[f], fcap[f],
          fconserv[f], fprefilter[f], fplain[f], inv,
          static_cast<uint64_t*>(cms_ptrs[f]),
          inv ? nullptr : static_cast<uint32_t*>(tkey_ptrs[f]),
          inv ? nullptr : static_cast<float*>(tval_ptrs[f]),
          inv ? static_cast<uint64_t*>(inv_ks_ptrs[f]) : nullptr,
          inv ? static_cast<uint64_t*>(inv_kc_ptrs[f]) : nullptr,
          threads, stats);
      if (rc < 0) return -1;
    }
  }
  if (ddos_parent < 0) return 0;
  // DDoS per-dst side table: one more cascade regroup, surfaced to the
  // caller because its consumer (the jitted _accumulate_grouped) stays
  // on the XLA step.
  const FamTable& pt = fams[static_cast<size_t>(ddos_parent)];
  for (long long c = 0; c < ddos_sel_w; ++c) {
    if (ddos_sel[c] < 0 || ddos_sel[c] >= pt.wk) return -1;
  }
  if (pt.g == 0) return 0;
  int64_t t_ddos = ff_now_ns(stats);
  child_lanes.resize(static_cast<size_t>(pt.g * ddos_sel_w));
  ff_parallel_rows(pt.g, fold_threads(pt.g, threads),
                   [&](long long rlo, long long rhi) {
    for (long long r = rlo; r < rhi; ++r) {
      for (long long c = 0; c < ddos_sel_w; ++c) {
        child_lanes[static_cast<size_t>(r * ddos_sel_w + c)] =
            pt.keys[static_cast<size_t>(r * pt.wk + ddos_sel[c])];
      }
    }
  });
  long long g = group_lanes(child_lanes.data(), pt.g, ddos_sel_w, perm,
                            starts, &collided, threads, nullptr);
  if (g < 0) return -1;
  ff_parallel_rows(g, fold_threads(pt.g, threads),
                   [&](long long glo, long long ghi) {
    for (long long gi = glo; gi < ghi; ++gi) {
      long long lo = starts[static_cast<size_t>(gi)];
      long long hi =
          gi + 1 < g ? starts[static_cast<size_t>(gi + 1)] : pt.g;
      std::memcpy(
          ddos_keys_out + gi * ddos_sel_w,
          child_lanes.data() +
              static_cast<long long>(perm[lo]) * ddos_sel_w,
          static_cast<size_t>(ddos_sel_w) * sizeof(uint32_t));
      double acc = 0.0;
      for (long long r = lo; r < hi; ++r) {
        acc += pt.vsum[static_cast<size_t>(
            static_cast<long long>(perm[static_cast<size_t>(r)]) * p +
            ddos_plane)];
      }
      ddos_sums_out[gi] = static_cast<float>(acc);
    }
  });
  if (stats != nullptr) {
    stats[FF_STAT_REGROUP_NS] += ff_now_ns(stats) - t_ddos;
  }
  return g;
}

// ---- native lane building off the decoded columns (r19 flowspeed) ---------
//
// The fused prepare half previously built its [n, W] uint32 key lanes
// and [n, P] value planes in numpy: one saturation copy PER LANE
// (np.minimum over the u64 columns) plus the buffer fill — measured as
// the residual host_group share after the r16 prealloc rewrite proved
// the concat was not the cost. These two kernels consume the decoded
// columns (the exact buffers flow_decode_stream wrote) and emit the
// lane layouts in ONE threaded pass each; the numpy builders
// (engine/hostfused.py _key_lanes_into / _value_planes_np / the wagg
// lane fill) stay as the bit-exact twins and the fallback when these
// symbols are absent. Saturation, u32->f32 rounding and the f32 scale
// multiply all match the numpy twins bit-for-bit:
// (float)uint32 is round-to-nearest in both, and the slot transform
// (v - v % mod) runs on the saturated u32 exactly like _wagg_rows.

// Build [n, wtotal] uint32 lanes from `ncols` decoded columns.
//   cols[c]:   [n] uint32, [n] uint64 (is64[c]) or [n, widths[c]]
//              uint32 words (address columns, widths[c] == 4)
//   is64[c]:   column is uint64 (saturates at U32_MAX; width-1 only)
//   widths[c]: lanes this column contributes (1 or 4)
//   mods[c]:   0, or the wagg slot transform v -> v - v % mods[c]
//              applied AFTER saturation (width-1 only)
// Returns 0, or -1 on degenerate shapes / an inconsistent layout.
long long fpt_ff_build_lanes(const void** cols, const uint8_t* is64,
                         const int64_t* widths, const uint32_t* mods,
                         long long ncols, long long n, long long wtotal,
                         uint32_t* out, int threads, int64_t* stats) {
  if (n < 0 || ncols < 1 || wtotal < 1) return -1;
  long long sum_w = 0;
  for (long long c = 0; c < ncols; ++c) {
    long long wc = widths[c];
    if (wc != 1 && wc != 4) return -1;
    if (wc != 1 && (is64[c] || (mods != nullptr && mods[c]))) return -1;
    sum_w += wc;
  }
  if (sum_w != wtotal) return -1;
  if (n == 0) return 0;
  int64_t t0 = ff_now_ns(stats);
  ff_parallel_rows(n, fold_threads(n, threads),
                   [&](long long lo, long long hi) {
    long long off = 0;
    for (long long c = 0; c < ncols; ++c) {
      long long wc = widths[c];
      if (wc == 4) {
        const uint32_t* src = static_cast<const uint32_t*>(cols[c]);
        for (long long r = lo; r < hi; ++r) {
          std::memcpy(out + r * wtotal + off, src + r * 4,
                      4 * sizeof(uint32_t));
        }
      } else if (is64[c]) {
        const uint64_t* src = static_cast<const uint64_t*>(cols[c]);
        uint32_t mod = mods != nullptr ? mods[c] : 0;
        for (long long r = lo; r < hi; ++r) {
          uint64_t v = src[r];
          uint32_t s = v > 0xFFFFFFFFull ? 0xFFFFFFFFu
                                         : static_cast<uint32_t>(v);
          out[r * wtotal + off] = mod ? s - s % mod : s;
        }
      } else {
        const uint32_t* src = static_cast<const uint32_t*>(cols[c]);
        uint32_t mod = mods != nullptr ? mods[c] : 0;
        for (long long r = lo; r < hi; ++r) {
          uint32_t s = src[r];
          out[r * wtotal + off] = mod ? s - s % mod : s;
        }
      }
      off += wc;
    }
  });
  if (stats != nullptr) {
    stats[FF_STAT_LANES_NS] += ff_now_ns(stats) - t0;
  }
  return 0;
}

// Build [n, p] value planes from `p` SCALAR decoded columns: float32
// planes with the optional sampling-rate scale (out_f32 != NULL — the
// sketch families' layout), or exact uint64 planes saturated at
// U32_MAX (out_u64 != NULL — the wagg/flows_5m layout; scale must be
// NULL there, matching _wagg_rows). Exactly one output must be set.
// Returns 0, or -1 on degenerate shapes.
long long fpt_ff_build_planes(const void** cols, const uint8_t* is64,
                          long long p, long long n, const void* scale,
                          int scale_is64, float* out_f32,
                          uint64_t* out_u64, int threads,
                          int64_t* stats) {
  if (n < 0 || p < 1) return -1;
  if ((out_f32 == nullptr) == (out_u64 == nullptr)) return -1;
  if (out_u64 != nullptr && scale != nullptr) return -1;
  if (n == 0) return 0;
  int64_t t0 = ff_now_ns(stats);
  auto sat = [](const void* col, int c64, long long r) -> uint32_t {
    if (c64) {
      uint64_t v = static_cast<const uint64_t*>(col)[r];
      return v > 0xFFFFFFFFull ? 0xFFFFFFFFu : static_cast<uint32_t>(v);
    }
    return static_cast<const uint32_t*>(col)[r];
  };
  ff_parallel_rows(n, fold_threads(n, threads),
                   [&](long long lo, long long hi) {
    if (out_u64 != nullptr) {
      for (long long c = 0; c < p; ++c) {
        for (long long r = lo; r < hi; ++r) {
          out_u64[r * p + c] =
              static_cast<uint64_t>(sat(cols[c], is64[c], r));
        }
      }
      return;
    }
    for (long long c = 0; c < p; ++c) {
      for (long long r = lo; r < hi; ++r) {
        out_f32[r * p + c] =
            static_cast<float>(sat(cols[c], is64[c], r));
      }
    }
    if (scale != nullptr) {
      // max(rate, 1) in f32 then one f32 multiply per cell — the same
      // rounding sequence as _value_planes_np's `planes * r[:, None]`
      for (long long r = lo; r < hi; ++r) {
        float f = static_cast<float>(sat(scale, scale_is64, r));
        if (f < 1.0f) f = 1.0f;
        float* row = out_f32 + r * p;
        for (long long c = 0; c < p; ++c) row[c] *= f;
      }
    }
  });
  if (stats != nullptr) {
    stats[FF_STAT_LANES_NS] += ff_now_ns(stats) - t0;
  }
  return 0;
}

}  // extern "C"
