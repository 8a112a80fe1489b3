// flowtrace stats out-struct: the one shared definition of the slot
// layout and the timing helper, included by every translation unit of
// libflowdecode (flowdecode.cc, hostsketch.cc, flowfused.cc) so phase
// indices cannot drift between kernels. The Python mirror is
// FF_STAT_SLOTS in flow_pipeline_tpu_torch/native/__init__.py.
//
// Contract: every groupby/sketch kernel takes an OPTIONAL trailing
// `int64_t* stats` (NULL = no collection): a caller-zeroed
// int64[kFfStatsLen] the kernel ACCUMULATES (+=) per-phase wall
// nanoseconds and row/group counts into, so one buffer can ride a
// whole fused tree (or a chunk of staged engine calls) and come back
// as the phase breakdown the `host_fused` stage summary erased.
// Timing uses the steady clock and is only read when stats != NULL, so
// the NULL path costs one branch. Stats are written exclusively by the
// calling thread (worker threads inside hs_* join first) — no atomics
// needed, TSan-clean by construction.
#ifndef FLOWTPU_FFSTAT_H_
#define FLOWTPU_FFSTAT_H_

#include <chrono>
#include <cstdint>

enum FfStat {
  FF_STAT_RADIX_NS = 0,      // LSD radix passes incl. the row-hash pass
  FF_STAT_REFINE_NS = 1,     // run refinement + group boundary scan
  FF_STAT_REGROUP_NS = 2,    // cascade regroup: gather + group + fold
  FF_STAT_CMS_NS = 3,        // hs_cms_update
  FF_STAT_PREFILTER_NS = 4,  // hs_hh_prefilter
  FF_STAT_TOPK_NS = 5,       // hs_cms_query (admission) + hs_topk_merge
  FF_STAT_FOLD_NS = 6,       // root group-table accumulation
  FF_STAT_ROWS = 7,          // input rows seen (root families)
  FF_STAT_GROUPS = 8,        // groups produced (all families)
  FF_STAT_RADIX_PASSES = 9,  // radix passes executed
  FF_STAT_INV_NS = 10,       // hs_inv_update / hs_inv_decode (the
                             // invertible family's whole sketch fold —
                             // it has no cms/prefilter/topk phases)
  FF_STAT_LANES_NS = 11,     // ff_build_lanes / ff_build_planes: native
                             // lane building off the decoded columns
                             // (the r19 flowspeed attribution slot)
  FF_STAT_SPREAD_NS = 12,    // hs_spread_update (the flowspread
                             // distinct-count family's register fold)
};

constexpr int kFfStatsLen = 16;

inline int64_t ff_now_ns(const int64_t* stats) {
  if (stats == nullptr) return 0;
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

#endif  // FLOWTPU_FFSTAT_H_
