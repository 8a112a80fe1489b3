// Shared spawn-and-join task helpers for libflowdecode's threaded
// kernels — ONE definition of the work-stealing loop (hostsketch.cc
// grew it first; the r19 threaded fused pass needs it from
// flowfused.cc and flowdecode.cc too, and three private copies would
// drift).
//
// Contract (the determinism story every caller leans on): tasks must
// write DISJOINT data — (plane, depth) sketch rows, group-index
// ranges, row blocks — so thread interleaving can only change the
// ORDER disjoint writes land, never a value. Workers are spawned per
// call and joined before return: no persistent pool to leak or race,
// and the caller's stats buffer is only ever touched by the calling
// thread after the join.
#ifndef FLOWTPU_FFPAR_H_
#define FLOWTPU_FFPAR_H_

#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>

// Work-stealing task loop: runs fn(t) for t in [0, n_tasks) across up
// to `threads` workers; serial when threads <= 1 or there is at most
// one task. Tasks must write disjoint data.
template <typename F>
inline void ff_parallel_tasks(long long n_tasks, int threads, F fn) {
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

// Row-block task shape for per-row work: fn(lo, hi) over contiguous
// row ranges. Block size 2048 matches the hostsketch engine's row
// tasks (big enough to amortize the steal, small enough to balance).
constexpr long long kFfRowBlock = 2048;

inline long long ff_n_blocks(long long n) {
  return (n + kFfRowBlock - 1) / kFfRowBlock;
}

template <typename F>
inline void ff_parallel_rows(long long n, int threads, F fn) {
  ff_parallel_tasks(ff_n_blocks(n), threads, [&](long long blk) {
    long long lo = blk * kFfRowBlock;
    long long hi = std::min(n, lo + kFfRowBlock);
    fn(lo, hi);
  });
}

#endif  // FLOWTPU_FFPAR_H_
