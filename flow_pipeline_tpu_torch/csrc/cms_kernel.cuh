// What the two count-min kernels share: their arguments, the staging of a
// block's key rows into shared memory, and the cooperative launch.
//
// Both kernels are ONE cooperative launch (cudaLaunchCooperativeKernel)
// whose grid is at most the blocks the card can hold at once, so
// cooperative_groups' grid.sync() is a grid-wide barrier between phases.
// Each block takes tiles of kThreads consecutive key rows. A tile's rows
// are one contiguous slab of keys (kThreads * Wk * 8 bytes with int64
// carriers: 22.5 KB at Wk = 11), copied into shared memory in one
// coalesced transfer before any thread hashes its row.
//
// Two routes, chosen by the wrapper from the row count:
//   - register route: the grid covers every row with one thread each
//     (N <= resident threads; N = 32,768 always is), and a thread keeps
//     its key's buckets, cells and targets in registers across barriers;
//   - scratch route: the grid is the resident block count, blocks loop
//     over tiles, and per-row state crosses a barrier through scratch
//     that the wrapper allocates.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "cms_hash.cuh"

namespace fpt {

namespace cg = cooperative_groups;

// Threads per block. The kernels declare __launch_bounds__(kThreads, 1):
// one resident block per SM is all the register route needs (N = 32,768
// rows is 128 blocks on 132 SMs), so ptxas has no reason to trade
// registers for occupancy with spills.
constexpr int kThreads = 256;
constexpr int kMaxWk = 16;
constexpr int kMaxD = 8;
constexpr int kMaxP = 8;

struct CmsArgs {
    float* counts;  // [P, D, W], read and written: never const/__restrict__
    const char* keys;  // [N, Wk] int32 or int64 carriers of u32 words
    int key_words;     // 32-bit words per key lane: 1 (int32) or 2 (int64)
    const float* vals;     // [N, P]
    const uint8_t* valid;  // [N]
    int n, wk, p, d, width;
    float* est;        // [N, P] post-update estimates, or null
    int32_t* buckets;  // scratch route: [D, N]
    float* target;     // scratch route, conservative: [N, P]
};

// Shared memory of one block: a tile's raw key slab and the mbarrier
// that the TMA bulk copy completes.
template <int MAXW>
struct Slab {
    alignas(128) uint32_t words[kThreads * MAXW * 2];
    alignas(8) uint64_t bar;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void slab_init(uint64_t* bar) {
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         smem_addr(bar))
                     : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
}

// Copy `bytes` of key rows at `src` into the block's slab and return when
// every thread can read them. A 1-D TMA bulk copy where the address and
// size are multiples of 16 B (one thread issues it, the mbarrier counts
// the bytes in); otherwise, as for a ragged last tile, coalesced loads by
// the whole block, 16 B a thread where aligned. The bulk copy measured
// 0.15-0.27 us faster per launch than the loads at the main path's shapes
// (tools/cms_split.py on an H100). The caller syncs the block before the
// slab is staged again.
__device__ __forceinline__ void stage_rows(uint32_t* dst, uint64_t* bar,
                                           uint32_t& phase, const char* src,
                                           int bytes) {
    if (((((uintptr_t)src) | (uintptr_t)bytes) & 15) == 0) {
        if (threadIdx.x == 0) {
            // order earlier generic reads of the slab before the async
            // proxy's writes
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            asm volatile(
                "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                    "r"(smem_addr(bar)),
                "r"(bytes)
                : "memory");
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
                "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
                "l"(src), "r"(bytes), "r"(smem_addr(bar))
                : "memory");
        }
        uint32_t done = 0;
        do {
            asm volatile(
                "{\n .reg .pred p;\n"
                " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                " selp.u32 %0, 1, 0, p;\n}\n"
                : "=r"(done)
                : "r"(smem_addr(bar)), "r"(phase)
                : "memory");
        } while (!done);
        phase ^= 1u;
        return;
    }
    const int nvec = (((uintptr_t)src) & 15) ? 0 : bytes >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < nvec; i += kThreads) d4[i] = s4[i];
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    for (int i = nvec * 4 + threadIdx.x; i < (bytes >> 2); i += kThreads)
        dst[i] = s[i];
    __syncthreads();
}

// Mix the words of the slab's row t (the low word of each carrier).
template <int MAXW>
__device__ __forceinline__ void load_mixed(const uint32_t* slab, int t,
                                           int wk, int key_words,
                                           uint32_t (&k)[MAXW]) {
    FPT_UNROLL
    for (int j = 0; j < MAXW; ++j)
        k[j] = j < wk ? fpt_mix_word(slab[(t * wk + j) * key_words]) : 0u;
}

// Cell (plane q, row r, bucket b) of the [P, D, W] sketch.
__device__ __forceinline__ float* cell_ptr(const CmsArgs& a, int q, int r,
                                           int d, int32_t b) {
    return a.counts + ((size_t)q * d + r) * (size_t)a.width + b;
}

// est[i, q] = min over rows of the UPDATED sketch's cells, read through L2
// (__ldcg): after a grid barrier, other blocks' atomics are in L2 and a
// line this SM's L1 kept from before the barrier would be stale.
template <int MD, int MP>
__device__ __forceinline__ void write_estimate(const CmsArgs& a, int i,
                                               const int32_t (&b)[MD], int d,
                                               int p) {
    FPT_UNROLL
    for (int q = 0; q < MP; ++q) {
        if (q < p) {
            float m = __ldcg(cell_ptr(a, q, 0, d, b[0]));
            FPT_UNROLL
            for (int r = 1; r < MD; ++r)
                if (r < d) m = fminf(m, __ldcg(cell_ptr(a, q, r, d, b[r])));
            a.est[(size_t)i * p + q] = m;
        }
    }
}

// The estimate phase, after the grid barrier that follows the update:
// every row, padding included, as cms_query computes it. The register
// route's thread holds its row's buckets; the scratch route reads them
// back for each of its rows.
template <int MD, int MP, bool REG>
__device__ __forceinline__ void estimate_phase(const CmsArgs& a, int row,
                                               const int32_t (&b)[MD], int d,
                                               int p) {
    if (REG) {
        if (row >= 0) write_estimate<MD, MP>(a, row, b, d, p);
        return;
    }
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.n;
         i += gridDim.x * kThreads) {
        int32_t bb[MD];
        FPT_UNROLL
        for (int r = 0; r < MD; ++r)
            bb[r] = r < d ? __ldcg(a.buckets + (size_t)r * a.n + i) : 0;
        write_estimate<MD, MP>(a, i, bb, d, p);
    }
}

// Blocks of `fn` (kThreads threads, static shared memory only) that the
// current device can hold at once, queried once per device and kernel.
inline cudaError_t resident_blocks(const void* fn, int* blocks) {
    struct Entry {
        int dev;
        const void* fn;
        int blocks;
    };
    static std::mutex mu;
    static Entry cache[512];
    static int used = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i) {
        if (cache[i].dev == dev && cache[i].fn == fn) {
            *blocks = cache[i].blocks;
            return cudaSuccess;
        }
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    *blocks = per_sm * sms;
    if (used < 512) cache[used++] = Entry{dev, fn, *blocks};
    return cudaSuccess;
}

// One cooperative launch of `fn` over `blocks` blocks. Any refusal
// (cudaErrorCooperativeLaunchTooLarge among them) is returned and cleared
// from the runtime's last-error slot, so it cannot resurface in a later
// call.
inline int launch(const void* fn, int blocks, CmsArgs a, cudaStream_t s) {
    void* params[] = {&a};
    cudaError_t err = cudaLaunchCooperativeKernel(
        fn, dim3(blocks), dim3(kThreads), params, 0, s);
    cudaError_t last = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : last);
}

inline bool args_ok(int key_bytes, int n, int wk, int p, int d, int width) {
    return (key_bytes == 4 || key_bytes == 8) && n >= 0 && wk >= 1 &&
           wk <= kMaxWk && d >= 1 && d <= kMaxD && p >= 1 && p <= kMaxP &&
           width >= 1 && (long long)n * d < (1LL << 31) &&
           (long long)n * p < (1LL << 31);
}

}  // namespace fpt

// Instantiate PICK<WK, 4, 3> for the main path's shape (D = 4 rows, P = 3
// planes) with Wk = 1..16 as a template argument, and PICK<0, 0, 0> (the
// key width, depth and planes read at run time) for any other shape.
#define FPT_DISPATCH(PICK, wk, d, p, ...)                             \
    do {                                                              \
        if ((d) == 4 && (p) == 3) {                                   \
            switch (wk) {                                             \
                case 1: return PICK<1, 4, 3>(__VA_ARGS__);            \
                case 2: return PICK<2, 4, 3>(__VA_ARGS__);            \
                case 3: return PICK<3, 4, 3>(__VA_ARGS__);            \
                case 4: return PICK<4, 4, 3>(__VA_ARGS__);            \
                case 5: return PICK<5, 4, 3>(__VA_ARGS__);            \
                case 6: return PICK<6, 4, 3>(__VA_ARGS__);            \
                case 7: return PICK<7, 4, 3>(__VA_ARGS__);            \
                case 8: return PICK<8, 4, 3>(__VA_ARGS__);            \
                case 9: return PICK<9, 4, 3>(__VA_ARGS__);            \
                case 10: return PICK<10, 4, 3>(__VA_ARGS__);          \
                case 11: return PICK<11, 4, 3>(__VA_ARGS__);          \
                case 12: return PICK<12, 4, 3>(__VA_ARGS__);          \
                case 13: return PICK<13, 4, 3>(__VA_ARGS__);          \
                case 14: return PICK<14, 4, 3>(__VA_ARGS__);          \
                case 15: return PICK<15, 4, 3>(__VA_ARGS__);          \
                case 16: return PICK<16, 4, 3>(__VA_ARGS__);          \
                default: break;                                       \
            }                                                         \
        }                                                             \
        return PICK<0, 0, 0>(__VA_ARGS__);                            \
    } while (0)
