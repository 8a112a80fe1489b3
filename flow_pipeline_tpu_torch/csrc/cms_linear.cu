// Linear count-min update for Hopper (sm_90a).
//
// Replaces the TPU kernel flow_pipeline_tpu/ops/cms_pallas.py:_add_kernel
// (cms_add_pallas). It computes the same function as the plain version
// ops/cms.py cms_add:
//
//   counts[p, d, b_d(key n)] += vals[n, p]   for every depth row d
//                                            (invalid rows add nothing)
//
// and, in its estimate form, what ops/cms.py cms_query then reads from
// the updated sketch: est[n, p] = min_d counts[p, d, b_d(key n)], for
// every row, padding included.
//
// The TPU design (buckets hashed outside, then a one-hot [N, tile]
// matrix product per (depth, width tile)) exists only because scatters
// serialize on the TPU. Here the scatter is native: ONE cooperative
// launch (csrc/cms_kernel.cuh). Each block stages its tile's key slab
// into shared memory; each valid row mixes its words once, hashes its D
// buckets (csrc/cms_hash.cuh: murmur3 with seed d, h % W unsigned, the
// arithmetic of ops/cms.py cms_buckets) and does one f32 atomicAdd per
// (depth, plane). The estimate form adds a grid.sync() and each row's min
// over the updated cells, read through L2; the update alone has no
// barrier.
//
// The update is IN PLACE on counts (the JAX op is functional); callers
// must not keep an older reference to the sketch across an update.
//
// Exactness: atomicAdd adds in an order that changes from run to run.
// When the addends are integers and every cell's total stays below 2^24,
// every partial sum is exact and the result is bit-equal to the plain
// version; outside that envelope it agrees within float32 rounding
// (rtol 1e-6 at the main path's sizes).
//
// Cost: bound by bytes and by atomics. At the main path's shapes
// (N = 32768 keys, Wk = 11 lanes, P = 3 planes, D = 4 rows, W = 65536) it
// moves about 3.6 MB: the mask, the key words and values once, and a
// read-modify-write of every touched cell, in one wave of 128 blocks.
#include "cms_kernel.cuh"

template <int WK, int D, int P, bool EST, bool REG>
__global__ void __launch_bounds__(fpt::kThreads, 1)
    fpt_cms_linear_kernel(fpt::CmsArgs a) {
    using namespace fpt;
    constexpr int MW = WK ? WK : kMaxWk;
    constexpr int MD = D ? D : kMaxD;
    constexpr int MP = P ? P : kMaxP;
    const int wk = WK ? WK : a.wk;
    const int d = D ? D : a.d;
    const int p = P ? P : a.p;
    const int n = a.n;

    __shared__ Slab<MW> slab;
    slab_init(&slab.bar);
    uint32_t phase = 0;

    int32_t b[MD];  // register route: this thread's row and buckets
    int row = -1;

    const int row_bytes = wk * a.key_words * 4;
    const int ntiles = (n + kThreads - 1) / kThreads;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int row0 = tile * kThreads;
        const int rows = min(kThreads, n - row0);
        stage_rows(slab.words, &slab.bar, phase,
                   a.keys + (size_t)row0 * row_bytes, rows * row_bytes);
        const int i = row0 + threadIdx.x;
        if (threadIdx.x < rows) {
            const bool ok = a.valid[i] != 0;
            if (ok || EST) {
                uint32_t k[MW];
                load_mixed<MW>(slab.words, threadIdx.x, wk, a.key_words, k);
                FPT_UNROLL
                for (int r = 0; r < MD; ++r)
                    b[r] = r < d ? fpt_cms_bucket<MW>(k, wk, r, a.width) : 0;
            }
            if (ok) {
                FPT_UNROLL
                for (int q = 0; q < MP; ++q) {
                    if (q < p) {
                        const float v = a.vals[(size_t)i * p + q];
                        FPT_UNROLL
                        for (int r = 0; r < MD; ++r)
                            if (r < d)
                                atomicAdd(cell_ptr(a, q, r, d, b[r]), v);
                    }
                }
            }
            if (EST && !REG) {
                FPT_UNROLL
                for (int r = 0; r < MD; ++r)
                    if (r < d) a.buckets[(size_t)r * n + i] = b[r];
            }
            row = i;
        }
        __syncthreads();  // the next tile restages the slab
    }

    if (EST) {
        cg::this_grid().sync();  // every add has landed
        estimate_phase<MD, MP, REG>(a, row, b, d, p);
    }
}

template <int WK, int D, int P>
static const void* linear_kernel(bool est, bool reg) {
    if (!est)
        return (const void*)fpt_cms_linear_kernel<WK, D, P, false, false>;
    return reg ? (const void*)fpt_cms_linear_kernel<WK, D, P, true, true>
               : (const void*)fpt_cms_linear_kernel<WK, D, P, true, false>;
}

static const void* select_linear(int wk, int d, int p, bool est, bool reg) {
    FPT_DISPATCH(linear_kernel, wk, d, p, est, reg);
}

// Rows the estimate form's register route can take in one launch. The
// update alone needs no scratch at any size.
extern "C" int fpt_cms_linear_resident_rows(int wk, int d, int p,
                                            int* rows) {
    if (!fpt::args_ok(4, 0, wk, p, d, 1)) return (int)cudaErrorInvalidValue;
    int blocks = 0;
    cudaError_t err =
        fpt::resident_blocks(select_linear(wk, d, p, true, true), &blocks);
    *rows = blocks * fpt::kThreads;
    return (int)err;
}

// One cooperative launch. est null: the update alone, the resident grid
// looping over the rows. est [N, P] f32: the estimate form; with no
// scratch (buckets null) the register route, one thread per row, whose
// grid must fit on the card at once or the launch is refused; with
// [D, N] int32 bucket scratch the resident grid loops over the rows.
extern "C" int fpt_cms_linear(void* counts, const void* keys, int key_bytes,
                              const void* vals, const void* valid, int n,
                              int wk, int p, int d, int width, void* est,
                              void* buckets, void* stream) {
    if (!fpt::args_ok(key_bytes, n, wk, p, d, width) ||
        (est == nullptr && buckets != nullptr))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const bool reg = est != nullptr && buckets == nullptr;
    const void* fn = select_linear(wk, d, p, est != nullptr, reg);
    const int ntiles = (n + fpt::kThreads - 1) / fpt::kThreads;
    int blocks = ntiles;
    if (!reg) {
        cudaError_t err = fpt::resident_blocks(fn, &blocks);
        if (err != cudaSuccess) return (int)err;
        blocks = blocks < ntiles ? blocks : ntiles;
    }
    fpt::CmsArgs a{(float*)counts, (const char*)keys, key_bytes / 4,
                   (const float*)vals, (const uint8_t*)valid, n, wk, p, d,
                   width, (float*)est, (int32_t*)buckets, nullptr};
    return fpt::launch(fn, blocks, a, (cudaStream_t)stream);
}
