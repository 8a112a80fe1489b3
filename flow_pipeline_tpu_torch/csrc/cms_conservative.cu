// Conservative count-min update for Hopper (sm_90a).
//
// Replaces the TPU kernel flow_pipeline_tpu/ops/cms_pallas.py:_max_kernel
// (cms_add_conservative_pallas). It computes the same function as the
// plain version ops/cms.py cms_add_conservative:
//
//   target[n, p] = min_d counts[p, d, b_d(key n)] + vals[n, p]
//                  (read from the PRE-update sketch; 0 for invalid rows)
//   counts[p, d, b] = max(counts[p, d, b], max of target over keys in b)
//
// and, in its estimate form, what ops/cms.py cms_query then reads from
// the updated sketch: est[n, p] = min_d counts[p, d, b_d(key n)], for
// every row, padding included.
//
// The TPU design (a one-hot [chunk, tile] mask and a masked max-reduce
// per width tile) exists only because scatters serialize on the TPU. Here
// the scatter is native, and the whole update is ONE cooperative launch
// (csrc/cms_kernel.cuh):
//
//   1. Each block stages its tile's key slab into shared memory, each
//      thread mixes its key's words once and hashes the D buckets
//      (csrc/cms_hash.cuh), gathers the D cells of each plane from the
//      pre-update sketch and forms its targets.
//   2. grid.sync(): every target has read the pre-update sketch, so no
//      write can leak into an estimate.
//   3. atomicMax of the target on the cell's int32 bit pattern, issued
//      only where the target exceeds the pre-update cell the thread read
//      (cells never decrease, so a skipped max could not have raised the
//      cell). Cells and targets are >= +0.0, and for non-negative floats
//      the integer order of the bits is the float order. Max is
//      order-free, so the result is bit-exact at any size.
//   4. Estimate form only: grid.sync(), then each row's min over the
//      updated cells, read through L2.
//
// The update is IN PLACE on counts (the JAX op is functional); callers
// must not keep an older reference to the sketch across an update.
//
// Cost: bound by bytes and by latency. At the main path's shapes
// (N = 32768 keys, Wk = 11 lanes, P = 3 planes, D = 4 rows, W = 65536)
// the function moves about 3.4 MB: the keys, values and mask once, a read
// of the cells the keys touch and a write of the cells that change. A
// single wave of 128 blocks carries two dependent gathers and one or two
// grid barriers, so latency, not bandwidth, sets the kernel's time.
#include "cms_kernel.cuh"

template <int WK, int D, int P, bool EST, bool REG>
__global__ void __launch_bounds__(fpt::kThreads, 1)
    fpt_cms_conservative_kernel(fpt::CmsArgs a) {
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

    // register route: this thread's row, its buckets, pre-update cells
    // and targets, kept across the barriers
    int32_t b[MD];
    float cell[MD][MP];
    float tgt[MP];
    int row = -1;
    bool live = false;

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
                        float m = 0.0f;
                        FPT_UNROLL
                        for (int r = 0; r < MD; ++r) {
                            if (r < d) {
                                const float c = *cell_ptr(a, q, r, d, b[r]);
                                if (REG) cell[r][q] = c;
                                m = r == 0 ? c : fminf(m, c);
                            }
                        }
                        tgt[q] = m + a.vals[(size_t)i * p + q];
                    }
                }
            }
            if (!REG) {
                if (ok || EST) {
                    FPT_UNROLL
                    for (int r = 0; r < MD; ++r)
                        if (r < d) a.buckets[(size_t)r * n + i] = b[r];
                }
                if (ok) {
                    FPT_UNROLL
                    for (int q = 0; q < MP; ++q)
                        if (q < p) a.target[(size_t)i * p + q] = tgt[q];
                }
            }
            row = i;
            live = ok;
        }
        __syncthreads();  // the next tile restages the slab
    }

    cg::grid_group grid = cg::this_grid();
    grid.sync();  // every target has read the pre-update sketch

    if (REG) {
        if (live) {
            FPT_UNROLL
            for (int q = 0; q < MP; ++q) {
                FPT_UNROLL
                for (int r = 0; r < MD; ++r) {
                    if (q < p && r < d && tgt[q] > cell[r][q])
                        atomicMax((int*)cell_ptr(a, q, r, d, b[r]),
                                  __float_as_int(tgt[q]));
                }
            }
        }
    } else {
        for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
             i += gridDim.x * kThreads) {
            if (!a.valid[i]) continue;
            int32_t bb[MD];
            FPT_UNROLL
            for (int r = 0; r < MD; ++r)
                bb[r] = r < d ? __ldcg(a.buckets + (size_t)r * n + i) : 0;
            FPT_UNROLL
            for (int q = 0; q < MP; ++q) {
                if (q < p) {
                    const float t = __ldcg(a.target + (size_t)i * p + q);
                    FPT_UNROLL
                    for (int r = 0; r < MD; ++r) {
                        if (r < d) {
                            // a cell read now is >= its pre-update value,
                            // so the skip stays exact
                            float* c = cell_ptr(a, q, r, d, bb[r]);
                            if (t > __ldcg(c))
                                atomicMax((int*)c, __float_as_int(t));
                        }
                    }
                }
            }
        }
    }

    if (EST) {
        grid.sync();  // every max has landed
        estimate_phase<MD, MP, REG>(a, row, b, d, p);
    }
}

template <int WK, int D, int P>
static const void* conservative_kernel(bool est, bool reg) {
    if (est)
        return reg ? (const void*)fpt_cms_conservative_kernel<WK, D, P, true,
                                                              true>
                   : (const void*)fpt_cms_conservative_kernel<WK, D, P, true,
                                                              false>;
    return reg ? (const void*)fpt_cms_conservative_kernel<WK, D, P, false,
                                                          true>
               : (const void*)fpt_cms_conservative_kernel<WK, D, P, false,
                                                          false>;
}

static const void* select_conservative(int wk, int d, int p, bool est,
                                       bool reg) {
    FPT_DISPATCH(conservative_kernel, wk, d, p, est, reg);
}

// Rows the register route can take in one launch (resident blocks of its
// kernel times kThreads). The wrapper allocates scratch above this.
extern "C" int fpt_cms_conservative_resident_rows(int wk, int d, int p,
                                                  int est, int* rows) {
    if (!fpt::args_ok(4, 0, wk, p, d, 1)) return (int)cudaErrorInvalidValue;
    int blocks = 0;
    cudaError_t err = fpt::resident_blocks(
        select_conservative(wk, d, p, est != 0, true), &blocks);
    *rows = blocks * fpt::kThreads;
    return (int)err;
}

// One cooperative launch. No scratch (buckets == target == null): the
// register route, one thread per row; its grid must fit on the card at
// once, or the launch is refused. With scratch ([D, N] int32 buckets and
// [N, P] f32 targets): the resident grid loops over the rows. est: null
// for the update alone, else [N, P] f32 written with the post-update
// estimates.
extern "C" int fpt_cms_conservative(void* counts, const void* keys,
                                    int key_bytes, const void* vals,
                                    const void* valid, int n, int wk, int p,
                                    int d, int width, void* est,
                                    void* buckets, void* target,
                                    void* stream) {
    if (!fpt::args_ok(key_bytes, n, wk, p, d, width) ||
        (buckets == nullptr) != (target == nullptr))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const bool reg = buckets == nullptr;
    const void* fn = select_conservative(wk, d, p, est != nullptr, reg);
    const int ntiles = (n + fpt::kThreads - 1) / fpt::kThreads;
    int blocks = ntiles;
    if (!reg) {
        cudaError_t err = fpt::resident_blocks(fn, &blocks);
        if (err != cudaSuccess) return (int)err;
        blocks = blocks < ntiles ? blocks : ntiles;
    }
    fpt::CmsArgs a{(float*)counts, (const char*)keys, key_bytes / 4,
                   (const float*)vals, (const uint8_t*)valid, n, wk, p, d,
                   width, (float*)est, (int32_t*)buckets, (float*)target};
    return fpt::launch(fn, blocks, a, (cudaStream_t)stream);
}

extern "C" const char* fpt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
