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
// The TPU design (a one-hot [chunk, tile] mask and a masked max-reduce
// per width tile) exists only because scatters serialize on the TPU. Here
// the scatter is native: two launches on one stream.
//
//   1. fpt_cms_target_kernel, one thread per key: hash the key's lanes in
//      registers (csrc/cms_hash.cuh), gather the D cells per plane, write
//      the buckets [D, N] int32 and the target [N, P] to scratch.
//   2. fpt_cms_scatter_max_kernel, one thread per (key, depth): atomicMax
//      of the target into the cell.
//
// The phases stay two launches: stream order is the grid-wide barrier
// that keeps every estimate on the pre-update sketch. Fused into one
// launch, early writes would leak into later estimates and the result
// would depend on block scheduling.
//
// atomicMax works on the int32 bit pattern: cells and targets are
// >= +0.0, and for non-negative floats the integer order of the bits is
// the float order. Max is order-free, so the result is bit-exact against
// the plain version at any size, not only below 2^24.
//
// The update is IN PLACE on counts (the JAX op is functional); callers
// must not keep an older reference to the sketch across an update.
//
// Cost: memory- and atomic-bound. At the main path's shapes (N = 32768
// keys, Wk = 11 lanes, P = 3 planes, D = 4 rows, W = 65536) it moves
// about 5 MB: the keys, values and mask once, and a read and a write of
// the 393,216 cells the keys touch. At that size launch overhead
// dominates; making it fast is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cms_hash.cuh"

#define FPT_MAX_WK 16
#define FPT_MAX_D 8
#define FPT_MAX_P 8

template <typename K>
__global__ void fpt_cms_target_kernel(const float* __restrict__ counts,
                                      const K* __restrict__ keys,
                                      const float* __restrict__ vals,
                                      const uint8_t* __restrict__ valid,
                                      int n, int wk, int p, int d, int width,
                                      int32_t* __restrict__ buckets,
                                      float* __restrict__ target) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if (!valid[i]) {
        for (int q = 0; q < p; ++q) target[(size_t)i * p + q] = 0.0f;
        return;
    }
    uint32_t w[FPT_MAX_WK];
    for (int j = 0; j < wk; ++j) w[j] = (uint32_t)keys[(size_t)i * wk + j];
    int32_t b[FPT_MAX_D];
    for (int r = 0; r < d; ++r) {
        b[r] = fpt_cms_bucket(w, wk, r, width);
        buckets[(size_t)r * n + i] = b[r];
    }
    for (int q = 0; q < p; ++q) {
        const float* plane = counts + (size_t)q * d * width;
        float est = plane[b[0]];
        for (int r = 1; r < d; ++r)
            est = fminf(est, plane[(size_t)r * width + b[r]]);
        target[(size_t)i * p + q] = est + vals[(size_t)i * p + q];
    }
}

__global__ void fpt_cms_scatter_max_kernel(float* __restrict__ counts,
                                           const int32_t* __restrict__ buckets,
                                           const float* __restrict__ target,
                                           const uint8_t* __restrict__ valid,
                                           int n, int p, int d, int width) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)n * d) return;
    int i = (int)(t % n);  // consecutive threads: consecutive keys, one row
    int r = (int)(t / n);
    if (!valid[i]) return;
    int32_t b = buckets[(size_t)r * n + i];
    for (int q = 0; q < p; ++q) {
        float v = target[(size_t)i * p + q];
        if (v > 0.0f) {  // a 0 target never raises a cell (cells >= 0)
            int* cell = (int*)(counts + ((size_t)q * d + r) * width + b);
            atomicMax(cell, __float_as_int(v));
        }
    }
}

extern "C" int fpt_cms_add_conservative(void* counts, const void* keys,
                                        int key_bytes, const void* vals,
                                        const void* valid, int n, int wk,
                                        int p, int d, int width,
                                        void* buckets, void* target,
                                        void* stream) {
    if (n <= 0) return 0;
    if (wk < 1 || wk > FPT_MAX_WK || d < 1 || d > FPT_MAX_D || p < 1 ||
        p > FPT_MAX_P || width < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    int blocks = (n + threads - 1) / threads;
    if (key_bytes == 8) {
        fpt_cms_target_kernel<int64_t><<<blocks, threads, 0, s>>>(
            (const float*)counts, (const int64_t*)keys, (const float*)vals,
            (const uint8_t*)valid, n, wk, p, d, width, (int32_t*)buckets,
            (float*)target);
    } else if (key_bytes == 4) {
        fpt_cms_target_kernel<int32_t><<<blocks, threads, 0, s>>>(
            (const float*)counts, (const int32_t*)keys, (const float*)vals,
            (const uint8_t*)valid, n, wk, p, d, width, (int32_t*)buckets,
            (float*)target);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    long long total = (long long)n * d;
    int blocks2 = (int)((total + threads - 1) / threads);
    fpt_cms_scatter_max_kernel<<<blocks2, threads, 0, s>>>(
        (float*)counts, (const int32_t*)buckets, (const float*)target,
        (const uint8_t*)valid, n, p, d, width);
    return (int)cudaGetLastError();
}

extern "C" const char* fpt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
