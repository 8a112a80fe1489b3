// Linear count-min update for Hopper (sm_90a).
//
// Replaces the TPU kernel flow_pipeline_tpu/ops/cms_pallas.py:_add_kernel
// (cms_add_pallas). It computes the same function as the plain version
// ops/cms.py cms_add:
//
//   counts[p, d, b_d(key n)] += vals[n, p]   for every depth row d
//                                            (invalid rows add nothing)
//
// The TPU design (buckets hashed outside, then a one-hot [N, tile]
// matrix product per (depth, width tile)) exists only because scatters
// serialize on the TPU. Here the scatter is native: ONE launch, one
// thread per key. An invalid row returns at once; a valid one hashes its
// lanes in registers (csrc/cms_hash.cuh: murmur3 with seed d, h % W
// unsigned, the arithmetic of ops/cms.py cms_buckets) and does one f32
// atomicAdd per (depth, plane). No scratch, no second pass.
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
// Cost: memory- and atomic-bound. At the main path's shapes (N = 32768
// keys, Wk = 11 lanes, P = 3 planes, D = 4 rows, W = 65536) it moves a
// few MB: the mask, the key words and values once, and a read-modify-write
// of every touched cell. At that size launch overhead dominates; making
// it fast is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cms_hash.cuh"

#define FPT_LIN_MAX_WK 16
#define FPT_LIN_MAX_D 8
#define FPT_LIN_MAX_P 8

template <typename K>
__global__ void fpt_cms_add_kernel(float* __restrict__ counts,
                                   const K* __restrict__ keys,
                                   const float* __restrict__ vals,
                                   const uint8_t* __restrict__ valid,
                                   int n, int wk, int p, int d, int width) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !valid[i]) return;
    uint32_t w[FPT_LIN_MAX_WK];
    for (int j = 0; j < wk; ++j) w[j] = (uint32_t)keys[(size_t)i * wk + j];
    float v[FPT_LIN_MAX_P];
    for (int q = 0; q < p; ++q) v[q] = vals[(size_t)i * p + q];
    for (int r = 0; r < d; ++r) {
        int32_t b = fpt_cms_bucket(w, wk, r, width);
        for (int q = 0; q < p; ++q)
            atomicAdd(counts + ((size_t)q * d + r) * width + b, v[q]);
    }
}

extern "C" int fpt_cms_add(void* counts, const void* keys, int key_bytes,
                           const void* vals, const void* valid, int n,
                           int wk, int p, int d, int width, void* stream) {
    if (n <= 0) return 0;
    if (wk < 1 || wk > FPT_LIN_MAX_WK || d < 1 || d > FPT_LIN_MAX_D ||
        p < 1 || p > FPT_LIN_MAX_P || width < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    int blocks = (n + threads - 1) / threads;
    if (key_bytes == 8) {
        fpt_cms_add_kernel<int64_t><<<blocks, threads, 0, s>>>(
            (float*)counts, (const int64_t*)keys, (const float*)vals,
            (const uint8_t*)valid, n, wk, p, d, width);
    } else if (key_bytes == 4) {
        fpt_cms_add_kernel<int32_t><<<blocks, threads, 0, s>>>(
            (float*)counts, (const int32_t*)keys, (const float*)vals,
            (const uint8_t*)valid, n, wk, p, d, width);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
