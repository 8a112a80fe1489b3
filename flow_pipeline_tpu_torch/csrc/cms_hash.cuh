// murmur3_x86_32 over uint32 word lanes and the count-min bucket of a key.
//
// The per-key index math of the CMS kernels, shared by the device code and
// by a host build: every function is __host__ __device__ under nvcc and a
// plain inline function under a host C++ compiler, so the CPU tests build
// this header with g++ and hold its buckets against the JAX package's
// ops/cms.py cms_buckets (seed = depth row, bucket = hash % width unsigned,
// the same arithmetic as schema/keys.py hash_words).
#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define FPT_HD __host__ __device__ __forceinline__
#else
#define FPT_HD static inline
#endif

FPT_HD uint32_t fpt_rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

// murmur3_x86_32 of nwords uint32 words with the given seed; the length
// mixed in at the end is nwords * 4 bytes.
FPT_HD uint32_t fpt_hash_words(const uint32_t* w, int nwords, uint32_t seed) {
    uint32_t h = seed;
    for (int i = 0; i < nwords; ++i) {
        uint32_t k = w[i] * 0xCC9E2D51u;
        k = fpt_rotl32(k, 15);
        k *= 0x1B873593u;
        h ^= k;
        h = fpt_rotl32(h, 13);
        h = h * 5u + 0xE6546B64u;
    }
    h ^= (uint32_t)(nwords * 4);
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

// Bucket of depth row d: murmur3 with seed d, reduced modulo width as
// unsigned. width < 2^31, so the result fits int32.
FPT_HD int32_t fpt_cms_bucket(const uint32_t* w, int nwords, int d,
                              int width) {
    return (int32_t)(fpt_hash_words(w, nwords, (uint32_t)d) %
                     (uint32_t)width);
}
