// murmur3_x86_32 over uint32 word lanes and the count-min bucket of a key.
//
// The per-key index math of the CMS kernels, shared by the device code and
// by a host build: every function is __host__ __device__ under nvcc and a
// plain inline function under a host C++ compiler, so the CPU tests build
// this header with g++ and hold its buckets against the JAX package's
// ops/cms.py cms_buckets (seed = depth row, bucket = hash % width unsigned,
// the same arithmetic as schema/keys.py hash_words).
//
// The key width is a template parameter (MAXW, the most words a key may
// have) with the actual count beside it: the kernels instantiate
// MAXW = Wk with nwords = Wk, so every loop unrolls fully and a key's words
// stay in registers; a generic instantiation passes MAXW = 16 and a
// runtime count, and the guards keep it exact.
#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define FPT_HD __host__ __device__ __forceinline__
#define FPT_UNROLL _Pragma("unroll")
#else
#define FPT_HD static inline
#define FPT_UNROLL
#endif

FPT_HD uint32_t fpt_rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

// The seed-free half of murmur3's block step. Every depth row mixes the
// same words, so a key mixes each word once and hashes D seeds from it.
FPT_HD uint32_t fpt_mix_word(uint32_t w) {
    uint32_t k = w * 0xCC9E2D51u;
    k = fpt_rotl32(k, 15);
    return k * 0x1B873593u;
}

// murmur3_x86_32 with the given seed over nwords <= MAXW words already
// passed through fpt_mix_word; the length mixed in at the end is
// nwords * 4 bytes.
template <int MAXW>
FPT_HD uint32_t fpt_hash_mixed(const uint32_t (&k)[MAXW], int nwords,
                               uint32_t seed) {
    uint32_t h = seed;
    FPT_UNROLL
    for (int i = 0; i < MAXW; ++i) {
        if (i < nwords) {
            h ^= k[i];
            h = fpt_rotl32(h, 13);
            h = h * 5u + 0xE6546B64u;
        }
    }
    h ^= (uint32_t)(nwords * 4);
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

// Bucket of depth row d from a key's mixed words: murmur3 with seed d,
// reduced modulo width as unsigned. width < 2^31, so the result fits
// int32.
template <int MAXW>
FPT_HD int32_t fpt_cms_bucket(const uint32_t (&k)[MAXW], int nwords, int d,
                              int width) {
    return (int32_t)(fpt_hash_mixed<MAXW>(k, nwords, (uint32_t)d) %
                     (uint32_t)width);
}
