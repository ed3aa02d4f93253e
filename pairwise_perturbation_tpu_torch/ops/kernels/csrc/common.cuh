// Helpers shared by the port's CUDA sources (each .cu includes this file;
// ops/kernels/_build.py hashes it with the sources).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pp {

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// One element of V as float: f32 through the read-only cache, bf16 widened
// exactly (a bf16 is the high half of the f32 with the same value).
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

// Ranks per pass of the kernels that keep an RC-float accumulator per
// thread (RC a multiple of 4 for float4 reads): the smallest that covers
// R, else 32; more ranks add a grid dimension.
inline int rank_chunk(int R) {
  if (R <= 4) return 4;
  if (R <= 8) return 8;
  if (R <= 12) return 12;
  if (R <= 16) return 16;
  if (R <= 24) return 24;
  return 32;
}

}  // namespace pp

#define PP_DISPATCH_RC(RC_VALUE, ...)                       \
  switch (RC_VALUE) {                                       \
    case 4: { constexpr int RC = 4; __VA_ARGS__; } break;   \
    case 8: { constexpr int RC = 8; __VA_ARGS__; } break;   \
    case 12: { constexpr int RC = 12; __VA_ARGS__; } break; \
    case 16: { constexpr int RC = 16; __VA_ARGS__; } break; \
    case 24: { constexpr int RC = 24; __VA_ARGS__; } break; \
    default: { constexpr int RC = 32; __VA_ARGS__; } break; \
  }
