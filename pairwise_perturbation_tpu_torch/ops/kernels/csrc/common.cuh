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

// D += A B on the tensor cores: mma.sync m16n8k16, bf16 A (16 x 16, row
// major) and B (16 x 8, column major), f32 accumulator. The products of two
// bf16 are exact in f32 and are summed in f32. Lane (g, t) = (lane >> 2,
// lane & 3) holds A's rows g, g + 8 at columns 2t, 2t + 1 (a0: row g, a1:
// row g + 8) and 2t + 8, 2t + 9 (a2, a3); B's column g at rows 2t, 2t + 1
// (b0) and 2t + 8, 2t + 9 (b1); D's rows g (d[0], d[1]) and g + 8 (d[2],
// d[3]) at columns 2t, 2t + 1; the lower half of a register is the lower
// index (ops/kernels/_mma.py a_slot, b_slot, c_slot).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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
