// First-level contraction of the minor (last) mode for Hopper (sm_90a):
// a tall-skinny (N, B) @ (B, R) product in one pass over V.
//
// Replaces pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py::
// last_contract and its Pallas kernel _last_kernel (K5). With V viewed as
// (N, B) around its last mode (N = the leading modes merged):
//   out[n, r] = sum_b V[n, b] W[b, r]                          (N, R)
// V, W and the output are float32.
//
// What bounds it on the H100: memory bandwidth. At the coil-100 shape V
// is 49152 x 7200 (1.416 GB) and each element costs R = 10 FMAs, so the
// floor is reading V once, ~0.42 ms at 3.35 TB/s. A row of V is
// contiguous along B, so:
// * A block of 8 warps owns 8 x ROWS consecutive rows; each warp owns
//   ROWS of them (4 at R <= 12) and walks their columns together, lane l
//   reading column b0 + l + 32k of each row: every warp load is 128
//   contiguous bytes of one row, and ROWS x 8 loads are independent, so
//   enough bytes are in flight to cover DRAM latency. Any B is taken: no
//   vector loads, so no alignment condition on rows.
// * W (288 KB at coil, above a block's 227 KB of shared memory) is staged
//   in chunks of 256 of its rows, shared by all the block's rows; each
//   lane reads the RC weights of its column as float4s, at a row stride
//   (RC, or RC + 4 when RC is a multiple of 8) that keeps the 32 lanes'
//   reads free of bank conflicts. One load of W serves ROWS rows of V.
// * Each lane keeps ROWS x RC partial sums in registers; at the end a
//   fixed xor-shuffle tree sums them across the warp. No atomics: runs
//   repeat bit for bit.
// * Ranks above RC (pp::rank_chunk) take a second grid dimension, as in
//   mid_contract.cu; the ragged last chunk of B and rows past N are
//   masked.
// Arithmetic is FP32 FMA on the CUDA cores (the Pallas kernel dots f32 at
// Precision.HIGHEST, so TF32 would be less accurate).
//
// The entry launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 256;  // rows of W (columns of V) staged per pass

// Rows of V per warp: fewer as RC grows, so the ROWS x RC sums fit in
// registers.
template <int RC>
__host__ __device__ constexpr int rows_per_warp() {
  return RC <= 4 ? 8 : RC <= 12 ? 4 : RC <= 24 ? 2 : 1;
}

// Row stride of the staged W: lane l reads row l, so a stride that is 4
// modulo 8 floats spreads each quarter-warp's float4 reads over all 32
// banks.
template <int RC>
__host__ __device__ constexpr int w_stride() {
  return RC % 8 == 4 ? RC : RC + 4;
}

template <int RC, int ROWS, int S>
__device__ __forceinline__ void column(const float* const* v, const bool* ok,
                                       const float* w_s, int c,
                                       float (&acc)[ROWS][RC]) {
  float x[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) x[j] = ok[j] ? __ldg(v[j] + c) : 0.f;
  const float4* w4 = reinterpret_cast<const float4*>(w_s + c * S);
#pragma unroll
  for (int q = 0; q < RC / 4; ++q) {
    const float4 w = w4[q];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      acc[j][4 * q + 0] = fmaf(x[j], w.x, acc[j][4 * q + 0]);
      acc[j][4 * q + 1] = fmaf(x[j], w.y, acc[j][4 * q + 1]);
      acc[j][4 * q + 2] = fmaf(x[j], w.z, acc[j][4 * q + 2]);
      acc[j][4 * q + 3] = fmaf(x[j], w.w, acc[j][4 * q + 3]);
    }
  }
}

template <int RC>
__global__ void __launch_bounds__(kThreads)
last_contract_kernel(const float* __restrict__ V, const float* __restrict__ W,
                     float* __restrict__ out, int64_t N, int64_t B, int R) {
  constexpr int ROWS = rows_per_warp<RC>();
  constexpr int S = w_stride<RC>();
  __shared__ __align__(16) float w_s[kChunk * S];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * RC;
  const int64_t row0 = ((int64_t)blockIdx.x * kWarps + warp) * ROWS;

  const float* v[ROWS];
  bool ok[ROWS];
  float acc[ROWS][RC];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    ok[j] = row0 + j < N;
    v[j] = V + (ok[j] ? row0 + j : 0) * B;
#pragma unroll
    for (int r = 0; r < RC; ++r) acc[j][r] = 0.f;
  }

  for (int64_t b0 = 0; b0 < B; b0 += kChunk) {
    const int n = (int)pp::min64(kChunk, B - b0);
    __syncthreads();  // the previous chunk is no longer read
    for (int t = threadIdx.x; t < kChunk * RC; t += kThreads) {
      const int c = t / RC, rr = t - c * RC;
      w_s[c * S + rr] = (c < n && r0 + rr < R) ? W[(b0 + c) * R + r0 + rr] : 0.f;
    }
    __syncthreads();
    const float* vc[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) vc[j] = v[j] + b0;
    if (n == kChunk) {
#pragma unroll
      for (int k = 0; k < kChunk / 32; ++k)
        column<RC, ROWS, S>(vc, ok, w_s, 32 * k + lane, acc);
    } else {
      for (int c = lane; c < n; c += 32) column<RC, ROWS, S>(vc, ok, w_s, c, acc);
    }
  }

  // Fixed-order butterfly: every lane ends with the same warp sum.
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j][r] += __shfl_xor_sync(0xffffffffu, acc[j][r], off);

  const int rcv = R - r0 < RC ? R - r0 : RC;  // ranks of this chunk
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    if (!ok[j]) continue;
    float* dst = out + (row0 + j) * R + r0;
#pragma unroll
    for (int r = 0; r < RC; ++r)
      if (r < rcv && lane == (r & 31)) dst[r] = acc[j][r];
  }
}

}  // namespace

extern "C" {

// K5: out (N, R) = V (N, B) @ W (B, R), all float32.
int pp_last_contract(const float* V, const float* W, float* out, int64_t N, int64_t B,
                     int R, cudaStream_t stream) {
  if (N <= 0 || B <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const int rc = pp::rank_chunk(R);
  int rows = 0;
  PP_DISPATCH_RC(rc, rows = rows_per_warp<RC>());
  const int64_t n_blocks = (N + kWarps * rows - 1) / (kWarps * rows);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_blocks, (unsigned)((R + rc - 1) / rc));
  PP_DISPATCH_RC(rc, last_contract_kernel<RC><<<grid, kThreads, 0, stream>>>(
                         V, W, out, N, B, R));
  return (int)cudaGetLastError();
}

}  // extern "C"
