// First-level contraction of a non-minor mode for Hopper (sm_90a), one
// pass over V.
//
// Replaces pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py::
// mid_contract and its Pallas kernels _mid_kernel_t (rank-minor output,
// K4) and _mid_kernel (rank-major output, K4'); _mid_kernel_zp (rank-outer
// output, launched only by scripts/bench_rankpos.py, S2); and the K4' sum
// of scripts/bench_midvariants.py::_mm_kernel swept over its lane tile
// (S5), here swept over the block width. With V viewed as (P, B, M) around
// the contracted mode (P = leading modes, M = trailing modes, both merged
// for free in row-major order):
//   rank-minor  out[p, m, r] = sum_b V[p, b, m] W[b, r]     (P, M, R)
//   rank-major  out[p, r, m] = sum_b V[p, b, m] W[b, r]     (P, R, M)
//   rank-outer  out[r, p, m] = sum_b V[p, b, m] W[b, r]     (R, P, M)
// V is float32 or bfloat16 (widened exactly); W is float32 and already
// rounded to V's type by the caller; sums and outputs are float32.
//
// What bounds it on the H100: memory bandwidth. Each element of V read
// costs R FMAs (R = 10: 2.5 FMA per f32 byte, under the card's FP32
// balance), so the design reads V once, coalesced, and keeps everything
// else on chip:
// * A block owns COLS consecutive columns m of one p; thread t owns
//   column m0 + t, so each warp load of a V row is 128 contiguous bytes
//   (64 for bf16). The ragged last tile is masked per thread: no padded
//   copy of V and no out-of-bounds read.
// * COLS (the block width, 128, 256 or 512 threads) is a template
//   parameter: 256 on every package path; the other two are S5's sweep,
//   for the rank-major and rank-outer layouts only (the rank-minor
//   staging tile below would not fit 48 KB of static shared memory at
//   512 columns and RC = 32).
// * Threads loop over b with RC float accumulators in registers. W's
//   rows are staged kRows at a time in shared memory, rank-padded with
//   zeros to RC, and read as float4 broadcasts. Ranks above RC add a grid
//   dimension (a re-read of V).
// * Rank-major and rank-outer output is written straight from the
//   accumulators (coalesced over m). Rank-minor output is staged as the
//   block's (COLS x RC) tile in shared memory and written as one
//   contiguous run when RC covers R, so the (P, M, R) write stays
//   coalesced.
// Arithmetic is FP32 FMA on the CUDA cores (the Pallas kernel dots f32 at
// Precision.HIGHEST, so TF32 would be less accurate). No atomics: every
// output is one thread's sequential sum, so runs repeat bit for bit.
//
// The entry launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

#include "common.cuh"

namespace {

using pp::load_f32;
using pp::min64;

constexpr int kRows = 64;  // rows of W staged per pass

// Output layouts, as the wrapper numbers them.
constexpr int kRankMinor = 0;
constexpr int kRankMajor = 1;
constexpr int kRankOuter = 2;

template <typename T, int RC, int COLS, bool MINOR>
__global__ void __launch_bounds__(COLS)
mid_contract_kernel(const T* __restrict__ V, const float* __restrict__ W,
                    float* __restrict__ out, int64_t P, int64_t B, int64_t M, int R,
                    int64_t n_tiles, int layout) {
  __shared__ __align__(16) float w_s[kRows * RC];
  __shared__ float o_s[MINOR ? COLS * (RC + 1) : 1];
  const int64_t p = blockIdx.x / n_tiles;
  const int64_t m0 = (blockIdx.x - p * n_tiles) * COLS;
  const int r0 = blockIdx.y * RC;
  const int tid = threadIdx.x;
  const int64_t m = m0 + tid;
  const bool live = m < M;
  const T* Vp = V + p * B * M + m;

  float acc[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) acc[r] = 0.f;

  for (int64_t b0 = 0; b0 < B; b0 += kRows) {
    const int n = (int)min64(kRows, B - b0);
    __syncthreads();  // the previous rows are no longer read
    for (int t = tid; t < kRows * RC; t += COLS) {
      const int bb = t / RC, rr = t - bb * RC;
      w_s[t] = (bb < n && r0 + rr < R) ? W[(b0 + bb) * R + r0 + rr] : 0.f;
    }
    __syncthreads();
    if (live) {
      const T* v = Vp + b0 * M;
#pragma unroll 4
      for (int bb = 0; bb < n; ++bb) {
        const float x = load_f32(v + bb * M);
        const float4* w4 = reinterpret_cast<const float4*>(&w_s[bb * RC]);
#pragma unroll
        for (int q = 0; q < RC / 4; ++q) {
          const float4 c = w4[q];
          acc[4 * q + 0] = fmaf(x, c.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(x, c.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(x, c.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(x, c.w, acc[4 * q + 3]);
        }
      }
    }
  }

  const int rcv = R - r0 < RC ? R - r0 : RC;  // ranks of this chunk
  if (!MINOR) {
    if (live) {
      // rank-major: rank r of p at (p * R + r) * M; rank-outer: (r * P + p) * M
      const int64_t r_stride = layout == kRankOuter ? P * M : M;
      float* dst = out + (layout == kRankOuter ? p * M + r0 * P * M
                                               : (p * R + r0) * M) + m;
#pragma unroll
      for (int r = 0; r < RC; ++r)
        if (r < rcv) dst[r * r_stride] = acc[r];
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < RC; ++r) o_s[tid * (RC + 1) + r] = acc[r];
  __syncthreads();
  const int64_t cols = min64(COLS, M - m0);
  float* dst = out + (p * M + m0) * R + r0;
  for (int64_t e = tid; e < cols * rcv; e += COLS) {
    const int64_t c = e / rcv;
    const int r = (int)(e - c * rcv);
    dst[c * R + r] = o_s[c * (RC + 1) + r];
  }
}

template <typename T, int COLS, bool MINOR>
int launch(const T* V, const float* W, float* out, int64_t P, int64_t B, int64_t M,
           int R, int layout, cudaStream_t stream) {
  const int rc = pp::rank_chunk(R);
  const int64_t n_tiles = (M + COLS - 1) / COLS;
  if (P * n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(P * n_tiles), (unsigned)((R + rc - 1) / rc));
  PP_DISPATCH_RC(rc, mid_contract_kernel<T, RC, COLS, MINOR><<<grid, COLS, 0, stream>>>(
                         V, W, out, P, B, M, R, n_tiles, layout));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_layout(const T* V, const float* W, float* out, int64_t P, int64_t B,
                  int64_t M, int R, int layout, int cols, cudaStream_t stream) {
  if (layout == kRankMinor)
    return cols == 256 ? launch<T, 256, true>(V, W, out, P, B, M, R, layout, stream)
                       : (int)cudaErrorInvalidValue;
  if (layout != kRankMajor && layout != kRankOuter) return (int)cudaErrorInvalidValue;
  switch (cols) {
    case 128: return launch<T, 128, false>(V, W, out, P, B, M, R, layout, stream);
    case 256: return launch<T, 256, false>(V, W, out, P, B, M, R, layout, stream);
    case 512: return launch<T, 512, false>(V, W, out, P, B, M, R, layout, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K4 / K4' / S2 / S5: out (P, M, R) for layout 0 (rank-minor), (P, R, M)
// for 1 (rank-major), (R, P, M) for 2 (rank-outer), from V (P, B, M)
// (float32, or bfloat16 when v_bf16) and W (B, R) float32, with blocks of
// `cols` threads (256; 128 or 512 for layouts 1 and 2 only).
int pp_mid_contract(const void* V, int v_bf16, const float* W, float* out, int64_t P,
                    int64_t B, int64_t M, int R, int layout, int cols,
                    cudaStream_t stream) {
  if (P <= 0 || B <= 0 || M <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  if (v_bf16)
    return launch_layout(static_cast<const uint16_t*>(V), W, out, P, B, M, R, layout,
                         cols, stream);
  return launch_layout(static_cast<const float*>(V), W, out, P, B, M, R, layout, cols,
                       stream);
}

}  // extern "C"
