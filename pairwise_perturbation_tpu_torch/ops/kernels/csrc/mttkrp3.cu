// Fused order-3 MTTKRP for Hopper (sm_90a), one pass over V per mode.
//
// Replaces the three Pallas kernels behind
// pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py::mttkrp3_mode:
//   mode 0  M[i,r] = sum_j B[j,r] sum_k V[i,j,k] C[k,r]   (mttkrp3, _kernel)
//   mode 1  M[j,r] = sum_i A[i,r] sum_k V[i,j,k] C[k,r]   (mttkrp3_m1, _kernel_m1)
//   mode 2  M[k,r] = sum_{i,j} V[i,j,k] A[i,r] B[j,r]     (mttkrp3_m2, _kernel_m2)
// V is (I, J, K) float32, row-major and contiguous; factors are (n, R)
// row-major; out is (n_mode, R).
//
// What bounds it on the H100: memory bandwidth. Each output costs about
// 2 R flops per element of V read once (R = 10: 5 flop per 4-byte load,
// far below the card's ~20 flop/byte FP32 balance), so the design reads V
// exactly once, coalesced, and never writes an (I, J, R) intermediate:
//
// * V is walked as K-long fibers (i, j, :). The threads of a block own
//   consecutive k, so each warp load is 128 contiguous bytes; ragged K is
//   masked per thread instead of padding V with a copy.
// * The per-fiber weight (B[j,:] for mode 0, A[i,:] for mode 1,
//   A[i,:] * B[j,:] for mode 2) is staged for kFibers fibers at a time in
//   shared memory, rank-padded with zeros to RC (a multiple of 4), and
//   read as float4 broadcasts.
// * Modes 0/1: one block per output row x loops over every fiber of that
//   row. Since C[k,r] is fixed for a thread's k, it factors out of the
//   fiber loop: s[r] = sum_y V[x,y,k] W[y,r], then acc[r] += C[k,r] s[r],
//   and a block reduction over k writes out[x, :]. The Pallas kernels'
//   sequential reduction grid axis becomes this loop inside the block.
// * Mode 2: the Pallas kernel keeps the (K, R) accumulator resident over
//   a sequential grid. Hopper blocks run in parallel in no fixed order, so
//   each block reduces one slab of fibers into its own (K, R) partial in a
//   scratch buffer the caller allocates, and a second launch sums the
//   partials in slab order. No atomics: runs reproduce bit for bit.
// * Ranks are processed RC at a time (RC in {4, 8, 12, 16, 24, 32}, the
//   smallest that covers R, else 32); more ranks add a grid dimension.
// Arithmetic is FP32 FMA on the CUDA cores: the Pallas kernels dot f32 at
// Precision.HIGHEST, so tensor-core TF32 would be less accurate.
//
// Every entry launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (0 = launched).

#include "common.cuh"

namespace {

using pp::min64;
using pp::rank_chunk;

constexpr int kMaxThreads = 256;  // threads per block (8 warps)
constexpr int kFibers = 64;       // fibers whose weights are staged at once

template <int RC>
__device__ __forceinline__ void fma_fiber(float v, const float* w, float (&s)[RC]) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < RC / 4; ++q) {
    const float4 c = w4[q];
    s[4 * q + 0] = fmaf(v, c.x, s[4 * q + 0]);
    s[4 * q + 1] = fmaf(v, c.y, s[4 * q + 1]);
    s[4 * q + 2] = fmaf(v, c.z, s[4 * q + 2]);
    s[4 * q + 3] = fmaf(v, c.w, s[4 * q + 3]);
  }
}

// Modes 0 and 1. Output row x; fiber y starts at x * sx + y * sy.
// grid (nx, ceil(R / RC)), block (threads) with threads a multiple of 32.
template <int RC>
__global__ void __launch_bounds__(kMaxThreads)
mttkrp3_rows_kernel(const float* __restrict__ V, const float* __restrict__ W,
                    const float* __restrict__ C, float* __restrict__ out,
                    int64_t ny, int64_t K, int R, int64_t sx, int64_t sy) {
  __shared__ __align__(16) float w_s[kFibers * RC];
  __shared__ float red_s[kMaxThreads / 32][RC];
  const int64_t x = blockIdx.x;
  const int r0 = blockIdx.y * RC;
  const int tid = threadIdx.x;
  const float* Vx = V + x * sx;

  float acc[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) acc[r] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += blockDim.x) {
    const int64_t k = k0 + tid;
    const bool live = k < K;
    float s[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) s[r] = 0.f;
    for (int64_t y0 = 0; y0 < ny; y0 += kFibers) {
      const int n = (int)min64(kFibers, ny - y0);
      __syncthreads();  // previous chunk's weights are no longer read
      for (int t = tid; t < kFibers * RC; t += blockDim.x) {
        const int yy = t / RC, rr = t - yy * RC;
        w_s[t] = (yy < n && r0 + rr < R) ? W[(y0 + yy) * R + r0 + rr] : 0.f;
      }
      __syncthreads();
      if (live) {
        const float* p = Vx + y0 * sy + k;
#pragma unroll 4
        for (int yy = 0; yy < n; ++yy)
          fma_fiber<RC>(__ldg(p + yy * sy), &w_s[yy * RC], s);
      }
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < RC; ++r)
        if (r0 + r < R) acc[r] = fmaf(C[k * R + r0 + r], s[r], acc[r]);
    }
  }

  // Block reduction over k: warp shuffles, then one value per warp.
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    float v = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red_s[warp][r] = v;
  }
  __syncthreads();
  if (tid < RC && r0 + tid < R) {
    float v = 0.f;
    for (int w = 0; w < n_warps; ++w) v += red_s[w][tid];
    out[x * R + r0 + tid] = v;
  }
}

// Mode 2, pass 1: partial[slab, k, r] = sum_{f in slab} V[f, k] A[f / J, r] B[f % J, r]
// over the flattened fiber index f = i * J + j.
// grid (n_slabs, ceil(K / threads), ceil(R / RC)).
template <int RC>
__global__ void __launch_bounds__(kMaxThreads)
mttkrp3_minor_partial_kernel(const float* __restrict__ V, const float* __restrict__ A,
                             const float* __restrict__ B, float* __restrict__ partial,
                             int64_t n_fibers, int64_t J, int64_t K, int R,
                             int64_t fibers_per_slab) {
  __shared__ __align__(16) float w_s[kFibers * RC];
  const int64_t slab = blockIdx.x;
  const int64_t k = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.z * RC;
  const int tid = threadIdx.x;
  const int64_t f_begin = slab * fibers_per_slab;
  const int64_t f_end = min64(n_fibers, f_begin + fibers_per_slab);
  const bool live = k < K;

  float s[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) s[r] = 0.f;

  for (int64_t f0 = f_begin; f0 < f_end; f0 += kFibers) {
    const int n = (int)min64(kFibers, f_end - f0);
    __syncthreads();
    for (int t = tid; t < kFibers * RC; t += blockDim.x) {
      const int yy = t / RC, rr = t - yy * RC;
      float w = 0.f;
      if (yy < n && r0 + rr < R) {
        const int64_t f = f0 + yy, i = f / J, j = f - i * J;
        w = A[i * R + r0 + rr] * B[j * R + r0 + rr];
      }
      w_s[t] = w;
    }
    __syncthreads();
    if (live) {
      const float* p = V + f0 * K + k;
#pragma unroll 4
      for (int yy = 0; yy < n; ++yy)
        fma_fiber<RC>(__ldg(p + yy * K), &w_s[yy * RC], s);
    }
  }
  if (live) {
    float* dst = partial + (slab * K + k) * R + r0;
#pragma unroll
    for (int r = 0; r < RC; ++r)
      if (r0 + r < R) dst[r] = s[r];
  }
}

// Mode 2, pass 2: out[e] = sum_slab partial[slab, e] in slab order, e = k * R + r.
__global__ void mttkrp3_sum_slabs_kernel(const float* __restrict__ partial,
                                         float* __restrict__ out, int64_t n_slabs,
                                         int64_t n_out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  float v = 0.f;
  for (int64_t s = 0; s < n_slabs; ++s) v += partial[s * n_out + e];
  out[e] = v;
}

int block_threads(int64_t K) {
  const int64_t t = (K + 31) / 32 * 32;
  return (int)(t < kMaxThreads ? t : kMaxThreads);
}

int launch_rows(const float* V, const float* W, const float* C, float* out,
                int64_t nx, int64_t ny, int64_t K, int R, int64_t sx, int64_t sy,
                cudaStream_t stream) {
  if (nx <= 0 || ny <= 0 || K <= 0 || R <= 0 || nx > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int rc = rank_chunk(R);
  const dim3 grid((unsigned)nx, (unsigned)((R + rc - 1) / rc));
  const dim3 block(block_threads(K));
  PP_DISPATCH_RC(rc, mttkrp3_rows_kernel<RC><<<grid, block, 0, stream>>>(
                         V, W, C, out, ny, K, R, sx, sy));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Mode 0 (K1): out (I, R) from V (I, J, K), B (J, R), C (K, R).
int pp_mttkrp3_mode0(const float* V, const float* B, const float* C, float* out,
                     int64_t I, int64_t J, int64_t K, int R, cudaStream_t stream) {
  return launch_rows(V, B, C, out, I, J, K, R, J * K, K, stream);
}

// Mode 1 (K2): out (J, R) from V (I, J, K), A (I, R), C (K, R).
int pp_mttkrp3_mode1(const float* V, const float* A, const float* C, float* out,
                     int64_t I, int64_t J, int64_t K, int R, cudaStream_t stream) {
  return launch_rows(V, A, C, out, J, I, K, R, K, J * K, stream);
}

// Mode 2 (K3): out (K, R) from V (I, J, K), A (I, R), B (J, R), through
// partial (n_slabs, K, R) scratch; slab s covers fibers
// [s * fibers_per_slab, min(I * J, (s + 1) * fibers_per_slab)).
int pp_mttkrp3_mode2(const float* V, const float* A, const float* B, float* out,
                     float* partial, int64_t I, int64_t J, int64_t K, int R,
                     int64_t n_slabs, int64_t fibers_per_slab, cudaStream_t stream) {
  if (I <= 0 || J <= 0 || K <= 0 || R <= 0 || n_slabs <= 0 || fibers_per_slab <= 0 ||
      n_slabs > 0x7fffffffLL || n_slabs * fibers_per_slab < I * J)
    return (int)cudaErrorInvalidValue;
  const int rc = rank_chunk(R);
  const int threads = block_threads(K);
  const dim3 grid((unsigned)n_slabs, (unsigned)((K + threads - 1) / threads),
                  (unsigned)((R + rc - 1) / rc));
  PP_DISPATCH_RC(rc, mttkrp3_minor_partial_kernel<RC><<<grid, threads, 0, stream>>>(
                         V, A, B, partial, I * J, J, K, R, fibers_per_slab));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n_out = K * R;
  mttkrp3_sum_slabs_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, stream>>>(
      partial, out, n_slabs, n_out);
  return (int)cudaGetLastError();
}

const char* pp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
