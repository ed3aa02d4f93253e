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
// floor is reading V once, ~0.42 ms at 3.35 TB/s; the FMAs take about a
// quarter of that. The design keeps the read stream free of stalls:
// * W is split along B into slices that fit in shared memory with two
//   blocks on an SM (at coil 4 slices of 1800 rows, 93.6 KB each). Launch
//   1 runs a persistent grid over (blocks, slices, rank chunks): a block
//   stages its slice of W once, with its one barrier, and then walks its
//   share of the row tiles. W is read from L2 once per block, not once
//   per row tile.
// * Inside the row loop there is no barrier: each warp owns ROWS rows of
//   a tile (2 at R <= 24) and streams its slice of them, lane l reading VW
//   consecutive columns of each row at column VW l + 32 VW k, with the
//   streaming hint (__ldcs: V is read once). The loop is unrolled 4 times,
//   so each warp has 4 x ROWS loads of 512 bytes in flight: 64 KB per SM
//   at two blocks, above the ~18 KB that DRAM latency asks for. (4 rows
//   unrolled twice, with the same bytes in flight, ran slower on the
//   H100: it needs all 128 registers, for fewer shared-memory reads.)
// * VW = 4 (16-byte loads) when B % 4 == 0 and V is 16-byte aligned; the
//   slices then start on multiples of 4 columns. Otherwise VW = 1: the
//   same template with scalar loads takes any B and any offset.
// * Shared memory holds W's slice as groups of VW rows, RC ranks each, at
//   a group stride that is 4 modulo 8 floats, so that the 8 lanes of each
//   float4 phase read distinct banks.
// * Each lane keeps ROWS x RC partial sums in registers; at the end of a
//   tile a fixed xor-shuffle tree sums them across the warp, and lane r
//   writes rank r of each row into the slice's (N, R) partial.
// * Launch 2 (only with more than one slice) sums the slices' partials in
//   slice order. No atomics anywhere: runs repeat bit for bit.
// * Ranks above RC (pp::rank_chunk) take the grid's third dimension; the
//   rows past N of the last tile read row N - 1 and are not written.
// Arithmetic is FP32 FMA on the CUDA cores (the Pallas kernel dots f32 at
// Precision.HIGHEST, so TF32 would be less accurate).
//
// The slice, tile and grid choice is the wrapper's (ops/kernels/
// last_contract.py plan); the entry checks it against the shapes. It
// launches on the given stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError() (0 = launched).

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // column steps whose loads are issued together

// Rows of V per warp: fewer as RC grows, so the ROWS x RC sums and the
// loads in flight fit in registers (last_contract.py rows_per_warp).
template <int RC>
__host__ __device__ constexpr int rows_per_warp() {
  return RC <= 24 ? 2 : 1;
}

// Floats between consecutive groups of VW staged rows of W
// (last_contract.py group_stride).
template <int RC, int VW>
__host__ __device__ constexpr int group_stride() {
  return (VW * RC) % 8 == 0 ? VW * RC + 4 : VW * RC;
}

__device__ __forceinline__ void load_stream(const float* p, float (&x)[1]) { x[0] = __ldcs(p); }
__device__ __forceinline__ void load_stream(const float* p, float (&x)[4]) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// acc[j][r] += sum_v x[j][v] W[group g's row v, r], in v order.
template <int RC, int VW, int ROWS>
__device__ __forceinline__ void fma_group(const float (&x)[ROWS][VW], const float* w_s, int g,
                                          float (&acc)[ROWS][RC]) {
  const float4* w4 = reinterpret_cast<const float4*>(w_s + g * group_stride<RC, VW>());
#pragma unroll
  for (int v = 0; v < VW; ++v) {
#pragma unroll
    for (int q = 0; q < RC / 4; ++q) {
      const float4 w = w4[v * (RC / 4) + q];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        acc[j][4 * q + 0] = fmaf(x[j][v], w.x, acc[j][4 * q + 0]);
        acc[j][4 * q + 1] = fmaf(x[j][v], w.y, acc[j][4 * q + 1]);
        acc[j][4 * q + 2] = fmaf(x[j][v], w.z, acc[j][4 * q + 2]);
        acc[j][4 * q + 3] = fmaf(x[j][v], w.w, acc[j][4 * q + 3]);
      }
    }
  }
}

// Launch 1. grid (blocks, slices, rank chunks), kThreads, dynamic shared
// memory ceil(slice_cols / VW) * group_stride * 4 bytes. Slice s covers
// columns [s * slice_cols, min(B, (s + 1) * slice_cols)) and writes
// part + s * N * R.
template <int RC, int VW>
__global__ void __launch_bounds__(kThreads, 2)
last_partial_kernel(const float* __restrict__ V, const float* __restrict__ W,
                    float* __restrict__ part, int64_t N, int64_t B, int R, int64_t slice_cols) {
  constexpr int ROWS = rows_per_warp<RC>();
  constexpr int G = group_stride<RC, VW>();
  constexpr int STEP = 32 * VW;
  extern __shared__ __align__(16) float w_s[];
  const int r0 = blockIdx.z * RC;
  const int64_t c0 = (int64_t)blockIdx.y * slice_cols;
  const int L = (int)pp::min64(slice_cols, B - c0);  // columns of this slice

#pragma unroll 8
  for (int t = threadIdx.x; t < L * RC; t += kThreads) {
    const int c = t / RC, rr = t - c * RC;
    w_s[(c / VW) * G + (c % VW) * RC + rr] = r0 + rr < R ? __ldg(W + (c0 + c) * R + r0 + rr) : 0.f;
  }
  __syncthreads();  // the only barrier: W's slice is read-only from here

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rcv = R - r0 < RC ? R - r0 : RC;  // ranks of this chunk
  const int64_t n_tiles = (N + kWarps * ROWS - 1) / (kWarps * ROWS);
  part += (int64_t)blockIdx.y * N * R + r0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (tile * kWarps + warp) * ROWS;
    const float* v[ROWS];
    float acc[ROWS][RC];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      v[j] = V + pp::min64(row0 + j, N - 1) * B + c0;
#pragma unroll
      for (int r = 0; r < RC; ++r) acc[j][r] = 0.f;
    }
    int c = lane * VW;
    for (; c + (kUnroll - 1) * STEP < L; c += kUnroll * STEP) {
      float x[kUnroll][ROWS][VW];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < ROWS; ++j) load_stream(v[j] + c + u * STEP, x[u][j]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fma_group<RC, VW, ROWS>(x[u], w_s, (c + u * STEP) / VW, acc);
    }
    for (; c < L; c += STEP) {  // the last kUnroll - 1 steps at most
      float x[ROWS][VW];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) load_stream(v[j] + c, x[j]);
      fma_group<RC, VW, ROWS>(x, w_s, c / VW, acc);
    }

    // Fixed-order butterfly: every lane ends with the same warp sum.
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
#pragma unroll
      for (int r = 0; r < RC; ++r)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[j][r] += __shfl_xor_sync(0xffffffffu, acc[j][r], off);

#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (row0 + j >= N) continue;
      float* dst = part + (row0 + j) * R;
#pragma unroll
      for (int r = 0; r < RC; ++r)
        if (r < rcv && lane == (r & 31)) dst[r] = acc[j][r];
    }
  }
}

// Launch 2. out[i] = sum over slices s (in order) of part[s * n + i].
__global__ void __launch_bounds__(kThreads)
sum_slices_kernel(const float* __restrict__ part, float* __restrict__ out, int64_t n,
                  int n_slices) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float v = part[i];
  for (int s = 1; s < n_slices; ++s) v += part[s * n + i];
  out[i] = v;
}

template <int RC, int VW>
cudaError_t launch_partial(const float* V, const float* W, float* part, int64_t N, int64_t B,
                           int R, int64_t slice_cols, int n_slices, int blocks, int64_t smem,
                           cudaStream_t stream) {
  if (smem != (slice_cols + VW - 1) / VW * group_stride<RC, VW>() * 4)
    return cudaErrorInvalidValue;
  auto kernel = last_partial_kernel<RC, VW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return err;
  const dim3 grid((unsigned)blocks, (unsigned)n_slices, (unsigned)((R + RC - 1) / RC));
  kernel<<<grid, kThreads, (size_t)smem, stream>>>(V, W, part, N, B, R, slice_cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K5: out (N, R) = V (N, B) @ W (B, R), all float32, with the wrapper's
// plan: slices of slice_cols columns (n_slices of them), `blocks` blocks
// per slice and rank chunk, vec = 4 for 16-byte loads of V (B % 4 == 0,
// slice_cols % 4 == 0, V 16-byte aligned) or 1, smem the dynamic shared
// memory of launch 1. part is (n_slices, N, R) f32 scratch when n_slices
// > 1 (launch 1 then writes it and launch 2 sums it into out), and unused
// otherwise (launch 1 writes out).
int pp_last_contract(const float* V, const float* W, float* part, float* out, int64_t N,
                     int64_t B, int R, int64_t slice_cols, int n_slices, int blocks, int vec,
                     int64_t smem, cudaStream_t stream) {
  if (N <= 0 || B <= 0 || R <= 0 || slice_cols <= 0 || blocks <= 0 ||
      n_slices != (B + slice_cols - 1) / slice_cols || n_slices > 65535 ||
      (n_slices > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (vec != 1 && (vec != 4 || B % 4 != 0 || slice_cols % 4 != 0 ||
                   reinterpret_cast<uintptr_t>(V) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  float* target = n_slices > 1 ? part : out;
  const int rc = pp::rank_chunk(R);
  cudaError_t err;
  if (vec == 4) {
    PP_DISPATCH_RC(rc, err = launch_partial<RC, 4>(V, W, target, N, B, R, slice_cols, n_slices,
                                                   blocks, smem, stream));
  } else {
    PP_DISPATCH_RC(rc, err = launch_partial<RC, 1>(V, W, target, N, B, R, slice_cols, n_slices,
                                                   blocks, smem, stream));
  }
  if (err != cudaSuccess || n_slices == 1) return (int)err;
  const int64_t n = N * R;
  sum_slices_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, out, n, n_slices);
  return (int)cudaGetLastError();
}

}  // extern "C"
