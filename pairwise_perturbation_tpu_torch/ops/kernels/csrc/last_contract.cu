// First-level contraction of the minor (last) mode for Hopper (sm_90a):
// a tall-skinny (N, B) @ (B, R) product in one pass over V.
//
// Replaces pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py::
// last_contract and its Pallas kernel _last_kernel (K5). With V viewed as
// (N, B) around its last mode (N = the leading modes merged):
//   out[n, r] = sum_b V[n, b] W[b, r]                          (N, R)
// V is float32 or bfloat16 (widened exactly); W is float32 and already
// rounded to V's type by the caller; sums and the output are float32.
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
// * VW = 4 (loads of 4 values: 16 bytes of f32, 8 of bf16) when B % 4 ==
//   0 and V is aligned to that load; the slices then start on multiples
//   of 4 columns. Otherwise VW = 1: the same template with scalar loads
//   takes any B and any offset.
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
// bf16 V with B % 8 == 0 at a 16-byte boundary takes the tensor cores
// instead (path "mma", last_partial_mma_kernel): the JAX rule for bf16 V is
// bf16 operands with f32 sums, which is mma.sync m16n8k16 bf16 -> f32. The
// FMA loop needs ~24 bytes of W from shared memory and ~18 instructions per
// element of V, which at 2 bytes an element is more than an SM issues at
// the read rate (it reached 53% of the bound); on the tensor cores a warp's
// step is one 16-byte load of V, two 16-byte shared-memory loads and two
// mmas per lane for 512 bytes of V:
// * A warp owns 8 rows of a tile, the mma's B columns (n); W^T's 16 ranks
//   of a chunk are its A rows. Lane (g, t) loads 16 bytes of row g at
//   columns 8t ... 8t + 7 of each 32-column step and passes them to the
//   mmas as they are: pairs 0 and 1 are the first mma's k rows 2t, 2t + 1
//   and 2t + 8, 2t + 9, pairs 2 and 3 the second's. The sum over k does not
//   depend on which physical column is which k, as long as A's fragment
//   uses the same columns.
// * So W's slice is staged in shared memory as the A fragments themselves:
//   for each step, rank half j (ranks 8j ... 8j + 7 of the chunk) and lane
//   (g, t), the 16 bytes of W^T's rank 8j + g at columns 8t ... 8t + 7, read
//   with one conflict-free 16-byte load. The wrapper passes W^T in bf16,
//   zero past R and B (ops/kernels/_mma.py wt_bf16), so padding adds zeros.
// * 8 steps' loads are issued together, with the streaming hint: 512 bytes
//   of each of the warp's rows. 16 rows a warp (V as A) with 4 steps, 256
//   bytes a row, ran slower on the H100, and 16 steps, 12 warps a block,
//   or loads of the next 8 steps issued before the mmas of these were no
//   faster (PERF.md, Findings).
// * The accumulators are D itself (two of 4 floats a lane, one per mma of
//   a step); no shuffles. Slices, rank chunks (16 ranks), the persistent
//   grid and launch 2 are as above; slices are whole steps (2 of 3616
//   columns, 115.7 KB each, at coil).
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

// VW values of V from p as floats, with the streaming hint; a bf16 is the
// high half of the f32 of the same value.
__device__ __forceinline__ void load_stream(const float* p, float (&x)[1]) { x[0] = __ldcs(p); }
__device__ __forceinline__ void load_stream(const float* p, float (&x)[4]) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load_stream(const uint16_t* p, float (&x)[1]) {
  x[0] = __uint_as_float(static_cast<uint32_t>(__ldcs(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}
__device__ __forceinline__ void load_stream(const uint16_t* p, float (&x)[4]) {
  const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
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
template <typename T, int RC, int VW>
__global__ void __launch_bounds__(kThreads, 2)
last_partial_kernel(const T* __restrict__ V, const float* __restrict__ W,
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
    const T* v[ROWS];
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

// The mma path: kMmaRows rows of V a warp, kMmaStep columns a step, the
// A fragments of a step (two rank halves of 32 lanes x 16 bytes) in shared
// memory, and the steps whose loads are issued together.
constexpr int kMmaRows = 8;
constexpr int kMmaStep = 32;
constexpr int kMmaStepBytes = 2 * 32 * 16;
constexpr int kMmaUnroll = 8;

// One step: x is the lane's 16 bytes of row g, wf its A fragment of ranks
// g (wf[0]) and g + 8 (wf[32]); acc[q] is the D of the step's mma q.
__device__ __forceinline__ void mma_step(const uint4 x, const uint4* wf, float (&acc)[2][4]) {
  const uint4 w0 = wf[0], w1 = wf[32];
  pp::mma_bf16(acc[0], w0.x, w1.x, w0.y, w1.y, x.x, x.y);
  pp::mma_bf16(acc[1], w0.z, w1.z, w0.w, w1.w, x.z, x.w);
}

// Launch 1 of the mma path. grid (blocks, slices, rank chunks of 16),
// kThreads, dynamic shared memory slice_cols / kMmaStep * kMmaStepBytes.
// V (N, B) bf16 and 16-byte aligned, B % 8 == 0; Wt is W^T in bf16, (16 x
// rank chunks, ldw), ldw % 32 == 0, zero past R and B; slice_cols % 32 == 0.
// Slice s covers columns [s * slice_cols, min(B, (s + 1) * slice_cols)) and
// writes part + s * N * R.
__global__ void __launch_bounds__(kThreads, 2)
last_partial_mma_kernel(const uint16_t* __restrict__ V, const uint16_t* __restrict__ Wt,
                        int64_t ldw, float* __restrict__ part, int64_t N, int64_t B, int R,
                        int64_t slice_cols) {
  extern __shared__ uint4 w_frag[];  // [step][rank half][lane]
  const int r0 = blockIdx.z * 16;
  const int64_t c0 = (int64_t)blockIdx.y * slice_cols;
  const int L = (int)pp::min64(slice_cols, B - c0);  // columns of this slice
  const int steps = (L + kMmaStep - 1) / kMmaStep;

#pragma unroll 4
  for (int e = threadIdx.x; e < steps * 64; e += kThreads) {
    const int s = e >> 6, j = (e >> 5) & 1, ln = e & 31;
    w_frag[e] = __ldg(reinterpret_cast<const uint4*>(
        Wt + (int64_t)(r0 + 8 * j + (ln >> 2)) * ldw + c0 + kMmaStep * s + 8 * (ln & 3)));
  }
  __syncthreads();  // the only barrier: the fragments are read-only from here

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int full = L / kMmaStep;  // whole steps; a last partial one is masked per lane
  const int64_t n_tiles = (N + kWarps * kMmaRows - 1) / (kWarps * kMmaRows);
  const uint4* wf = w_frag + lane;
  part += (int64_t)blockIdx.y * N * R;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (tile * kWarps + warp) * kMmaRows;
    const uint16_t* v = V + pp::min64(row0 + g, N - 1) * B + c0 + 8 * t;
    float acc[2][4] = {};
    int s = 0;
    for (; s + kMmaUnroll <= full; s += kMmaUnroll) {
      uint4 x[kMmaUnroll];
#pragma unroll
      for (int u = 0; u < kMmaUnroll; ++u)
        x[u] = __ldcs(reinterpret_cast<const uint4*>(v + (s + u) * kMmaStep));
#pragma unroll
      for (int u = 0; u < kMmaUnroll; ++u) mma_step(x[u], wf + (s + u) * 64, acc);
    }
    for (; s < steps; ++s) {  // the last whole steps, then a partial one
      uint4 x = make_uint4(0, 0, 0, 0);
      if (s * kMmaStep + 8 * t < L) x = __ldcs(reinterpret_cast<const uint4*>(v + s * kMmaStep));
      mma_step(x, wf + s * 64, acc);
    }

    // D float i: rank r0 + g + 8 (i >> 1), row row0 + 2t + (i & 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = row0 + 2 * t + (i & 1);
      const int r = r0 + g + 8 * (i >> 1);
      if (row < N && r < R) part[row * R + r] = acc[0][i] + acc[1][i];
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

template <typename T, int RC, int VW>
cudaError_t launch_partial(const T* V, const float* W, float* part, int64_t N, int64_t B,
                           int R, int64_t slice_cols, int n_slices, int blocks, int64_t smem,
                           cudaStream_t stream) {
  if (smem != (slice_cols + VW - 1) / VW * group_stride<RC, VW>() * 4)
    return cudaErrorInvalidValue;
  auto kernel = last_partial_kernel<T, RC, VW>;
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

template <typename T>
cudaError_t launch_vec(const T* V, const float* W, float* target, int64_t N, int64_t B, int R,
                       int64_t slice_cols, int n_slices, int blocks, int vec, int64_t smem,
                       cudaStream_t stream) {
  const int rc = pp::rank_chunk(R);
  cudaError_t err;
  if (vec == 4) {
    PP_DISPATCH_RC(rc, err = launch_partial<T, RC, 4>(V, W, target, N, B, R, slice_cols,
                                                      n_slices, blocks, smem, stream));
  } else {
    PP_DISPATCH_RC(rc, err = launch_partial<T, RC, 1>(V, W, target, N, B, R, slice_cols,
                                                      n_slices, blocks, smem, stream));
  }
  return err;
}

// Launch 2 when there is more than one slice.
cudaError_t sum_slices(const float* part, float* out, int64_t n, int n_slices,
                       cudaStream_t stream) {
  sum_slices_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, out, n, n_slices);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K5: out (N, R) = V (N, B) @ W (B, R), V float32 or (v_bf16) bfloat16,
// W and out float32, with the wrapper's plan: slices of slice_cols
// columns (n_slices of them), `blocks` blocks per slice and rank chunk,
// vec = 4 for loads of 4 values (B % 4 == 0, slice_cols % 4 == 0, V
// aligned to 4 elements: 16 bytes for f32, 8 for bf16) or 1, smem the
// dynamic shared memory of launch 1. part is (n_slices, N, R) f32 scratch
// when n_slices > 1 (launch 1 then writes it and launch 2 sums it into
// out), and unused otherwise (launch 1 writes out).
int pp_last_contract(const void* V, int v_bf16, const float* W, float* part, float* out,
                     int64_t N, int64_t B, int R, int64_t slice_cols, int n_slices, int blocks,
                     int vec, int64_t smem, cudaStream_t stream) {
  if (N <= 0 || B <= 0 || R <= 0 || slice_cols <= 0 || blocks <= 0 ||
      n_slices != (B + slice_cols - 1) / slice_cols || n_slices > 65535 ||
      (n_slices > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = v_bf16 ? 8 : 16;
  if (vec != 1 && (vec != 4 || B % 4 != 0 || slice_cols % 4 != 0 ||
                   reinterpret_cast<uintptr_t>(V) % align != 0))
    return (int)cudaErrorInvalidValue;
  float* target = n_slices > 1 ? part : out;
  const cudaError_t err =
      v_bf16 ? launch_vec(static_cast<const uint16_t*>(V), W, target, N, B, R, slice_cols,
                          n_slices, blocks, vec, smem, stream)
             : launch_vec(static_cast<const float*>(V), W, target, N, B, R, slice_cols,
                          n_slices, blocks, vec, smem, stream);
  if (err != cudaSuccess || n_slices == 1) return (int)err;
  return (int)sum_slices(part, out, N * R, n_slices, stream);
}

// K5 with bf16 V on the tensor cores (the wrapper's path "mma"): V (N, B)
// bf16, B % 8 == 0, V and Wt 16-byte aligned; Wt (16 x ceil(R / 16), ldw)
// bf16 is W^T zero past R and B, ldw % 32 == 0 and >= B; slices of
// slice_cols (a multiple of 32) columns, smem = slice_cols / 32 * 1024;
// part, out and the rest as pp_last_contract.
int pp_last_contract_mma(const void* V, const void* Wt, int64_t ldw, float* part, float* out,
                         int64_t N, int64_t B, int R, int64_t slice_cols, int n_slices,
                         int blocks, int64_t smem, cudaStream_t stream) {
  if (N <= 0 || B <= 0 || R <= 0 || blocks <= 0 || B % 8 != 0 || slice_cols <= 0 ||
      slice_cols % kMmaStep != 0 || n_slices != (B + slice_cols - 1) / slice_cols ||
      n_slices > 65535 || (n_slices > 1 && part == nullptr) || ldw % kMmaStep != 0 ||
      ldw < B || reinterpret_cast<uintptr_t>(V) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(Wt) % 16 != 0 || smem != slice_cols / kMmaStep * kMmaStepBytes)
    return (int)cudaErrorInvalidValue;
  auto kernel = last_partial_mma_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return (int)err;
  float* target = n_slices > 1 ? part : out;
  const dim3 grid((unsigned)blocks, (unsigned)n_slices, (unsigned)((R + 15) / 16));
  kernel<<<grid, kThreads, (size_t)smem, stream>>>(static_cast<const uint16_t*>(V),
                                                   static_cast<const uint16_t*>(Wt), ldw, target,
                                                   N, B, R, slice_cols);
  if ((err = cudaGetLastError()) != cudaSuccess || n_slices == 1) return (int)err;
  return (int)sum_slices(part, out, N * R, n_slices, stream);
}

}  // extern "C"
