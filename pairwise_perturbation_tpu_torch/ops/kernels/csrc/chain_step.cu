// Khatri-Rao chain step on a rank-carrying intermediate for Hopper
// (sm_90a), one pass over the intermediate.
//
// Replaces no Pallas kernel. In the JAX package every later step of a CP
// contraction chain (ops/contract.py contract_mode_kr with has_rank, and
// the rank-major steps of the PP cache chains) is an einsum that XLA folds
// into its dot on the TPU. Eager torch.einsum on the H100 turns the step
// into a batched GEMV with the rank as the batch; a rank-minor T (and a
// rank-major one contracted over a middle mode) has no strided matrix view
// with the rank as the batch, so torch first copies the whole T into
// (rank, kept, contracted) order, and cuBLAS then reads the copy again:
// three passes over T where this kernel makes one. With T contiguous:
//   rank-minor  T (P, C, Q, R)  out[p, q, r] = sum_c T[p, c, q, r] W[c, r]
//   rank-major  T (R, P, C, Q)  out[r, p, q] = sum_c T[r, p, c, q] W[c, r]
// Both are T viewed as (rows, C, N) with N contiguous columns: rank-minor
// rows = P, N = Q R, column n of rank n % R; rank-major rows = R P, N = Q,
// row i of rank i / P. T, W and the output are float32; products and sums
// are FP32 FMAs (no TF32), in a fixed order.
//
// What bounds it on the H100: memory bandwidth. Each element of T read
// costs one FMA (0.25 FMA a byte), so the design reads T once, coalesced,
// and writes each output (1/C of T) once:
// * W's rows of the block's part of C (at most 48 KB; under 8 KB at every
//   shape of the benchmark's cells) are staged once a block in shared
//   memory; a warp's reads of a staged row touch at most R consecutive
//   words, so they broadcast or hit distinct banks.
// * Thread g owns VEC columns (4, loaded as one 16-byte __ldcs a row when
//   N % 4 == 0 and T is 16-byte aligned, else 1) of row g / (N / VEC), and
//   walks c with kUnroll loads in flight; a warp's loads are runs of
//   contiguous floats of one row or, where N is small (the contracted
//   mode the last before the rank), of a few consecutive rows, whose later
//   rows of C the L1 then holds.
// * Where the rows give too few blocks to fill the card, the wrapper's
//   plan cuts C into parts (grid y): each part's sums go to the wrapper's
//   partial buffer, and a second launch adds the parts in order.
// No atomics: every output is one fixed sequence of FMAs and adds, so runs
// repeat bit for bit.
//
// The entry launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

#include "common.cuh"

namespace {

using pp::min64;

constexpr int kThreads = 256;            // threads of a block, every kernel
constexpr int kUnroll = 8;               // loads in flight a thread
constexpr int kMaxSmem = 48 * 1024;      // dynamic shared memory of a block

template <int VEC>
__device__ __forceinline__ void load_cols(float (&x)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldcs(p);
  }
}

// Rows c0 ... c0 + n - 1 of W (C, R) into ws, n R floats.
__device__ __forceinline__ void stage_w(float* ws, const float* __restrict__ W, int64_t c0,
                                        int n, int R) {
  for (int i = threadIdx.x; i < n * R; i += kThreads) ws[i] = __ldg(W + c0 * R + i);
  __syncthreads();
}

// grid (ceil(rows N / VEC / kThreads), parts), dynamic shared memory
// 4 part_len R bytes. dst: out (rows, N), or part y's (rows, N) slice of
// the partial buffer.
template <int VEC, bool MAJOR>
__global__ void __launch_bounds__(kThreads)
chain_step_kernel(const float* __restrict__ T, const float* __restrict__ W,
                  float* __restrict__ dst, int64_t rows, int64_t C, int64_t N, int64_t P,
                  int R, int part_len) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  const int64_t c0 = (int64_t)blockIdx.y * part_len;
  const int n = (int)min64(part_len, C - c0);
  stage_w(ws, W, c0, n, R);
  const int64_t groups = N / VEC;
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= rows * groups) return;
  const int64_t row = g / groups;
  const int64_t col = (g - row * groups) * VEC;
  int rk[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) rk[j] = MAJOR ? (int)(row / P) : (int)((col + j) % R);
  const float* t = T + (row * C + c0) * N + col;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  int c = 0;
  for (; c + kUnroll <= n; c += kUnroll) {
    float x[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_cols<VEC>(x[u], t + (int64_t)(c + u) * N);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float* w = ws + (c + u) * R;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(x[u][j], w[rk[j]], acc[j]);
    }
  }
  for (; c < n; ++c) {
    float x[VEC];
    load_cols<VEC>(x, t + (int64_t)c * N);
    const float* w = ws + c * R;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = fmaf(x[j], w[rk[j]], acc[j]);
  }
  float* o = dst + (int64_t)blockIdx.y * rows * N + row * N + col;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    o[0] = acc[0];
  }
}

// out[i] = the parts' sums of output i added in order, part 0 first.
__global__ void __launch_bounds__(kThreads)
chain_step_parts_kernel(const float* __restrict__ partial, float* __restrict__ out,
                        int64_t count, int parts) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < count;
       i += (int64_t)gridDim.x * kThreads) {
    float s = partial[i];
    for (int k = 1; k < parts; ++k) s += partial[k * count + i];
    out[i] = s;
  }
}

template <bool MAJOR>
int launch(const float* T, const float* W, float* dst, int64_t rows, int64_t C, int64_t N,
           int64_t P, int R, int vec, int parts, int part_len, cudaStream_t stream) {
  const int64_t smem = 4 * (int64_t)part_len * R;
  const int64_t blocks = (rows * (N / vec) + kThreads - 1) / kThreads;
  if (smem > kMaxSmem || blocks > 0x7fffffffLL || parts > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)parts);
  if (vec == 4)
    chain_step_kernel<4, MAJOR><<<grid, kThreads, (size_t)smem, stream>>>(
        T, W, dst, rows, C, N, P, R, part_len);
  else
    chain_step_kernel<1, MAJOR><<<grid, kThreads, (size_t)smem, stream>>>(
        T, W, dst, rows, C, N, P, R, part_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (rows, N) = T (rows, C, N) contracted over C with W (C, R), float32:
// rank-minor (major = 0: rows = P, N = Q R, column n of rank n % R) or
// rank-major (major = 1: rows = R P, N = Q, row i of rank i / P). vec:
// columns a thread (4: N % 4 == 0, T and out 16-byte aligned; or 1).
// parts parts of part_len
// rows of C (the last may be short): with parts > 1, partial holds
// (parts, rows, N) floats and a second launch adds them into out.
int pp_chain_step(const float* T, const float* W, float* partial, float* out, int64_t rows,
                  int64_t C, int64_t N, int64_t P, int R, int major, int vec, int parts,
                  int part_len, cudaStream_t stream) {
  if (rows <= 0 || C <= 0 || N <= 0 || P <= 0 || R <= 0 || parts <= 0 || part_len <= 0 ||
      (int64_t)parts * part_len < C || (int64_t)(parts - 1) * part_len >= C ||
      (parts > 1 && partial == nullptr) || (major ? rows % P != 0 || rows / P != R
                                                   : N % R != 0))
    return (int)cudaErrorInvalidValue;
  if (vec != 1 && vec != 4) return (int)cudaErrorInvalidValue;
  float* dst = parts > 1 ? partial : out;
  if (vec == 4 &&
      (N % 4 != 0 || reinterpret_cast<uintptr_t>(T) % 16 != 0 ||
       reinterpret_cast<uintptr_t>(dst) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const int code = major ? launch<true>(T, W, dst, rows, C, N, P, R, vec, parts, part_len,
                                        stream)
                         : launch<false>(T, W, dst, rows, C, N, P, R, vec, parts, part_len,
                                         stream);
  if (code != 0 || parts == 1) return code;
  const int64_t count = rows * N;
  const int64_t tiles = (count + kThreads - 1) / kThreads;
  const int64_t blocks = tiles < (1 << 16) ? tiles : (1 << 16);
  chain_step_parts_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(partial, out, count,
                                                                     parts);
  return (int)cudaGetLastError();
}

}  // extern "C"
