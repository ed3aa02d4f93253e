// The PP cache build's three chain roots of an order-4 tensor in one pass
// over V, for Hopper (sm_90a).
//
// Replaces pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py::
// triple_roots and its Pallas kernel _triple_kernel. With V (P, B1, B2, M):
//   O1[r, p, b2, m] = sum_b1 V[p, b1, b2, m] W1[b1, r]    (R, P, B2, M)
//   O2[r, p, b1, m] = sum_b2 V[p, b1, b2, m] W2[b2, r]    (R, P, B1, M)
//   O3[r, p, b1, b2] = sum_m V[p, b1, b2, m] W3[m, r]     (R, P, B1, B2)
// V is float32 or bfloat16 (widened exactly); W1..W3 are float32, already
// rounded to V's type by the caller; sums and outputs are float32.
//
// What bounds it on the H100: V's bytes (1.4 GB f32 at the coil-100 shape)
// against 3R FMAs per element, near the card's FP32 balance at R = 10, so
// the design reads V once (the einsum chain it replaces reads it three
// times) and keeps the partial sums on chip where it can:
// * A block owns one p and a tile of L consecutive columns m (L = 32 when
//   shared memory allows, the wrapper's choice) and walks b1 outer, b2
//   inner. Thread t owns column t % L and the b2 values t / L + k * 512 / L,
//   so each warp reads whole rows of L contiguous elements; the ragged last
//   tile is masked per thread (no padded copy, no out-of-bounds read).
// * O2 (sum over the inner b2) is summed in registers, then across the
//   threads that share a column through shared memory, in a fixed order,
//   and written once per (b1, tile).
// * O1 (sum over the outer b1) lives in shared memory for the whole tile:
//   B2 * L * RC floats (164 KB at B2 = 128, L = 32, R = 10), each entry
//   owned by one thread, and is written once at the end.
// * O3 (sum over m) needs every tile of m. Blocks run in no order, so each
//   block writes its tile's partial (R, B1, B2) to scratch the caller
//   allocates, and a second launch sums the tiles in order, as the mode-2
//   MTTKRP kernel does. The Pallas version's accumulation over a
//   sequential lane grid has no Hopper counterpart.
// * Ranks go RC at a time (RC even, at most 16); more ranks add a grid
//   dimension, which re-reads V.
// Arithmetic is FP32 FMA on the CUDA cores. No atomics: results repeat bit
// for bit.
//
// The entry launches on the given stream, does not synchronise, allocates
// nothing, and returns the first CUDA error (0 = both passes launched).

#include "common.cuh"

namespace {

using pp::load_f32;

constexpr int kThreads = 512;
constexpr int kBatch = 4;  // V loads each thread issues together

// Shared-memory row stride of the O1 accumulator: even, for float2
// access, with an odd number of float2 words, so the float2 accesses of a
// half-warp fall in distinct bank pairs.
__host__ __device__ constexpr int acc_stride(int rc) { return rc % 4 == 2 ? rc : rc + 2; }

template <typename T, int RC>
__global__ void __launch_bounds__(kThreads)
triple_roots_kernel(const T* __restrict__ V, const float* __restrict__ W1,
                    const float* __restrict__ W2, const float* __restrict__ W3,
                    float* __restrict__ O1, float* __restrict__ O2,
                    float* __restrict__ part3, int64_t P, int64_t B1, int64_t B2,
                    int64_t M, int R, int L, int64_t n_tiles) {
  constexpr int RS = acc_stride(RC);
  extern __shared__ __align__(16) float smem[];
  const int64_t p = blockIdx.x / n_tiles;
  const int64_t m0 = (blockIdx.x - p * n_tiles) * L;
  const int r0 = blockIdx.y * RC;
  const int rcv = R - r0 < RC ? R - r0 : RC;  // ranks of this chunk
  const int tid = threadIdx.x;
  const int mm = tid % L, slot = tid / L, n_slots = kThreads / L;
  const bool live = m0 + mm < M;

  float* acc1 = smem;                    // [b2][column][RS]: O1 sums
  float* w2_s = acc1 + B2 * L * RS;      // [b2][RC]
  float* w3_s = w2_s + B2 * RC;          // [column][RC], 0 past M
  float* s_s = w3_s + L * RC;            // [b2][L + 1] V rows of this b1, then
                                         // [slot][column][RS] O2 partial sums

  for (int64_t e = tid; e < B2 * L * RS; e += kThreads) acc1[e] = 0.f;
  for (int64_t e = tid; e < B2 * RC; e += kThreads) {
    const int64_t b = e / RC;
    const int r = (int)(e - b * RC);
    w2_s[e] = r0 + r < R ? W2[b * R + r0 + r] : 0.f;
  }
  for (int e = tid; e < L * RC; e += kThreads) {
    const int c = e / RC, r = e - c * RC;
    w3_s[e] = (m0 + c < M && r0 + r < R) ? W3[(m0 + c) * R + r0 + r] : 0.f;
  }
  __syncthreads();

  const int64_t B1B2 = B1 * B2;
  for (int64_t b1 = 0; b1 < B1; ++b1) {
    float w1[RC], o2[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      w1[r] = r0 + r < R ? __ldg(W1 + b1 * R + r0 + r) : 0.f;
      o2[r] = 0.f;
    }
    const T* Vb = V + (p * B1 + b1) * B2 * M + m0 + mm;
    for (int64_t b2 = slot; b2 < B2; b2 += kBatch * n_slots) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t bb = b2 + u * n_slots;
        v[u] = (live && bb < B2) ? load_f32(Vb + bb * M) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t bb = b2 + u * n_slots;
        if (bb >= B2) break;
        s_s[bb * (L + 1) + mm] = v[u];
        const float2* w2 = reinterpret_cast<const float2*>(w2_s + bb * RC);
        float2* a = reinterpret_cast<float2*>(acc1 + (bb * L + mm) * RS);
#pragma unroll
        for (int q = 0; q < RC / 2; ++q) {
          const float2 c = w2[q];
          o2[2 * q] = fmaf(v[u], c.x, o2[2 * q]);
          o2[2 * q + 1] = fmaf(v[u], c.y, o2[2 * q + 1]);
          float2 x = a[q];
          x.x = fmaf(v[u], w1[2 * q], x.x);
          x.y = fmaf(v[u], w1[2 * q + 1], x.y);
          a[q] = x;
        }
      }
    }
    __syncthreads();

    // O3 partial of this tile for row b1: sum over the tile's columns.
    for (int64_t b2 = tid; b2 < B2; b2 += kThreads) {
      float o3[RC];
#pragma unroll
      for (int r = 0; r < RC; ++r) o3[r] = 0.f;
      const float* s = s_s + b2 * (L + 1);
      for (int c = 0; c < L; ++c) {
        const float x = s[c];
        const float2* w3 = reinterpret_cast<const float2*>(w3_s + c * RC);
#pragma unroll
        for (int q = 0; q < RC / 2; ++q) {
          const float2 w = w3[q];
          o3[2 * q] = fmaf(x, w.x, o3[2 * q]);
          o3[2 * q + 1] = fmaf(x, w.y, o3[2 * q + 1]);
        }
      }
      float* dst = part3 + ((blockIdx.x * (int64_t)R + r0) * B1 + b1) * B2 + b2;
#pragma unroll
      for (int r = 0; r < RC; ++r)
        if (r < rcv) dst[r * B1B2] = o3[r];
    }
    __syncthreads();  // the V rows are read; s_s now takes the O2 partials

    float2* red = reinterpret_cast<float2*>(s_s + (slot * L + mm) * RS);
#pragma unroll
    for (int q = 0; q < RC / 2; ++q) red[q] = make_float2(o2[2 * q], o2[2 * q + 1]);
    __syncthreads();
    for (int e = tid; e < L * rcv; e += kThreads) {
      const int c = e % L, r = e / L;
      if (m0 + c < M) {
        float sum = 0.f;
        for (int s = 0; s < n_slots; ++s) sum += s_s[(s * L + c) * RS + r];
        O2[(((int64_t)(r0 + r) * P + p) * B1 + b1) * M + m0 + c] = sum;
      }
    }
    __syncthreads();  // s_s is rewritten by the next row
  }

  for (int64_t e = tid; e < rcv * B2 * L; e += kThreads) {
    const int c = (int)(e % L);
    const int64_t rest = e / L, b2 = rest % B2;
    const int r = (int)(rest / B2);
    if (m0 + c < M)
      O1[(((int64_t)(r0 + r) * P + p) * B2 + b2) * M + m0 + c] =
          acc1[(b2 * L + c) * RS + r];
  }
}

// Pass 2: O3[r, p, q] = sum over tiles t (in order) of part3[p, t, r, q],
// q = b1 * B2 + b2.
__global__ void triple_sum_tiles_kernel(const float* __restrict__ part3,
                                        float* __restrict__ O3, int64_t P,
                                        int64_t n_tiles, int R, int64_t B1B2) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= R * P * B1B2) return;
  const int64_t q = e % B1B2, rp = e / B1B2, p = rp % P, r = rp / P;
  float v = 0.f;
  for (int64_t t = 0; t < n_tiles; ++t) v += part3[((p * n_tiles + t) * R + r) * B1B2 + q];
  O3[e] = v;
}

template <typename T, int RC>
cudaError_t launch_tiles(const T* V, const float* W1, const float* W2, const float* W3,
                         float* O1, float* O2, float* part3, int64_t P, int64_t B1,
                         int64_t B2, int64_t M, int R, int L, int64_t n_tiles,
                         size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(triple_roots_kernel<T, RC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(P * n_tiles), (unsigned)((R + RC - 1) / RC));
  triple_roots_kernel<T, RC><<<grid, kThreads, smem, stream>>>(
      V, W1, W2, W3, O1, O2, part3, P, B1, B2, M, R, L, n_tiles);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* V, const float* W1, const float* W2, const float* W3, float* O1,
           float* O2, float* O3, float* part3, int64_t P, int64_t B1, int64_t B2,
           int64_t M, int R, int rc, int L, size_t smem, cudaStream_t stream) {
  const int64_t n_tiles = (M + L - 1) / L;
  if (P * n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (rc) {
#define PP_TRIPLE_CASE(N)                                                              \
  case N:                                                                              \
    err = launch_tiles<T, N>(V, W1, W2, W3, O1, O2, part3, P, B1, B2, M, R, L, n_tiles, \
                             smem, stream);                                            \
    break;
    PP_TRIPLE_CASE(2) PP_TRIPLE_CASE(4) PP_TRIPLE_CASE(6) PP_TRIPLE_CASE(8)
    PP_TRIPLE_CASE(10) PP_TRIPLE_CASE(12) PP_TRIPLE_CASE(14) PP_TRIPLE_CASE(16)
#undef PP_TRIPLE_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t n_out = R * P * B1 * B2;
  triple_sum_tiles_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, stream>>>(
      part3, O3, P, n_tiles, R, B1 * B2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K6: O1 (R, P, B2, M), O2 (R, P, B1, M), O3 (R, P, B1, B2) from V
// (P, B1, B2, M) (float32, or bfloat16 when v_bf16) and W1 (B1, R),
// W2 (B2, R), W3 (M, R) float32, through part3 (P, ceil(M / L), R, B1, B2)
// scratch. rc (even, 2..16) ranks per pass, L (a power of two <= 32)
// columns per block, and smem the dynamic shared-memory bytes of the
// layout above, all as the Python wrapper's plan() works them out.
int pp_triple_roots(const void* V, int v_bf16, const float* W1, const float* W2,
                    const float* W3, float* O1, float* O2, float* O3, float* part3,
                    int64_t P, int64_t B1, int64_t B2, int64_t M, int R, int rc, int L,
                    int64_t smem, cudaStream_t stream) {
  if (P <= 0 || B1 <= 0 || B2 <= 0 || M <= 0 || R <= 0 || L <= 0 || L > 32 ||
      (L & (L - 1)) != 0 || smem <= 0)
    return (int)cudaErrorInvalidValue;
  if (v_bf16)
    return launch(static_cast<const uint16_t*>(V), W1, W2, W3, O1, O2, O3, part3, P, B1,
                  B2, M, R, rc, L, (size_t)smem, stream);
  return launch(static_cast<const float*>(V), W1, W2, W3, O1, O2, O3, part3, P, B1, B2,
                M, R, rc, L, (size_t)smem, stream);
}

}  // extern "C"
