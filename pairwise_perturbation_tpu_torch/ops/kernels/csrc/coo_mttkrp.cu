// Sparse COO MTTKRP for Hopper (sm_90a):
//   M[i, r] = sum_n v_n * prod_{j != mode} W_j[idx_j[n], r]
//
// Replaces the Pallas kernel behind
// pairwise_perturbation_tpu/ops/kernels/coo_pallas.py::coo_mttkrp (_kernel),
// which forms the gathers and the scatter as one-hot matmuls in VMEM. The
// H100 has fast random access, so this kernel gathers factor rows directly
// and reduces without one-hots and without atomics.
//
// Inputs, from the wrapper's per-mode setup (ops/kernels/coo_mttkrp.py):
// the nonzeros stably sorted by their mode index, as idxT (order, nnz)
// int32 (one contiguous row per mode) and values (nnz,) f32, and chunks of
// at most CHUNK sorted nonzeros that never cross a row: chunk c spans
// [chunk_ptr[c], chunk_ptr[c + 1]), and row i owns chunks
// [row_chunk_ptr[i], row_chunk_ptr[i + 1]). Factors are (s_j, R) row-major
// f32; out is (s_mode, R).
//
// What bounds it on the H100: each nonzero costs (order - 1) R multiplies
// and R adds against 4 (order - 1) + 4 bytes of indices and value read once
// from device memory, so the stream of indices is the floor (32 MB per
// MTTKRP at 1.6M nonzeros of order 4: ~10 us at 3.35 TB/s). The factor
// rows are gathered at random; they sit in shared memory when every factor
// but the mode's fits in the wrapper's cap, and are read through L2
// otherwise (the order-3 NELL-2 shape: 2 MB of factors).
//
// * Launch 1: one warp per chunk, in a grid sized to the blocks that fit
//   on the card at once, which walks the chunks in a grid-stride loop, so
//   the factors are staged into shared memory once per resident block.
//   Lane l takes the chunk's nonzeros l, l + 32, ...; each forms the
//   products of RC ranks in registers in mode order, v * W_0 * W_1 ...
//   (the plain version's order, so products agree bit for bit) and sums
//   its nonzeros; a butterfly of shuffles sums the 32 lanes, and the warp
//   writes the chunk's (R,) partial. Ranks are processed RC at a time
//   (common.cuh rank_chunk), any R.
// * Launch 2: one warp per row sums its chunks' partials (lane l takes
//   chunks l, l + 32, ..., then the same butterfly) into out[i, :]; a row
//   with no chunk is written as zeros.
// Both assignments are fixed by the chunk plan alone, so two runs on the
// same inputs agree bit for bit. Indices are int32 (the JAX dtype); every
// offset into idxT, the factors and the partials is int64.
//
// The entry launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

#include "common.cuh"

namespace {

using pp::rank_chunk;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOrder = 16;  // ops/kernels/coo_mttkrp.py MAX_ORDER

struct Factors {
  const float* W[kMaxOrder];    // factor j, (rows of mode j, R)
  int64_t len[kMaxOrder];       // its floats: rows * R (0 for the mode's own)
  int64_t smem_off[kMaxOrder];  // float offset of factor j in shared memory
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Launch 1. grid: resident blocks (grid-stride over chunks), kThreads.
template <int RC, bool kSmem>
__global__ void __launch_bounds__(kThreads)
coo_chunks_kernel(const int* __restrict__ idxT, const float* __restrict__ vals,
                  Factors f, int order, int mode, int64_t nnz, int R,
                  const int64_t* __restrict__ chunk_ptr, int64_t n_chunks,
                  float* __restrict__ partial) {
  extern __shared__ __align__(16) float w_s[];
  if (kSmem) {
    for (int j = 0; j < order; ++j) {
      float* dst = w_s + f.smem_off[j];
      for (int64_t t = threadIdx.x; t < f.len[j]; t += kThreads) dst[t] = __ldg(f.W[j] + t);
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t c = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); c < n_chunks;
       c += n_warps) {
    const int64_t begin = chunk_ptr[c], end = chunk_ptr[c + 1];
    for (int r0 = 0; r0 < R; r0 += RC) {
      float acc[RC];
#pragma unroll
      for (int r = 0; r < RC; ++r) acc[r] = 0.f;
      for (int64_t n = begin + lane; n < end; n += 32) {
        const float v = __ldg(vals + n);
        float p[RC];
#pragma unroll
        for (int r = 0; r < RC; ++r) p[r] = v;
        for (int j = 0; j < order; ++j) {
          if (j == mode) continue;
          const int64_t row = __ldg(idxT + (int64_t)j * nnz + n);
          const int64_t at = row * R + r0;
          const float* w = kSmem ? w_s + f.smem_off[j] + at : f.W[j] + at;
#pragma unroll
          for (int r = 0; r < RC; ++r)
            if (r0 + r < R) p[r] *= kSmem ? w[r] : __ldg(w + r);
        }
#pragma unroll
        for (int r = 0; r < RC; ++r) acc[r] += p[r];
      }
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const float s = warp_sum(acc[r]);
        if (lane == r && r0 + r < R) partial[c * R + r0 + r] = s;
      }
    }
  }
}

// Launch 2. grid ceil(n_rows / kWarps), kThreads: one warp per row.
__global__ void __launch_bounds__(kThreads)
coo_rows_kernel(const float* __restrict__ partial, const int64_t* __restrict__ row_chunk_ptr,
                float* __restrict__ out, int64_t n_rows, int R) {
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t c0 = row_chunk_ptr[row], c1 = row_chunk_ptr[row + 1];
  for (int r = 0; r < R; ++r) {
    float v = 0.f;
    for (int64_t c = c0 + lane; c < c1; c += 32) v += partial[c * R + r];
    v = warp_sum(v);
    if (lane == 0) out[row * R + r] = v;
  }
}

template <int RC, bool kSmem>
cudaError_t launch_chunks(const int* idxT, const float* vals, const Factors& f, int order,
                          int mode, int64_t nnz, int R, const int64_t* chunk_ptr,
                          int64_t n_chunks, float* partial, int64_t smem,
                          cudaStream_t stream) {
  auto kernel = coo_chunks_kernel<RC, kSmem>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                          (size_t)smem)) != cudaSuccess)
    return err;
  const int64_t want = (n_chunks + kWarps - 1) / kWarps;
  const int64_t fit = (int64_t)(per_sm > 0 ? per_sm : 1) * n_sm;
  const unsigned blocks = (unsigned)(want < fit ? want : fit);
  kernel<<<blocks, kThreads, (size_t)smem, stream>>>(idxT, vals, f, order, mode, nnz, R,
                                                     chunk_ptr, n_chunks, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K7: out (sizes[mode], R) from the sorted COO of one mode (see the header).
// Ws and sizes are host arrays of `order` factor pointers and mode sizes;
// smem is the shared-memory bytes of the factors other than the mode's
// (their rows * R * 4 in mode order), or 0 to read them through L2;
// partial is (n_chunks, R) f32 scratch.
int pp_coo_mttkrp(const int* idxT, const float* vals, const float* const* Ws,
                  const int64_t* sizes, int order, int mode, int64_t nnz, int R,
                  const int64_t* chunk_ptr, int64_t n_chunks, const int64_t* row_chunk_ptr,
                  float* partial, float* out, int64_t smem, cudaStream_t stream) {
  if (order < 2 || order > kMaxOrder || mode < 0 || mode >= order || nnz <= 0 || R <= 0 ||
      n_chunks <= 0 || smem < 0)
    return (int)cudaErrorInvalidValue;
  Factors f;
  int64_t off = 0;
  for (int j = 0; j < kMaxOrder; ++j) {
    f.W[j] = j < order ? Ws[j] : nullptr;
    f.len[j] = j < order && j != mode ? sizes[j] * R : 0;
    f.smem_off[j] = off;
    off += f.len[j];
  }
  if (smem > 0 && smem != off * 4) return (int)cudaErrorInvalidValue;
  const int rc = rank_chunk(R);
  cudaError_t err;
  if (smem > 0) {
    PP_DISPATCH_RC(rc, err = launch_chunks<RC, true>(idxT, vals, f, order, mode, nnz, R,
                                                     chunk_ptr, n_chunks, partial, smem,
                                                     stream));
  } else {
    PP_DISPATCH_RC(rc, err = launch_chunks<RC, false>(idxT, vals, f, order, mode, nnz, R,
                                                      chunk_ptr, n_chunks, partial, 0,
                                                      stream));
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t n_rows = sizes[mode];
  coo_rows_kernel<<<(unsigned)((n_rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      partial, row_chunk_ptr, out, n_rows, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
