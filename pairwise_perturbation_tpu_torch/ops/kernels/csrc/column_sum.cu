// Column sums of V viewed as (P, B, M), for Hopper (sm_90a): a
// read-bandwidth probe.
//
// Replaces scripts/bench_midvariants.py::_copy_kernel (S4), the Pallas
// "DMA-only" pass that reduces each (B, L) block of V over B:
//   out[p, 0, m] = sum_b V[p, b, m]                            (P, 1, M)
// V and the output are float32. The JAX script pads the output to whole
// lane tiles; this kernel writes exactly M columns.
//
// What bounds it on the H100: memory bandwidth, and nothing else. It
// reads every byte of V once (1.416 GB at the coil-100 shape) and does
// one add per element, so its time is a measure of the read rate the
// first-level contraction kernels can reach at best (~0.43 ms at
// 3.35 TB/s). It is the column walk of mid_contract.cu with W = 1:
// * thread t of a block owns column m0 + t of one p, so each warp load of
//   a V row is 128 contiguous bytes; the ragged last tile is masked;
// * each thread sums its column over b in one register, the loop
//   unrolled by 8 so that eight independent loads are in flight per
//   thread;
// * no shared memory and no atomics: every output is one thread's
//   sequential sum, so runs repeat bit for bit.
//
// The entry launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

#include "common.cuh"

namespace {

constexpr int kCols = 256;  // columns (threads) per block

__global__ void __launch_bounds__(kCols)
column_sum_kernel(const float* __restrict__ V, float* __restrict__ out, int64_t B,
                  int64_t M, int64_t n_tiles) {
  const int64_t p = blockIdx.x / n_tiles;
  const int64_t m = (blockIdx.x - p * n_tiles) * kCols + threadIdx.x;
  if (m >= M) return;
  const float* v = V + p * B * M + m;
  float acc = 0.f;
#pragma unroll 8
  for (int64_t b = 0; b < B; ++b) acc += __ldg(v + b * M);
  out[p * M + m] = acc;
}

}  // namespace

extern "C" {

// S4: out (P, 1, M) = the sums over b of V (P, B, M), float32.
int pp_column_sum(const float* V, float* out, int64_t P, int64_t B, int64_t M,
                  cudaStream_t stream) {
  if (P <= 0 || B <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = (M + kCols - 1) / kCols;
  if (P * n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  column_sum_kernel<<<(unsigned)(P * n_tiles), kCols, 0, stream>>>(V, out, B, M,
                                                                   n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
