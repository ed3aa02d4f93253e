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
// float32 V in the rank-minor layout with M % 4 == 0 at a 16-byte boundary
// (K4 on the package's route, DT node (1, 2) at 512^3) takes its own loop
// instead (path "f32v", mid_contract_f32v_kernel). At 512^3 mode 0 (P = 1,
// B = 512, M = 262144) the template above gives each thread one 4-byte
// load a row, at most 4 in flight, and stops the block at two barriers
// every 64 rows to restage W with the load pipe drained; its 1024 blocks
// are under one wave. The f32v loop keeps the same one-thread sums but:
// * a thread owns 4 consecutive columns and loads them as one 16-byte
//   __ldcs a row; rows go in groups of 4, the next group's loads issued
//   before the current group's FMAs (4 to 8 rows, 64 to 128 bytes, in
//   flight a thread), so at P = 1 the 512 blocks of 128 threads keep
//   ~32 KB a SM in flight without more blocks;
// * W's rank chunk is staged once, whole, in dynamic shared memory by
//   4-byte cp.async copies (zero past B, R and the chunk), rows padded to
//   a multiple of 4 floats and read as float4 broadcasts: no barrier in
//   the row loop. Only a W chunk above 48 KB (B x RC > 12288 at RC 16) is
//   cut into a few chunks of w_rows rows, a barrier pair each;
// * accumulators for the chunk's exact ranks (an instance per RC = 1 ...
//   16; R above 16 in ceil(R / 16) equal chunks, grid y, each a re-read
//   of V), so R = 10 runs no padded FMA;
// * the (4 x RC) sums go through the shared buffer as the block's
//   (512 x RC) tile, written out as contiguous 16-byte stores when one
//   chunk covers R.
//
// bf16 V with M % 8 == 0 at a 16-byte boundary takes the tensor cores
// instead (path "mma", mid_contract_mma_kernel): the JAX rule for bf16 V is
// bf16 operands with f32 sums, which is mma.sync m16n8k16 bf16 -> f32. The
// loop above gives a thread one 2-byte element per b and ~18 instructions
// for it (a load, a shift, three broadcast reads of W, twelve FMAs), near
// what an SM issues at the read rate (48% of the bound by events). On the
// tensor cores:
// * W^T (16 ranks of a chunk x 16 b, bf16) is the A operand, read from L1
//   (the wrapper's zero-padded W^T, ops/kernels/_mma.py wt_bf16); V is the
//   B operand. A warp owns 64 columns m of one p; for each k tile of 16
//   rows b, lane (g, t) loads 16 bytes (columns m0 + 8g ... m0 + 8g + 7)
//   of rows 2t, 2t + 1, 2t + 8 and 2t + 9: each load is a coalesced
//   128-byte run of its row. PRMT pairs rows (2t, 2t + 1) and (2t + 8,
//   2t + 9) element by element into B fragments, so mma j (j = 0 ... 7)
//   has column n = g at m = m0 + 8g + j: 8 mmas a k tile, 2 k tiles of
//   loads in flight, rows past B loaded as zeros.
// * After the k tiles lane (g, t) holds ranks g and g + 8 at m = m0 + 16t
//   ... m0 + 16t + 15, 16 contiguous floats each: rank-major and
//   rank-outer output is stored from them as 16-byte writes; the
//   rank-minor layout goes through a (64 x 17) tile of shared memory per
//   warp, written out as one run when the chunk covers R.
// * block_cols (128, 256, 512) is the column tile of a block, 64 a warp.
// Every output is one warp's fixed sequence of mmas: runs repeat bit for
// bit.
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

// ---- float32 V, rank-minor output, 16-byte loads (the wrapper's path "f32v") ----

constexpr int kV4Threads = 128;          // threads of a block
constexpr int kV4Cols = 4 * kV4Threads;  // columns of M a block, 4 a thread
constexpr int kV4Group = 4;              // rows of a load group; two in flight
constexpr int kV4MaxRanks = 16;          // ranks of a pass at most
constexpr int kV4MaxSmem = 48 * 1024;    // dynamic shared memory of a block at most

// W's row stride in shared memory: RC rounded up to whole float4s.
template <int RC>
__host__ __device__ constexpr int w_stride() {
  return (RC + 3) / 4 * 4;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Rows b ... b + kV4Group - 1 of the thread's 4 columns (zeros past n).
__device__ __forceinline__ void load_group(float4 (&y)[kV4Group], const float* v, int b, int n,
                                           int64_t M) {
#pragma unroll
  for (int u = 0; u < kV4Group; ++u)
    y[u] = b + u < n ? __ldcs(reinterpret_cast<const float4*>(v + (int64_t)(b + u) * M))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
}

// acc[j RC + r] += y[u].j * w[u][r], row u after row u - 1 (w: the
// group's first row of W in shared memory).
template <int RC>
__device__ __forceinline__ void fma_group(const float4 (&y)[kV4Group], const float* w,
                                          float (&acc)[4 * RC]) {
  constexpr int S = w_stride<RC>();
#pragma unroll
  for (int u = 0; u < kV4Group; ++u) {
    const float* wr = w + u * S;
    float c[RC];
#pragma unroll
    for (int q = 0; q < RC / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(wr)[q];
      c[4 * q] = t.x;
      c[4 * q + 1] = t.y;
      c[4 * q + 2] = t.z;
      c[4 * q + 3] = t.w;
    }
    if constexpr (RC % 4 >= 2) {
      const float2 t = *reinterpret_cast<const float2*>(wr + RC / 4 * 4);
      c[RC / 4 * 4] = t.x;
      c[RC / 4 * 4 + 1] = t.y;
    }
    if constexpr (RC % 2 == 1) c[RC - 1] = wr[RC - 1];
    const float x[4] = {y[u].x, y[u].y, y[u].z, y[u].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < RC; ++r) acc[j * RC + r] = fmaf(x[j], c[r], acc[j * RC + r]);
  }
}

// grid (P * n_tiles, ceil(R / RC)), kV4Threads threads, dynamic shared
// memory 4 max(w_rows S, kV4Cols RC) bytes. V (P, B, M) float32, 16-byte
// aligned, M % 4 == 0; out (P, M, R) 16-byte aligned; w_rows % (2
// kV4Group) == 0.
template <int RC>
__global__ void __launch_bounds__(kV4Threads, 4)
mid_contract_f32v_kernel(const float* __restrict__ V, const float* __restrict__ W,
                         float* __restrict__ out, int64_t P, int64_t B, int64_t M, int R,
                         int64_t n_tiles, int w_rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int S = w_stride<RC>();
  const int64_t p = blockIdx.x / n_tiles;
  const int64_t m0 = (blockIdx.x - p * n_tiles) * kV4Cols;
  const int r0 = blockIdx.y * RC;
  const int tid = threadIdx.x;
  const bool live = m0 + 4 * tid < M;  // the thread's 4 columns: all in or all out
  const float* v = V + p * B * M + m0 + 4 * tid;

  float acc[4 * RC];  // column 4 tid + j, rank r0 + r at j RC + r
#pragma unroll
  for (int i = 0; i < 4 * RC; ++i) acc[i] = 0.f;

  for (int64_t c0 = 0; c0 < B; c0 += w_rows) {
    const int n = (int)min64(w_rows, B - c0);                          // rows of V
    const int n_pad = (n + 2 * kV4Group - 1) / (2 * kV4Group) * (2 * kV4Group);  // of W
    if (c0 > 0) __syncthreads();  // the previous chunk is no longer read
    for (int t = tid; t < n_pad * S; t += kV4Threads) {
      const int bb = t / S, rr = t - bb * S;
      const bool valid = bb < n && rr < RC && r0 + rr < R;
      cp_async4(smem + t, valid ? W + (c0 + bb) * R + r0 + rr : W, valid);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (live) {
      const float* vc = v + c0 * M;
      float4 ya[kV4Group], yb[kV4Group];
      load_group(ya, vc, 0, n, M);
      for (int b = 0; b < n; b += 2 * kV4Group) {
        load_group(yb, vc, b + kV4Group, n, M);
        fma_group<RC>(ya, smem + b * S, acc);
        load_group(ya, vc, b + 2 * kV4Group, n, M);
        fma_group<RC>(yb, smem + (b + kV4Group) * S, acc);
      }
    }
  }

  __syncthreads();  // W is no longer read: the buffer takes the output tile
  if (live) {
    // column 4 tid + j, rank r at (4 tid + j) RC + r: acc as it is
    float4* o4 = reinterpret_cast<float4*>(smem + 4 * tid * RC);
#pragma unroll
    for (int k = 0; k < RC; ++k)
      o4[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
  }
  __syncthreads();
  const int64_t cols = min64(kV4Cols, M - m0);
  if (R == RC) {  // one chunk covers R: the tile is one run of the output
    const float4* s4 = reinterpret_cast<const float4*>(smem);
    float4* d4 = reinterpret_cast<float4*>(out + (p * M + m0) * R);
    for (int64_t e = tid; e < cols * RC / 4; e += kV4Threads) d4[e] = s4[e];
    return;
  }
  const int rcv = R - r0 < RC ? R - r0 : RC;  // ranks of this chunk
  float* dst = out + (p * M + m0) * R + r0;
  for (int64_t e = tid; e < cols * rcv; e += kV4Threads) {
    const int64_t c = e / rcv;
    const int r = (int)(e - c * rcv);
    dst[c * R + r] = smem[c * RC + r];
  }
}

template <int RC>
int launch_f32v(const float* V, const float* W, float* out, int64_t P, int64_t B, int64_t M,
                int R, int w_rows, cudaStream_t stream) {
  constexpr int S = w_stride<RC>();
  const int64_t smem = 4 * (w_rows * S > kV4Cols * RC ? (int64_t)w_rows * S : kV4Cols * RC);
  if (smem > kV4MaxSmem) return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = (M + kV4Cols - 1) / kV4Cols;
  if (P * n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(P * n_tiles), (unsigned)((R + RC - 1) / RC));
  mid_contract_f32v_kernel<RC><<<grid, kV4Threads, (size_t)smem, stream>>>(
      V, W, out, P, B, M, R, n_tiles, w_rows);
  return (int)cudaGetLastError();
}

// ---- bf16 V on the tensor cores (the wrapper's path "mma") ----

constexpr int kMmaCols = 64;   // columns of M a warp
constexpr int kMmaUnroll = 2;  // k tiles whose loads are issued together

// The lane's 16 bytes of rows k0 + 2t, + 1, + 8, + 9 (zeros past B or for
// a dead column group), as y[q][0..3].
__device__ __forceinline__ void load_k_tile(uint32_t (&y)[4][4], const uint16_t* vp, int64_t k0,
                                            int t, int64_t B, int64_t M, bool live) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t row = k0 + 2 * t + (q & 1) + 8 * (q >> 1);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (live && row < B) v = __ldcs(reinterpret_cast<const uint4*>(vp + row * M));
    y[q][0] = v.x;
    y[q][1] = v.y;
    y[q][2] = v.z;
    y[q][3] = v.w;
  }
}

// The 8 mmas of k tile kt: A is W^T's ranks g (w_lo) and g + 8 (w_hi) at k
// columns 2t, 2t + 1 and 2t + 8, 2t + 9 of the tile (w_lo and w_hi already
// point at word t of their rows); mma j's B pairs element j of rows 2t and
// 2t + 1 (b0) and of rows 2t + 8 and 2t + 9 (b1).
__device__ __forceinline__ void mma_k_tile(const uint32_t (&y)[4][4], const uint32_t* w_lo,
                                           const uint32_t* w_hi, int64_t kt,
                                           float (&acc)[8][4]) {
  const uint32_t a0 = __ldg(w_lo + 8 * kt), a1 = __ldg(w_hi + 8 * kt);
  const uint32_t a2 = __ldg(w_lo + 8 * kt + 4), a3 = __ldg(w_hi + 8 * kt + 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
    const uint32_t b0 = __byte_perm(y[0][j >> 1], y[1][j >> 1], sel);
    const uint32_t b1 = __byte_perm(y[2][j >> 1], y[3][j >> 1], sel);
    pp::mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
  }
}

// grid (P * n_tiles, rank chunks of 16), COLS / 2 threads (64 columns a
// warp). V (P, B, M) bf16, 16-byte aligned, M % 8 == 0; Wt is W^T in bf16,
// (16 x rank chunks, ldw), ldw % 32 == 0 and >= B, zero past R and B.
template <int COLS, bool MINOR>
__global__ void __launch_bounds__(COLS / 2, 1024 / COLS)
mid_contract_mma_kernel(const uint16_t* __restrict__ V, const uint16_t* __restrict__ Wt,
                        int64_t ldw, float* __restrict__ out, int64_t P, int64_t B, int64_t M,
                        int R, int64_t n_tiles, int layout) {
  __shared__ float o_s[MINOR ? COLS * 17 : 1];
  const int64_t p = blockIdx.x / n_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t m0 = (blockIdx.x - p * n_tiles) * COLS + warp * kMmaCols;
  if (m0 >= M) return;  // a warp past M; no block barrier below
  const int r0 = blockIdx.y * 16;
  const bool live = m0 + 8 * g < M;  // the lane's 8 columns: all in or all out (M % 8 == 0)
  const uint16_t* vp = V + p * B * M + m0 + 8 * g;
  const uint32_t* w_lo = reinterpret_cast<const uint32_t*>(Wt + (int64_t)(r0 + g) * ldw) + t;
  const uint32_t* w_hi = reinterpret_cast<const uint32_t*>(Wt + (int64_t)(r0 + g + 8) * ldw) + t;

  float acc[8][4] = {};
  const int64_t k_tiles = (B + 15) / 16;
  int64_t kt = 0;
  for (; kt + kMmaUnroll <= k_tiles; kt += kMmaUnroll) {
    uint32_t y[kMmaUnroll][4][4];
#pragma unroll
    for (int u = 0; u < kMmaUnroll; ++u) load_k_tile(y[u], vp, 16 * (kt + u), t, B, M, live);
#pragma unroll
    for (int u = 0; u < kMmaUnroll; ++u) mma_k_tile(y[u], w_lo, w_hi, kt + u, acc);
  }
  for (; kt < k_tiles; ++kt) {
    uint32_t y[4][4];
    load_k_tile(y, vp, 16 * kt, t, B, M, live);
    mma_k_tile(y, w_lo, w_hi, kt, acc);
  }

  // acc[j][i]: rank r0 + g + 8 (i >> 1) at m = m0 + 16t + 8 (i & 1) + j
  if (!MINOR) {
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int r = r0 + g + 8 * rh;
      if (r >= R) continue;
      float* dst = out + (layout == kRankOuter ? (r * P + p) * M : (p * R + r) * M) + m0 + 16 * t;
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        if (m0 + 16 * t + 8 * ch >= M) continue;
        const int i = 2 * rh + ch;
        float4* d4 = reinterpret_cast<float4*>(dst + 8 * ch);
        d4[0] = make_float4(acc[0][i], acc[1][i], acc[2][i], acc[3][i]);
        d4[1] = make_float4(acc[4][i], acc[5][i], acc[6][i], acc[7][i]);
      }
    }
    return;
  }
  float* o = o_s + warp * kMmaCols * 17;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[(16 * t + 8 * (i & 1) + j) * 17 + g + 8 * (i >> 1)] = acc[j][i];
  __syncwarp();
  const int cols = (int)min64(kMmaCols, M - m0);
  const int rcv = R - r0 < 16 ? R - r0 : 16;  // ranks of this chunk
  float* dst = out + (p * M + m0) * R + r0;
  for (int e = lane; e < cols * rcv; e += 32) {
    const int c = e / rcv, r = e - c * rcv;
    dst[(int64_t)c * R + r] = o[c * 17 + r];
  }
}

template <int COLS, bool MINOR>
int launch_mma(const uint16_t* V, const uint16_t* Wt, int64_t ldw, float* out, int64_t P,
               int64_t B, int64_t M, int R, int layout, cudaStream_t stream) {
  const int64_t n_tiles = (M + COLS - 1) / COLS;
  if (P * n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(P * n_tiles), (unsigned)((R + 15) / 16));
  mid_contract_mma_kernel<COLS, MINOR><<<grid, COLS / 2, 0, stream>>>(V, Wt, ldw, out, P, B, M, R,
                                                                     n_tiles, layout);
  return (int)cudaGetLastError();
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

// K4 with float32 V on the 16-byte-load loop (the wrapper's path "f32v"):
// out (P, M, R) from V (P, B, M) float32, M % 4 == 0, V and out 16-byte
// aligned, W (B, R) float32; rc ranks a pass (1 ... 16, ceil(R / rc)
// passes), w_rows rows of W staged a pass (a multiple of 8, at most 48 KB
// of shared memory with the output tile).
int pp_mid_contract_f32v(const float* V, const float* W, float* out, int64_t P, int64_t B,
                         int64_t M, int R, int rc, int w_rows, cudaStream_t stream) {
  if (P <= 0 || B <= 0 || M <= 0 || R <= 0 || M % 4 != 0 || rc < 1 || rc > kV4MaxRanks ||
      w_rows <= 0 || w_rows % (2 * kV4Group) != 0 ||
      reinterpret_cast<uintptr_t>(V) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch (rc) {
#define PP_F32V_CASE(N) \
  case N: return launch_f32v<N>(V, W, out, P, B, M, R, w_rows, stream);
    PP_F32V_CASE(1) PP_F32V_CASE(2) PP_F32V_CASE(3) PP_F32V_CASE(4)
    PP_F32V_CASE(5) PP_F32V_CASE(6) PP_F32V_CASE(7) PP_F32V_CASE(8)
    PP_F32V_CASE(9) PP_F32V_CASE(10) PP_F32V_CASE(11) PP_F32V_CASE(12)
    PP_F32V_CASE(13) PP_F32V_CASE(14) PP_F32V_CASE(15) PP_F32V_CASE(16)
#undef PP_F32V_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same with bf16 V on the tensor cores (the wrapper's path "mma"): V
// (P, B, M) bf16, M % 8 == 0, V and Wt 16-byte aligned; Wt (16 x ceil(R /
// 16), ldw) bf16 is W^T zero past R and B, ldw % 32 == 0 and >= B.
int pp_mid_contract_mma(const void* V, const void* Wt, int64_t ldw, float* out, int64_t P,
                        int64_t B, int64_t M, int R, int layout, int cols,
                        cudaStream_t stream) {
  if (P <= 0 || B <= 0 || M <= 0 || R <= 0 || M % 8 != 0 || ldw % 32 != 0 || ldw < B ||
      reinterpret_cast<uintptr_t>(V) % 16 != 0 || reinterpret_cast<uintptr_t>(Wt) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const uint16_t* v = static_cast<const uint16_t*>(V);
  const uint16_t* w = static_cast<const uint16_t*>(Wt);
  if (layout == kRankMinor)
    return cols == 256 ? launch_mma<256, true>(v, w, ldw, out, P, B, M, R, layout, stream)
                       : (int)cudaErrorInvalidValue;
  if (layout != kRankMajor && layout != kRankOuter) return (int)cudaErrorInvalidValue;
  switch (cols) {
    case 128: return launch_mma<128, false>(v, w, ldw, out, P, B, M, R, layout, stream);
    case 256: return launch_mma<256, false>(v, w, ldw, out, P, B, M, R, layout, stream);
    case 512: return launch_mma<512, false>(v, w, ldw, out, P, B, M, R, layout, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
