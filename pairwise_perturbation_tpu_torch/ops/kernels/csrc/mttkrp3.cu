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
// exactly once, coalesced, never writes an (I, J, R) intermediate, and
// keeps enough loads in flight to cover DRAM latency (~2 MB across the
// card at 3.35 TB/s):
//
// * V is walked as K-long fibers. A block's threads are a (rows x kcols)
//   grid over (fibers, vectors of k): each step of a block reads kcols
//   vectors of `rows` fibers, 16-byte loads (VW = 4) when K % 4 == 0 and V
//   is 16-byte aligned, scalar loads (VW = 1) otherwise, so a ragged K or
//   an offset V is handled here and never by a copy. Each thread issues
//   step_unroll() loads before it uses them, and the fiber walk has no
//   barrier.
// * The per-fiber weights (B[j,:] for mode 0, A[i,:] for mode 1,
//   A[i,:] * B[j,:] for mode 2) are staged once per block in shared
//   memory, rank-padded with zeros to RC (a multiple of 4) and read as
//   float4 broadcasts.
// * The wrapper's plan (ops/kernels/mttkrp3.py rows_plan, minor_plan; pure
//   functions of the shapes and the SM count) sizes the grid for about two
//   blocks on every SM: modes 0/1 cut each output row's fibers into parts,
//   mode 2 cuts the I J fibers into slabs and k into chunks.
// * Blocks run in parallel in no fixed order, so a sum across blocks (a
//   row's parts, mode 2's slabs) goes through partials in scratch that the
//   wrapper allocates once per plan, summed in a fixed order by a second
//   launch. No atomics: runs repeat bit for bit.
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
// Dynamic shared memory a block may take (mttkrp3.py STAGE_BYTES bounds
// the plans' staged weights; the row sums take at most 32 KB).
constexpr int kMaxSmem = 64 * 1024;

template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VW]);
template <>
__device__ __forceinline__ void load_vec<1>(const float* p, float (&x)[1]) {
  x[0] = __ldg(p);
}
template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// acc[v][r] += x[v] w[r] for the RC staged weights at w (float4 reads).
template <int VW, int RC>
__device__ __forceinline__ void fma_vec(const float (&x)[VW], const float* w,
                                        float (&acc)[VW][RC]) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < RC / 4; ++q) {
    const float4 c = w4[q];
#pragma unroll
    for (int v = 0; v < VW; ++v) {
      acc[v][4 * q + 0] = fmaf(x[v], c.x, acc[v][4 * q + 0]);
      acc[v][4 * q + 1] = fmaf(x[v], c.y, acc[v][4 * q + 1]);
      acc[v][4 * q + 2] = fmaf(x[v], c.z, acc[v][4 * q + 2]);
      acc[v][4 * q + 3] = fmaf(x[v], c.w, acc[v][4 * q + 3]);
    }
  }
}

// Loads in flight per thread and step group: fewer when the VW x RC sums
// take most of the registers.
template <int VW, int RC>
__host__ __device__ constexpr int step_unroll() {
  return VW == 1 ? 8 : (VW * RC <= 64 ? 4 : 2);
}

// ---- Modes 0 and 1 (K1, K2): the rows kernel ------------------------------
//
// out[x, r] = sum_y W[y, r] sum_k V[x, y, k] C[k, r], fiber (x, y) at
// x sx + y sy, its K floats contiguous (mode 0: x = i, y = j, W = B; mode 1:
// x = j, y = i, W = A). The plan (mttkrp3.py rows_plan) cuts each output
// row's ny fibers into `parts` parts, so that about two blocks sit on every
// SM; block (x, p) stages W's rows of its part once, then its (rows x kcols)
// threads walk the part's fibers, kcols vectors of k at a time (k_chunks
// chunks), with step_unroll() loads in flight a thread and no barrier: s[v][r] =
// sum_y V[x, y, k_v] W[y, r]; C[k, r] factors out of the fiber loop, so each
// thread then adds C[k_v, r] s[v][r] to its RC sums. A fixed xor-shuffle
// tree and a pass over the warps in order sum them into out[x, :] (one
// part) or the part's row of partial (p, nx, R), which the pass-2 kernel
// sums in part order. grid (nx, parts, ceil(R / RC)), `threads` threads,
// dynamic shared memory 4 RC max(part_len, threads / 32) bytes.

template <int RC, int VW>
__global__ void __launch_bounds__(kMaxThreads, (VW * RC <= 48) ? 2 : 1)
mttkrp3_rows_kernel(const float* __restrict__ V, const float* __restrict__ W,
                    const float* __restrict__ C, float* __restrict__ dst, int64_t nx,
                    int64_t ny, int64_t K, int R, int64_t sx, int64_t sy, int kcols, int rows,
                    int k_chunks, int64_t part_len) {
  constexpr int U = step_unroll<VW, RC>();
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int yy = tid / kcols, kx = tid - yy * kcols;
  const int64_t x = blockIdx.x;
  const int r0 = blockIdx.z * RC;
  const int64_t y0 = (int64_t)blockIdx.y * part_len;
  const int n = (int)min64(part_len, ny - y0);

  for (int t = tid; t < n * RC; t += blockDim.x) {
    const int y = t / RC, rr = t - y * RC;
    smem[t] = r0 + rr < R ? W[(y0 + y) * R + r0 + rr] : 0.f;
  }
  __syncthreads();  // the staged weights are read-only from here

  float t_acc[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) t_acc[r] = 0.f;
  if (yy < rows) {
    const float* Vx = V + x * sx + y0 * sy;
    for (int c = 0; c < k_chunks; ++c) {
      const int64_t kv = (int64_t)c * kcols + kx;
      if (kv * VW >= K) break;
      float s[VW][RC];
#pragma unroll
      for (int v = 0; v < VW; ++v)
#pragma unroll
        for (int r = 0; r < RC; ++r) s[v][r] = 0.f;
      const float* p = Vx + yy * sy + kv * VW;
      const int64_t step = (int64_t)rows * sy;
      int y = yy;
      for (; y + (U - 1) * rows < n; y += U * rows, p += U * step) {
        float xv[U][VW];
#pragma unroll
        for (int u = 0; u < U; ++u) load_vec<VW>(p + u * step, xv[u]);
#pragma unroll
        for (int u = 0; u < U; ++u) fma_vec<VW, RC>(xv[u], smem + (y + u * rows) * RC, s);
      }
      for (; y < n; y += rows, p += step) {
        float xv[VW];
        load_vec<VW>(p, xv);
        fma_vec<VW, RC>(xv, smem + y * RC, s);
      }
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        const float* Ck = C + (kv * VW + v) * R + r0;
#pragma unroll
        for (int r = 0; r < RC; ++r)
          if (r0 + r < R) t_acc[r] = fmaf(__ldg(Ck + r), s[v][r], t_acc[r]);
      }
    }
  }

  // Fixed-order block sum: an xor-shuffle tree in each warp, then the warps
  // in order.
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t_acc[r] += __shfl_xor_sync(0xffffffffu, t_acc[r], off);
  __syncthreads();  // the staged weights are no longer read
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RC; ++r) smem[warp * RC + r] = t_acc[r];
  }
  __syncthreads();
  if (tid < RC && r0 + tid < R) {
    float v = 0.f;
    for (int w = 0; w < n_warps; ++w) v += smem[w * RC + tid];
    dst[((int64_t)blockIdx.y * nx + x) * R + r0 + tid] = v;
  }
}

// ---- Mode 2 (K3) ----------------------------------------------------------
//
// M[k, r] = sum_f V[f, k] w[f, r] over the flattened fibers f = i * J + j,
// w[f, r] = A[i, r] B[j, r]: a (K, I J) x (I J, R) product whose long axis is
// the reduction. A slab's fibers are consecutive rows of V, so each step of
// a block reads rows x kcols adjacent vectors. The block stages its slab's
// weights once (in stages of `stage` fibers only when a slab outgrows that;
// at 200^3 and 512^3 one stage) and walks the slab with no barrier; then its
// rows of threads are summed in row order through shared memory into the
// slab's (K, R) partial, and the pass-2 kernel sums the partials in slab
// order.

// Pass 1. grid (n_slabs, k_chunks, ceil(R / RC)), `threads` threads, dynamic
// shared memory 4 RC max(stage, threads) bytes. Slab s covers fibers
// [s slab_len, min(I J, (s + 1) slab_len)) and writes partial + s K R.
template <int RC, int VW>
__global__ void __launch_bounds__(kMaxThreads, (VW * RC <= 64) ? 2 : 1)
mttkrp3_minor_partial_kernel(const float* __restrict__ V, const float* __restrict__ A,
                             const float* __restrict__ B, float* __restrict__ partial,
                             int64_t n_fibers, int64_t J, int64_t K, int R, int kcols,
                             int rows, int64_t slab_len, int stage) {
  constexpr int U = step_unroll<VW, RC>();
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int yy = tid / kcols, kx = tid - yy * kcols;  // yy >= rows: no fibers
  const int64_t kv = (int64_t)blockIdx.y * kcols + kx;  // this thread's vector of k
  const bool live = yy < rows && kv * VW < K;
  const int r0 = blockIdx.z * RC;
  const int64_t f_begin = (int64_t)blockIdx.x * slab_len;
  const int64_t f_end = min64(n_fibers, f_begin + slab_len);

  float acc[VW][RC];
#pragma unroll
  for (int v = 0; v < VW; ++v)
#pragma unroll
    for (int r = 0; r < RC; ++r) acc[v][r] = 0.f;

  for (int64_t s0 = f_begin; s0 < f_end; s0 += stage) {
    const int n = (int)min64(stage, f_end - s0);
    if (s0 != f_begin) __syncthreads();  // the last stage's weights are no longer read
    for (int t = tid; t < n * RC; t += blockDim.x) {
      const int y = t / RC, rr = t - y * RC;
      const int64_t f = s0 + y, i = f / J, j = f - i * J;
      smem[t] = r0 + rr < R ? A[i * R + r0 + rr] * B[j * R + r0 + rr] : 0.f;
    }
    __syncthreads();
    if (live) {
      const float* p = V + (s0 + yy) * K + kv * VW;
      const int64_t step = (int64_t)rows * K;
      int y = yy;
      for (; y + (U - 1) * rows < n; y += U * rows, p += U * step) {
        float x[U][VW];
#pragma unroll
        for (int u = 0; u < U; ++u) load_vec<VW>(p + u * step, x[u]);
#pragma unroll
        for (int u = 0; u < U; ++u) fma_vec<VW, RC>(x[u], smem + (y + u * rows) * RC, acc);
      }
      for (; y < n; y += rows, p += step) {  // the last U - 1 steps at most
        float x[VW];
        load_vec<VW>(p, x);
        fma_vec<VW, RC>(x, smem + y * RC, acc);
      }
    }
  }

  // Sum the rows of threads in row order, one vector lane v at a time, and
  // write the slab's partial[k, r0 .. r0 + RC).
  float* dst = partial + (int64_t)blockIdx.x * K * R;
  const int rcv = R - r0 < RC ? R - r0 : RC;
#pragma unroll
  for (int v = 0; v < VW; ++v) {
    __syncthreads();  // the weights (or the last lane's sums) are no longer read
    if (yy < rows) {
#pragma unroll
      for (int r = 0; r < RC; ++r) smem[tid * RC + r] = acc[v][r];
    }
    __syncthreads();
    for (int e = tid; e < kcols * RC; e += blockDim.x) {
      const int c = e / RC, r = e - c * RC;
      const int64_t k = ((int64_t)blockIdx.y * kcols + c) * VW + v;
      if (r >= rcv || k >= K) continue;
      float s = 0.f;
      for (int y = 0; y < rows; ++y) s += smem[(y * kcols + c) * RC + r];
      dst[k * R + r0 + r] = s;
    }
  }
}

// Pass 2 of mode 2 (and of the rows kernel when it splits rows):
// out[e] = sum over parts s of part[s n_out + e], for e < n_out. A block
// takes 32 consecutive e; its kGroups warps sum parts g, g + kGroups, ... in
// order, and warp 0 adds the groups' sums in group order.
constexpr int kGroups = 16;

__global__ void __launch_bounds__(32 * kGroups)
mttkrp3_sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                         int64_t n_parts, int64_t n_out) {
  __shared__ float red[kGroups][33];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int64_t e = (int64_t)blockIdx.x * 32 + lane;
  float v = 0.f;
  if (e < n_out) {
#pragma unroll 4
    for (int64_t s = g; s < n_parts; s += kGroups) v += part[s * n_out + e];
  }
  red[g][lane] = v;
  __syncthreads();
  if (g == 0 && e < n_out) {
    float t = red[0][lane];
#pragma unroll
    for (int h = 1; h < kGroups; ++h) t += red[h][lane];
    out[e] = t;
  }
}

cudaError_t sum_parts(const float* part, float* out, int64_t n_parts, int64_t n_out,
                      cudaStream_t stream) {
  mttkrp3_sum_parts_kernel<<<(unsigned)((n_out + 31) / 32), 32 * kGroups, 0, stream>>>(
      part, out, n_parts, n_out);
  return cudaGetLastError();
}

// Allow the instance (RC, VW) of the rows kernel (kind 0) or of mode 2's
// pass 1 (kind 2) kMaxSmem bytes of dynamic shared memory. One limit for
// every plan: a limit set per plan would refuse the launches of another
// plan of the same instance that needs more.
template <int RC, int VW>
cudaError_t prepare(int kind) {
  return kind == 0 ? cudaFuncSetAttribute(mttkrp3_rows_kernel<RC, VW>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem)
                   : cudaFuncSetAttribute(mttkrp3_minor_partial_kernel<RC, VW>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

}  // namespace

extern "C" {

// Allow the rows kernel (kind 0: modes 0 and 1) or mode 2's pass 1 (kind
// 2), in its instance for (R, vec), kMaxSmem bytes of dynamic shared memory
// on the current device; once per launch plan, before its first launch.
int pp_mttkrp3_prepare(int kind, int R, int vec) {
  if ((kind != 0 && kind != 2) || R <= 0 || (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (vec == 4) {
    PP_DISPATCH_RC(rank_chunk(R), err = prepare<RC, 4>(kind));
  } else {
    PP_DISPATCH_RC(rank_chunk(R), err = prepare<RC, 1>(kind));
  }
  return (int)err;
}

// Modes 0 (K1) and 1 (K2): out (nx, R) from V's nx rows of ny fibers (fiber
// (x, y) at x sx + y sy, K floats), W (ny, R) and C (K, R), with the
// wrapper's plan (mttkrp3.py rows_plan): vec and the (rows x kcols) thread
// grid as for mode 2; k_chunks steps of kcols vectors cover k; each row's
// fibers in `parts` parts of part_len; smem = 4 RC max(part_len, threads /
// 32) bytes. partial is (parts, nx, R) float32 scratch when parts > 1 (the
// rows kernel then writes it and the pass-2 kernel sums it into out), and
// unused otherwise. Mode 0: nx = I, ny = J, W = B, sx = J K, sy = K; mode 1:
// nx = J, ny = I, W = A, sx = K, sy = J K.
int pp_mttkrp3_rows(const float* V, const float* W, const float* C, float* partial, float* out,
                    int64_t nx, int64_t ny, int64_t K, int R, int64_t sx, int64_t sy, int vec,
                    int threads, int kcols, int rows, int k_chunks, int parts, int64_t part_len,
                    int smem, cudaStream_t stream) {
  const int rc = rank_chunk(R);
  const int64_t need = part_len > threads / 32 ? part_len : threads / 32;
  if (nx <= 0 || nx > 0x7fffffffLL || ny <= 0 || K <= 0 || R <= 0 || kcols <= 0 || rows <= 0 ||
      threads > kMaxThreads || threads % 32 != 0 || kcols * rows > threads || k_chunks <= 0 ||
      (int64_t)k_chunks * kcols * vec < K || parts <= 0 || parts > 65535 || part_len <= 0 ||
      (int64_t)parts * part_len < ny || (int64_t)(parts - 1) * part_len >= ny ||
      smem != 4 * rc * need || smem > kMaxSmem || (parts > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (vec != 1 && (vec != 4 || K % 4 != 0 || reinterpret_cast<uintptr_t>(V) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  float* dst = parts > 1 ? partial : out;
  const dim3 grid((unsigned)nx, (unsigned)parts, (unsigned)((R + rc - 1) / rc));
  if (vec == 4) {
    PP_DISPATCH_RC(rc, mttkrp3_rows_kernel<RC, 4><<<grid, threads, smem, stream>>>(
                           V, W, C, dst, nx, ny, K, R, sx, sy, kcols, rows, k_chunks, part_len));
  } else {
    PP_DISPATCH_RC(rc, mttkrp3_rows_kernel<RC, 1><<<grid, threads, smem, stream>>>(
                           V, W, C, dst, nx, ny, K, R, sx, sy, kcols, rows, k_chunks, part_len));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return (int)err;
  return (int)sum_parts(partial, out, parts, nx * R, stream);
}

// Mode 2 (K3): out (K, R) from V (I, J, K), A (I, R), B (J, R), with the
// wrapper's plan (mttkrp3.py minor_plan): vec = 4 for 16-byte loads of V (K
// % 4 == 0, V 16-byte aligned) or 1; blocks of `threads` threads, a (rows x
// kcols) grid of them over (fibers, k vectors); k_chunks chunks of kcols
// vectors; n_slabs slabs of slab_len fibers; weights staged `stage` fibers
// at a time; smem = 4 RC max(stage, threads) bytes. partial is (n_slabs, K,
// R) float32 scratch.
int pp_mttkrp3_mode2(const float* V, const float* A, const float* B, float* partial, float* out,
                     int64_t I, int64_t J, int64_t K, int R, int vec, int threads, int kcols,
                     int rows, int k_chunks, int64_t n_slabs, int64_t slab_len, int stage,
                     int smem, cudaStream_t stream) {
  const int64_t n_fibers = I * J;
  const int rc = rank_chunk(R);
  if (I <= 0 || J <= 0 || K <= 0 || R <= 0 || kcols <= 0 || rows <= 0 || stage <= 0 ||
      threads > kMaxThreads || threads % 32 != 0 || kcols * rows > threads ||
      k_chunks <= 0 || k_chunks > 65535 || (int64_t)k_chunks * kcols * vec < K ||
      n_slabs <= 0 || n_slabs > 0x7fffffffLL || slab_len <= 0 ||
      n_slabs * slab_len < n_fibers || (n_slabs - 1) * slab_len >= n_fibers ||
      smem != 4 * rc * (stage > threads ? stage : threads) || smem > kMaxSmem ||
      partial == nullptr)
    return (int)cudaErrorInvalidValue;
  if (vec != 1 && (vec != 4 || K % 4 != 0 || reinterpret_cast<uintptr_t>(V) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_slabs, (unsigned)k_chunks, (unsigned)((R + rc - 1) / rc));
  if (vec == 4) {
    PP_DISPATCH_RC(rc, mttkrp3_minor_partial_kernel<RC, 4><<<grid, threads, smem, stream>>>(
                           V, A, B, partial, n_fibers, J, K, R, kcols, rows, slab_len, stage));
  } else {
    PP_DISPATCH_RC(rc, mttkrp3_minor_partial_kernel<RC, 1><<<grid, threads, smem, stream>>>(
                           V, A, B, partial, n_fibers, J, K, R, kcols, rows, slab_len, stage));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sum_parts(partial, out, n_slabs, K * R, stream);
}

const char* pp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
