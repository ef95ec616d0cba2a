// Grouped CG / power-iteration / FISTA solve for twist groups of the
// denovo3d grid search, with the cosine score, for Hopper (sm_90a).
//
// Replaces helicon_tpu/denovo3d/pallas_solver.py::_group_kernel (the v3
// grouped Pallas kernel) for the lsq + cosine configuration.
//
// What bounds it on the card: every matvec streams the group's stacked
// operand A_top = [Wsum; Mxy] (rows x d3^2) twice, once per product
// (T = X . A_top^T, then Y = [u; gs] . A_top), and a solve makes
// cg + power + 1 + fista matvecs plus one product for the score (29
// matvecs and one product at the bench's cg/power/fista budget of
// 10/2/16). At the amyloid geometry A_top is 21,084 x
// 1,444 (61 MB in bf16), larger than the 50 MB L2 and far larger than a
// block's 227 KB of shared memory, so the TPU design (both orientations
// resident in one core's VMEM for the whole solve) does not carry over.
//
// What this design does about it: A_top stays in device memory in one
// orientation and each product streams it through shared-memory tiles.
// With a bf16 A_top (the default on the card) the products run on the
// tensor cores (wmma, 128 x 128 output tiles, so one tile spans the
// R*l3 = 78 rows of a 13-candidate group and A_top is read once per
// product); float32 runs on the FMA units (64 x 64 tiles, 4 x 4 outputs
// per thread), as TF32 would lose the float32 contract. One launch
// covers G groups (blockIdx.z = group) so that the tiles of all groups
// fill the card; the second product splits its K = rows axis and a
// deterministic second pass sums the splits and applies the mask. The
// glue between the products (the per-candidate z-Gram mix, the per-op
// z-shift mixes and the op-axis Laplacian) and the vector updates of
// CG / power / FISTA are separate small kernels; per-candidate scalars
// (rs, eta, score) stay in device memory, and the host loop only
// launches. Layout: every per-candidate tensor is candidate-major and
// unpadded, and the kernels mask ragged tile edges.
//
// Every C entry launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#define L3MAX 64

namespace {

constexpr int BM = 64, BN = 64, BK = 16, NT = 256;

__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// float32 products on the FMA units (TF32 stays off).
// out[g, m, n] = sum_k X[g, m, k] * A[g, n, k] for n < N.
// X (G, M, K); A has ld rows of K per group; out row stride ld.
__global__ void __launch_bounds__(NT) gemm_xat_kernel(
    const float* __restrict__ X, const float* __restrict__ A, float* __restrict__ out,
    int M, int N, int K, int ld) {
  __shared__ float xs[BK][BM + 4];
  __shared__ float as[BK][BN + 4];
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  X += (size_t)g * M * K;
  A += (size_t)g * ld * K;
  out += (size_t)g * M * ld;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int row = e / BK, kk = e % BK, k = k0 + kk;
      const int m = m0 + row, n = n0 + row;
      xs[kk][row] = (m < M && k < K) ? X[(size_t)m * K + k] : 0.f;
      as[kk][row] = (n < N && k < K) ? A[(size_t)n * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = as[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)m * ld + n] = acc[i][j];
    }
  }
}

// part[s, g, m, n] = sum_{k in split s} Gm[g, m, k] * A[g, k, n];
// Gm (G, M, K), A (G, K, N).
__global__ void __launch_bounds__(NT) gemm_ga_kernel(
    const float* __restrict__ Gm, const float* __restrict__ A, float* __restrict__ part,
    int M, int N, int K, int kchunk, int nsplit, int ngroups) {
  __shared__ float gs[BK][BM + 4];
  __shared__ float as[BK][BN + 4];
  const int g = blockIdx.z;
  const int mt = blockIdx.y / nsplit, s = blockIdx.y % nsplit;
  const int m0 = mt * BM, n0 = blockIdx.x * BN;
  const int kbeg = s * kchunk;
  const int kend = min(K, kbeg + kchunk);
  Gm += (size_t)g * M * K;
  A += (size_t)g * K * N;
  part += ((size_t)s * ngroups + g) * M * N;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int row = e / BK, kk = e % BK, k = k0 + kk, m = m0 + row;
      gs[kk][row] = (m < M && k < kend) ? Gm[(size_t)m * K + k] : 0.f;
      const int kk2 = e / BN, col = e % BN, k2 = k0 + kk2, n = n0 + col;
      as[kk2][col] = (n < N && k2 < kend) ? A[(size_t)k2 * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = gs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = as[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) part[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// out[g, m, n] = mask[m % l3, n] * sum_s part[s, g, m, n], splits in order
__global__ void reduce_mask_kernel(const float* __restrict__ part, const float* __restrict__ mask,
                                   float* __restrict__ out, int nsplit, size_t total, int M,
                                   int N, int l3) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * total + i];
    const size_t n = i % N;
    const size_t m = (i / N) % M;
    out[i] = s * mask[(m % l3) * N + n];
  }
}

// Data columns: u[r, m, col] = sum_n Gz[r, c, m, n] T[r, n, col], c = col / d2.
template <typename T>
__global__ void glue_data_kernel(const float* __restrict__ Tm, const float* __restrict__ gz,
                                 T* __restrict__ Gm, int R, int l3, int C_u, int d2, int rows) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= C_u * d2) return;
  const size_t cand = (size_t)blockIdx.z * R + blockIdx.y;
  const size_t base = cand * l3 * rows + col;
  const float* gzc = gz + (cand * C_u + col / d2) * l3 * l3;
  float tn[L3MAX];
  for (int n = 0; n < l3; ++n) tn[n] = Tm[base + (size_t)n * rows];
  for (int m = 0; m < l3; ++m) {
    float u = gzc[m * l3] * tn[0];
    for (int n = 1; n < l3; ++n) u += gzc[m * l3 + n] * tn[n];
    stf(Gm + base + (size_t)m * rows, u);
  }
}

// Op columns of candidate r at in-plane cell p (one thread each):
//   vals[o, m] = sum_n Mz[o, m, n] T[n, o, p];  av = af * vals (kept in T)
//   cav[o, m]  = sum_o2 Cn[o, o2] av[o2, m]
//   L[o, m]    = deg*mask * av - af*mask * cav
//   gs[o, n]   = sum_m Mz[o, m, n] L[o, m]
template <typename T>
__global__ void glue_sym_kernel(float* __restrict__ Tm, const float* __restrict__ mz,
                                const float* __restrict__ af, const float* __restrict__ cn,
                                const float* __restrict__ deg, const float* __restrict__ mask,
                                T* __restrict__ Gm, int R, int l3, int nd, int O, int d3sq,
                                int rows) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= d3sq) return;
  const size_t cand = (size_t)blockIdx.z * R + blockIdx.y;
  const size_t base = cand * l3 * rows + nd + p;
  const float* mzc = mz + cand * O * l3 * l3;
  const float* afc = af + cand * O * l3 * d3sq + p;
  const float* degc = deg + cand * O * l3 * d3sq + p;
  const float* cnc = cn + cand * O * O;
  float tn[L3MAX], lv[L3MAX];
  for (int o = 0; o < O; ++o) {
    const size_t c0 = base + (size_t)o * d3sq;
    for (int n = 0; n < l3; ++n) tn[n] = Tm[c0 + (size_t)n * rows];
    for (int m = 0; m < l3; ++m) {
      const float* z = mzc + (o * l3 + m) * l3;
      float v = 0.f;
      for (int n = 0; n < l3; ++n) v += z[n] * tn[n];
      Tm[c0 + (size_t)m * rows] = afc[(size_t)(o * l3 + m) * d3sq] * v;
    }
  }
  for (int o = 0; o < O; ++o) {
    const size_t c0 = base + (size_t)o * d3sq;
    for (int m = 0; m < l3; ++m) {
      const size_t rm = base + (size_t)m * rows;
      float cav = 0.f;
      for (int o2 = 0; o2 < O; ++o2) cav += cnc[o * O + o2] * Tm[rm + (size_t)o2 * d3sq];
      const float mk = mask[m * d3sq + p];
      const size_t e = (size_t)(o * l3 + m) * d3sq;
      lv[m] = (degc[e] * mk) * Tm[c0 + (size_t)m * rows] - (afc[e] * mk) * cav;
    }
    for (int n = 0; n < l3; ++n) {
      float gsv = 0.f;
      for (int m = 0; m < l3; ++m) gsv += mzc[(o * l3 + m) * l3 + n] * lv[m];
      stf(Gm + c0 + (size_t)n * rows, gsv);
    }
  }
}

// Sum over the block; every thread gets the total.
__device__ float block_sum(float v) {
  __shared__ float sh[32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();  // sh may still be read by a previous call
  if (lane == 0) sh[w] = v;
  __syncthreads();
  float t = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0.f;
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  return t;
}

// One block per candidate b; its vector is [b * n, (b + 1) * n).
__global__ void cg_init_kernel(const float* __restrict__ rhs, float* x, float* r, float* p,
                               float* rs, int n) {
  const size_t o = (size_t)blockIdx.x * n;
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = rhs[o + i];
    x[o + i] = 0.f;
    r[o + i] = v;
    p[o + i] = v;
    acc += v * v;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) rs[blockIdx.x] = acc;
}

__global__ void cg_step_kernel(float* x, float* r, float* p, const float* __restrict__ Np,
                               float* rs, int n) {
  const size_t o = (size_t)blockIdx.x * n;
  const float rsv = rs[blockIdx.x];
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += p[o + i] * Np[o + i];
  const float pnp = block_sum(acc);
  const float alpha = pnp > 0.f ? rsv / fmaxf(pnp, 1e-30f) : 0.f;
  acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[o + i] = x[o + i] + alpha * p[o + i];
    const float rv = r[o + i] - alpha * Np[o + i];
    r[o + i] = rv;
    acc += rv * rv;
  }
  const float rsn = block_sum(acc);
  const float beta = rsv > 0.f ? rsn / fmaxf(rsv, 1e-30f) : 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[o + i] = r[o + i] + beta * p[o + i];
  if (threadIdx.x == 0) rs[blockIdx.x] = rsn;
}

// dst = src / max(|src|, 1e-30) per candidate (dst may alias src)
__global__ void normalize_kernel(float* dst, const float* src, int n) {
  const size_t o = (size_t)blockIdx.x * n;
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += src[o + i] * src[o + i];
  const float nrm = fmaxf(sqrtf(block_sum(acc)), 1e-30f);
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[o + i] = src[o + i] / nrm;
}

// eta = 1 / max(margin * <v, w>, 1e-20) per candidate
__global__ void rayleigh_kernel(const float* __restrict__ v, const float* __restrict__ w,
                                float* eta, float margin, int n) {
  const size_t o = (size_t)blockIdx.x * n;
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += v[o + i] * w[o + i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) eta[blockIdx.x] = 1.f / fmaxf(margin * acc, 1e-20f);
}

__device__ __forceinline__ float clip(float v, float lo, float hi) { return fminf(fmaxf(v, lo), hi); }

// x = y = clip(x, lb, ub)
__global__ void fista_init_kernel(float* x, float* y, const float* __restrict__ lb,
                                  const float* __restrict__ ub, int n) {
  const size_t o = (size_t)blockIdx.x * n;
  const float lo = lb[blockIdx.x], hi = ub[blockIdx.x];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = clip(x[o + i], lo, hi);
    x[o + i] = v;
    y[o + i] = v;
  }
}

// x_new = clip(y - eta (N y - rhs)); y = x_new + coef (x_new - x); x = x_new
__global__ void fista_step_kernel(float* x, float* y, const float* __restrict__ Ny,
                                  const float* __restrict__ rhs, const float* __restrict__ eta,
                                  const float* __restrict__ lb, const float* __restrict__ ub,
                                  float coef, int n) {
  const size_t o = (size_t)blockIdx.x * n;
  const float e = eta[blockIdx.x], lo = lb[blockIdx.x], hi = ub[blockIdx.x];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float g = Ny[o + i] - rhs[o + i];
    const float xn = clip(y[o + i] - e * g, lo, hi);
    y[o + i] = xn + coef * (xn - x[o + i]);
    x[o + i] = xn;
  }
}

__global__ void apply_mask_kernel(float* x, const float* __restrict__ mask, int n) {
  const size_t o = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[o + i] *= mask[i];
}

// score = <x, rhs> / (sqrt(<t_d, Gz mix t_d>) |b|), guarded as the reference
__global__ void score_kernel(const float* __restrict__ Tm, const float* __restrict__ gz,
                             const float* __restrict__ x, const float* __restrict__ rhs,
                             const float* __restrict__ bn, float* score, int l3, int C_u,
                             int d2, int rows, int n) {
  const size_t cand = blockIdx.x;
  const int nd = C_u * d2;
  const float* tc = Tm + cand * l3 * rows;
  const float* gzc = gz + cand * C_u * l3 * l3;
  float acc = 0.f;
  for (int e = threadIdx.x; e < l3 * nd; e += blockDim.x) {
    const int m = e / nd, col = e % nd;
    const float* z = gzc + ((size_t)(col / d2) * l3 + m) * l3;
    float u = 0.f;
    for (int k = 0; k < l3; ++k) u += z[k] * tc[(size_t)k * rows + col];
    acc += tc[(size_t)m * rows + col] * u;
  }
  const float den2 = block_sum(acc);
  acc = 0.f;
  const size_t o = cand * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += x[o + i] * rhs[o + i];
  const float num = block_sum(acc);
  if (threadIdx.x == 0) {
    const float den = sqrtf(fmaxf(den2, 0.f)) * bn[cand];
    score[cand] = den > 0.f ? num / fmaxf(den, 1e-30f) : 0.f;
  }
}


// bf16 products on the tensor cores (mma through nvcuda::wmma, 16x16x16
// fragments, float32 accumulation). A block computes a 128 x 128 output
// tile with 8 warps of 2 x 4 fragments. K slices of 32 of both operands
// stream into shared memory with cp.async (8-byte copies where the row
// pitch allows, else 4-byte), two slices in flight, so the loads of the
// next slice overlap the products of this one. Each warp
// writes its fragments out through a 16 x 16 staging tile so that ragged
// edges are masked. One 128-row tile spans a group's R*l3 rows (78 for 13
// candidates of l3 = 6), so A_top is read once per product. The copies
// move at least bf16 pairs, so the wrapper requires even d3^2 and d2.
constexpr int WBM = 128, WBN = 128, WBK = 32, WNT = 256;
constexpr int LDS_K = WBK + 8;  // bf16 row pitch of K-contiguous tiles
constexpr int LDS_N = WBN + 8;  // bf16 row pitch of N-contiguous tiles
using bf16_t = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16_t, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// global -> shared copy of BYTES (4 or 8); bytes < BYTES zero-fills the rest
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(BYTES),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Start copying dst[r, c] = src[r0 + r, c0 + c] for the ROWS x COLS tile,
// zero where the row is >= nrow or the column >= cend; src rows are lds
// elements apart. Runs of VEC elements (2 or 4 bf16) move as one copy, so
// lds, c0 and src must be VEC-aligned.
template <int ROWS, int COLS, int VEC>
__device__ __forceinline__ void load_tile_async(bf16_t* dst, int ldd, const bf16_t* src,
                                                size_t lds, int r0, int nrow, int c0, int cend) {
  constexpr int RUNS = COLS / VEC;
  for (int e = threadIdx.x; e < ROWS * RUNS; e += WNT) {
    const int r = e / RUNS, c = (e % RUNS) * VEC, gr = r0 + r, gc = c0 + c;
    const bf16_t* p = src;
    int bytes = 0;
    if (gr < nrow && gc < cend) {
      p = src + (size_t)gr * lds + gc;
      bytes = 2 * min(VEC, cend - gc);
    }
    cp_async<2 * VEC>(dst + r * ldd + c, p, bytes);
  }
}

// the widest run (4 or 2 elements) that rows lds apart starting at src allow
__device__ __forceinline__ bool runs_of_4(const bf16_t* src, size_t lds) {
  return lds % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 8 == 0;
}

__device__ __forceinline__ void wmma_store(FragC (&acc)[2][4], float* stage, float* out,
                                           int m_base, int n_base, int M, int N, size_t ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m_base + i * 16 + e / 16, n = n_base + j * 16 + e % 16;
        if (m < M && n < N) out[(size_t)m * ld + n] = stage[e];
      }
      __syncwarp();
    }
}

// y = bf16(x): the reference's cast of X to the compute type
__global__ void cast_bf16_kernel(const float* __restrict__ x, bf16_t* __restrict__ y, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = __float2bfloat16(x[i]);
}

// The shared K loop of both products: acc += A_tile . B_tile over the K
// slices [kbeg, kend). LoadA/LoadB(stage, k0) start one slice's copies;
// FragB reads B from its stage tile at (kk, warp column j).
template <typename LoadA, typename LoadB, typename ReadB>
__device__ __forceinline__ void wmma_k_loop(FragC (&acc)[2][4], bf16_t* smem, int stage_elems,
                                            int a_elems, int kbeg, int kend, LoadA load_a,
                                            LoadB load_b, ReadB read_b) {
  const int wm = (threadIdx.x >> 5) >> 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int nk = (kend - kbeg + WBK - 1) / WBK;
  if (nk <= 0) return;
  load_a(smem, kbeg);
  load_b(smem + a_elems, kbeg);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    bf16_t* cur = smem + (t & 1) * stage_elems;
    if (t + 1 < nk) {
      bf16_t* nxt = smem + ((t + 1) & 1) * stage_elems;
      load_a(nxt, kbeg + (t + 1) * WBK);
      load_b(nxt + a_elems, kbeg + (t + 1) * WBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      FragA a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], cur + (wm * 32 + i * 16) * LDS_K + kk, LDS_K);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        auto b = read_b(cur + a_elems, kk, j);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// out[g, m, n] = sum_k Xb[g, m, k] * A[g, n, k] for n < N, all bf16.
__global__ void __launch_bounds__(WNT) gemm_xat_wmma_kernel(
    const bf16_t* __restrict__ Xb, const bf16_t* __restrict__ A, float* __restrict__ out,
    int M, int N, int K, int ld) {
  constexpr int A_ELEMS = WBM * LDS_K, STAGE = A_ELEMS + WBN * LDS_K;
  __shared__ __align__(128) bf16_t smem[2 * STAGE];
  const int g = blockIdx.z, m0 = blockIdx.y * WBM, n0 = blockIdx.x * WBN;
  Xb += (size_t)g * M * K;
  A += (size_t)g * ld * K;
  out += (size_t)g * M * ld;
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  const bool vec4 = runs_of_4(Xb, K) && runs_of_4(A, K);
  FragC acc[2][4];
  wmma_k_loop(
      acc, smem, STAGE, A_ELEMS, 0, K,
      [&](bf16_t* d, int k0) {
        if (vec4) load_tile_async<WBM, WBK, 4>(d, LDS_K, Xb, K, m0, M, k0, K);
        else load_tile_async<WBM, WBK, 2>(d, LDS_K, Xb, K, m0, M, k0, K);
      },
      [&](bf16_t* d, int k0) {
        if (vec4) load_tile_async<WBN, WBK, 4>(d, LDS_K, A, K, n0, N, k0, K);
        else load_tile_async<WBN, WBK, 2>(d, LDS_K, A, K, n0, N, k0, K);
      },
      [&](const bf16_t* b_tile, int kk, int j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16_t, wmma::col_major> b;
        wmma::load_matrix_sync(b, b_tile + (wn * 64 + j * 16) * LDS_K + kk, LDS_K);
        return b;
      });
  // the K loop ends synchronised: its shared memory now stages the output
  wmma_store(acc, reinterpret_cast<float*>(smem) + warp * 256, out, m0 + wm * 32, n0 + wn * 64,
             M, N, ld);
}

// part[s, g, m, n] = sum_{k in split s} Gm[g, m, k] * A[g, k, n], all bf16.
__global__ void __launch_bounds__(WNT) gemm_ga_wmma_kernel(
    const bf16_t* __restrict__ Gm, const bf16_t* __restrict__ A, float* __restrict__ part,
    int M, int N, int K, int kchunk, int nsplit, int ngroups) {
  constexpr int A_ELEMS = WBM * LDS_K, STAGE = A_ELEMS + WBK * LDS_N;
  __shared__ __align__(128) bf16_t smem[2 * STAGE];
  const int g = blockIdx.z;
  const int mt = blockIdx.y / nsplit, s = blockIdx.y % nsplit;
  const int m0 = mt * WBM, n0 = blockIdx.x * WBN;
  const int kbeg = s * kchunk, kend = min(K, kbeg + kchunk);
  Gm += (size_t)g * M * K;
  A += (size_t)g * K * N;
  part += ((size_t)s * ngroups + g) * M * N;
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  // K slices start at multiples of 32 and the N tile at multiples of 128
  const bool vec_g = runs_of_4(Gm, K), vec_a = runs_of_4(A, N);
  FragC acc[2][4];
  wmma_k_loop(
      acc, smem, STAGE, A_ELEMS, kbeg, kend,
      [&](bf16_t* d, int k0) {
        if (vec_g) load_tile_async<WBM, WBK, 4>(d, LDS_K, Gm, K, m0, M, k0, kend);
        else load_tile_async<WBM, WBK, 2>(d, LDS_K, Gm, K, m0, M, k0, kend);
      },
      [&](bf16_t* d, int k0) {
        if (vec_a) load_tile_async<WBK, WBN, 4>(d, LDS_N, A, N, k0, kend, n0, N);
        else load_tile_async<WBK, WBN, 2>(d, LDS_N, A, N, k0, kend, n0, N);
      },
      [&](const bf16_t* b_tile, int kk, int j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16_t, wmma::row_major> b;
        wmma::load_matrix_sync(b, b_tile + kk * LDS_N + wn * 64 + j * 16, LDS_N);
        return b;
      });
  wmma_store(acc, reinterpret_cast<float*>(smem) + warp * 256, part, m0 + wm * 32, n0 + wn * 64,
             M, N, N);
}

inline unsigned cdiv(size_t a, size_t b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

extern "C" {

// xb: scratch for bf16(X), G * M * K elements (bf16 mode only)
int hts_gemm_xat(const float* X, const void* A, float* out, void* xb, int G, int M, int N, int K,
                 int ld, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    const size_t n = (size_t)G * M * K;
    cast_bf16_kernel<<<cdiv(n, 256) < 8192u ? cdiv(n, 256) : 8192u, 256, 0, s>>>(X, (bf16_t*)xb, n);
    gemm_xat_wmma_kernel<<<dim3(cdiv(N, WBN), cdiv(M, WBM), G), WNT, 0, s>>>(
        (const bf16_t*)xb, (const bf16_t*)A, out, M, N, K, ld);
  } else
    gemm_xat_kernel<<<dim3(cdiv(N, BN), cdiv(M, BM), G), NT, 0, s>>>(X, (const float*)A, out, M,
                                                                     N, K, ld);
  return (int)cudaGetLastError();
}

int hts_glue_data(const float* Tm, const float* gz, void* Gm, int G, int R, int l3, int C_u,
                  int d2, int rows, int bf16, void* stream) {
  const dim3 grid(cdiv((size_t)C_u * d2, 128), R, G);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    glue_data_kernel<__nv_bfloat16><<<grid, 128, 0, s>>>(Tm, gz, (__nv_bfloat16*)Gm, R, l3, C_u, d2, rows);
  else
    glue_data_kernel<float><<<grid, 128, 0, s>>>(Tm, gz, (float*)Gm, R, l3, C_u, d2, rows);
  return (int)cudaGetLastError();
}

int hts_glue_sym(float* Tm, const float* mz, const float* af, const float* cn, const float* deg,
                 const float* mask, void* Gm, int G, int R, int l3, int nd, int O, int d3sq,
                 int rows, int bf16, void* stream) {
  const dim3 grid(cdiv(d3sq, 128), R, G);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    glue_sym_kernel<__nv_bfloat16><<<grid, 128, 0, s>>>(Tm, mz, af, cn, deg, mask, (__nv_bfloat16*)Gm,
                                                        R, l3, nd, O, d3sq, rows);
  else
    glue_sym_kernel<float><<<grid, 128, 0, s>>>(Tm, mz, af, cn, deg, mask, (float*)Gm, R, l3, nd, O,
                                                d3sq, rows);
  return (int)cudaGetLastError();
}

int hts_gemm_ga(const void* Gm, const void* A, float* part, int G, int M, int N, int K,
                int kchunk, int nsplit, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    gemm_ga_wmma_kernel<<<dim3(cdiv(N, WBN), cdiv(M, WBM) * nsplit, G), WNT, 0, s>>>(
        (const bf16_t*)Gm, (const bf16_t*)A, part, M, N, K, kchunk, nsplit, G);
  else
    gemm_ga_kernel<<<dim3(cdiv(N, BN), cdiv(M, BM) * nsplit, G), NT, 0, s>>>(
        (const float*)Gm, (const float*)A, part, M, N, K, kchunk, nsplit, G);
  return (int)cudaGetLastError();
}

int hts_reduce_mask(const float* part, const float* mask, float* out, int nsplit, int G, int M,
                    int N, int l3, void* stream) {
  const size_t total = (size_t)G * M * N;
  const unsigned blocks = cdiv(total, 256) < 8192u ? cdiv(total, 256) : 8192u;
  reduce_mask_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(part, mask, out, nsplit, total, M, N, l3);
  return (int)cudaGetLastError();
}

int hts_cg_init(const float* rhs, float* x, float* r, float* p, float* rs, int ncand, int n,
                void* stream) {
  cg_init_kernel<<<ncand, NT, 0, (cudaStream_t)stream>>>(rhs, x, r, p, rs, n);
  return (int)cudaGetLastError();
}

int hts_cg_step(float* x, float* r, float* p, const float* Np, float* rs, int ncand, int n,
                void* stream) {
  cg_step_kernel<<<ncand, NT, 0, (cudaStream_t)stream>>>(x, r, p, Np, rs, n);
  return (int)cudaGetLastError();
}

int hts_normalize(float* dst, const float* src, int ncand, int n, void* stream) {
  normalize_kernel<<<ncand, NT, 0, (cudaStream_t)stream>>>(dst, src, n);
  return (int)cudaGetLastError();
}

int hts_rayleigh(const float* v, const float* w, float* eta, float margin, int ncand, int n,
                 void* stream) {
  rayleigh_kernel<<<ncand, NT, 0, (cudaStream_t)stream>>>(v, w, eta, margin, n);
  return (int)cudaGetLastError();
}

int hts_fista_init(float* x, float* y, const float* lb, const float* ub, int ncand, int n,
                   void* stream) {
  fista_init_kernel<<<ncand, NT, 0, (cudaStream_t)stream>>>(x, y, lb, ub, n);
  return (int)cudaGetLastError();
}

int hts_fista_step(float* x, float* y, const float* Ny, const float* rhs, const float* eta,
                   const float* lb, const float* ub, float coef, int ncand, int n, void* stream) {
  fista_step_kernel<<<ncand, NT, 0, (cudaStream_t)stream>>>(x, y, Ny, rhs, eta, lb, ub, coef, n);
  return (int)cudaGetLastError();
}

int hts_apply_mask(float* x, const float* mask, int ncand, int n, void* stream) {
  apply_mask_kernel<<<ncand, NT, 0, (cudaStream_t)stream>>>(x, mask, n);
  return (int)cudaGetLastError();
}

int hts_score(const float* Tm, const float* gz, const float* x, const float* rhs, const float* bn,
              float* score, int G, int R, int l3, int C_u, int d2, int rows, int n,
              void* stream) {
  score_kernel<<<G * R, NT, 0, (cudaStream_t)stream>>>(Tm, gz, x, rhs, bn, score, l3, C_u, d2,
                                                       rows, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
