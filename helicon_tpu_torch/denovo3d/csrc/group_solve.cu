// Grouped CG / power-iteration / FISTA solve for twist groups of the
// denovo3d grid search, with the cosine score, for Hopper (sm_90a).
//
// Replaces helicon_tpu/denovo3d/pallas_solver.py::_group_kernel (the v3
// grouped Pallas kernel) with its options: an optional per-candidate l2
// column (the ridge term of every matvec, added in the reduction after the
// second product), an optional l1 column (the soft-threshold of FISTA's
// prox), the score or none, and a j-dependent z-Gram for the fsc half-set
// solves (an element stride js in the data glue and the score).
//
// What bounds it on the card: every matvec is two products against the
// group's stacked operand A_top = [Wsum; Mxy] (rows x d3^2), T = X . A_top^T
// and Y = [u; gs] . A_top, with glue between, and a solve makes cg +
// power + 1 + fista matvecs plus one product for the score (29 matvecs and
// one product at the bench's cg/power/fista budget of 10/2/16). At the
// amyloid geometry A_top is 21,084 x 1,444: 61 MB in bf16 per group, 10.9
// GB for a launch of 179 groups, larger than the 50 MB L2 and far larger
// than a block's 227 KB of shared memory, so each product streams it from
// device memory (the TPU design, both orientations resident in one core's
// VMEM for the whole solve, does not carry over). Each bf16 A_top element
// feeds R*l3 = 78 multiply-adds for a group of 13 candidates of l3 = 6,
// so 78 FLOP per byte, far below the card's ~295 FLOP/B ridge: the bf16
// products are bound by the HBM bytes of A_top, not by the tensor cores.
// In float32 (the converged search, and B2/B3's float32 solve) the same
// 78 multiply-adds per 4-byte element run on the FMA units (67 TFLOP/s):
// 39 FLOP per byte against a ridge of 20, so B1's float32 products are
// bound by the FMA units, while B2/B3's (6 rows) are bound by the bytes.
//
// What this design does about it: the products stream A_top as close
// to the memory rate as a block ring allows. A_top's rows (first product)
// or columns (second) lie on the wide side of a block's tile, 256 of them;
// the candidate rows lie on the narrow side in n8 tiles, rounded up to a
// multiple of 8 (80 for 78, 8 for B2/B3's 6), so the tensor cores waste
// little work. A_top, bf16(X) and [u; gs] have row pitches of 16 bytes'
// multiples (the wrapper pads them), so a ring of 4 K slices of 64 in
// 16-byte cp.async copies keeps ~100 KB per SM in flight (an unpadded
// operand takes the same kernel with 8- or 4-byte copies). The products
// are mma.sync m16n8k16 from ldmatrix (.trans for the second product's
// [k][d3^2] tiles of A_top), accumulated in float32, and the output goes
// through a shared-memory transpose into 16-byte stores. float32 takes the
// same tiles, ring and epilogue on the FMA units, in full float32 (TF32
// would lose the float32 contract): K slices of 32 floats, each thread 4
// or 8 wide values x its share of the candidate rows in registers, the
// candidate slice read as float4 broadcasts, so that at 6 rows the ring
// keeps the bytes moving and at 78 rows the FMA units stay busy. One
// launch covers G groups (blockIdx.z = group); the second product splits
// its K = rows axis, and the float32 first product its K = d3^2 axis,
// only when the groups alone do not fill the card (one float32 group has
// 83 wide tiles for 132 SMs), and a deterministic second pass sums the
// splits in order (and applies the mask after the second product; no
// atomics, so a solve repeats bit for bit). The glue between the
// products (the per-candidate z-Gram mix, the per-op z-shift mixes and
// the op-axis Laplacian) and the vector updates of CG / power / FISTA are separate small kernels;
// per-candidate scalars (rs, eta, score) stay in device memory, and the
// host loop only launches. Layout: every per-candidate tensor is
// candidate-major, and the kernels mask ragged tile edges.
//
// Every C entry launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define L3MAX 64

namespace {

constexpr int NT = 256;
using bf16_t = __nv_bfloat16;

__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(bf16_t* p, float v) { *p = __float2bfloat16(v); }

// out[g, m, n] = mask[m % l3, n] * sum_s part[s, g, m, n], splits in order
// (no mask when mask is null). With an l2 column (one value per candidate
// of l3 rows) the ridge term comes in before the mask:
// out = (sum + l2[cand] * x[g, m, n]) * mask, x in float32.
__global__ void reduce_mask_kernel(const float* __restrict__ part, const float* __restrict__ mask,
                                   const float* __restrict__ x, const float* __restrict__ l2,
                                   float* __restrict__ out, int nsplit, size_t total, int M,
                                   int N, int l3) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * total + i];
    if (l2) s = __fadd_rn(s, __fmul_rn(l2[i / ((size_t)l3 * N)], x[i]));
    const size_t n = i % N;
    const size_t m = (i / N) % M;
    out[i] = mask ? s * mask[(m % l3) * N + n] : s;
  }
}

// The z-Gram of candidate cand, copy c, at in-copy column j: element (m, n)
// lies at [(m * l3 + n) * js]. js = 1: Gz (.., C_u, l3, l3), the same for
// every j; js = d2: the j-dependent Gz (.., C_u, l3, l3, d2) of an fsc
// half-set solve.
__device__ __forceinline__ const float* gram_at(const float* gz, size_t cand, int C_u, int c,
                                                int j, int l3, int js) {
  return gz + (cand * C_u + c) * l3 * l3 * (size_t)js + (js > 1 ? j : 0);
}

// Data columns: u[r, m, col] = sum_n Gz[r, c, m, n(, j)] T[r, n, col],
// c = col / d2, j = col % d2. T's rows are rows elements apart, Gm's ldg.
template <typename T>
__global__ void glue_data_kernel(const float* __restrict__ Tm, const float* __restrict__ gz,
                                 T* __restrict__ Gm, int R, int l3, int C_u, int d2, int rows,
                                 int ldg, int js) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= C_u * d2) return;
  const size_t cand = (size_t)blockIdx.z * R + blockIdx.y;
  const size_t base = cand * l3 * rows + col, gbase = cand * l3 * ldg + col;
  const float* gzc = gram_at(gz, cand, C_u, col / d2, col % d2, l3, js);
  float tn[L3MAX];
  for (int n = 0; n < l3; ++n) tn[n] = Tm[base + (size_t)n * rows];
  for (int m = 0; m < l3; ++m) {
    float u = gzc[(size_t)m * l3 * js] * tn[0];
    for (int n = 1; n < l3; ++n) u += gzc[(size_t)(m * l3 + n) * js] * tn[n];
    stf(Gm + gbase + (size_t)m * ldg, u);
  }
}

// Op columns of candidate r at in-plane cell p (one thread each):
//   vals[o, m] = sum_n Mz[o, m, n] T[n, o, p];  av = af * vals (kept in T)
//   cav[o, m]  = sum_o2 Cn[o, o2] av[o2, m]
//   L[o, m]    = deg*mask * av - af*mask * cav
//   gs[o, n]   = sum_m Mz[o, m, n] L[o, m]
// T's rows are rows elements apart, Gm's ldg.
template <typename T>
__global__ void glue_sym_kernel(float* __restrict__ Tm, const float* __restrict__ mz,
                                const float* __restrict__ af, const float* __restrict__ cn,
                                const float* __restrict__ deg, const float* __restrict__ mask,
                                T* __restrict__ Gm, int R, int l3, int nd, int O, int d3sq,
                                int rows, int ldg) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= d3sq) return;
  const size_t cand = (size_t)blockIdx.z * R + blockIdx.y;
  const size_t base = cand * l3 * rows + nd + p, gbase = cand * l3 * ldg + nd + p;
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
      stf(Gm + gbase + (size_t)o * d3sq + (size_t)n * ldg, gsv);
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

// x_new = clip(y - eta (N y - rhs)); y = x_new + coef (x_new - x); x = x_new.
// With an l1 column the prox soft-thresholds by eta * l1 before the clip.
__global__ void fista_step_kernel(float* x, float* y, const float* __restrict__ Ny,
                                  const float* __restrict__ rhs, const float* __restrict__ eta,
                                  const float* __restrict__ lb, const float* __restrict__ ub,
                                  const float* __restrict__ l1, float coef, int n) {
  const size_t o = (size_t)blockIdx.x * n;
  const float e = eta[blockIdx.x], lo = lb[blockIdx.x], hi = ub[blockIdx.x];
  const float t = l1 ? __fmul_rn(e, l1[blockIdx.x]) : 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float g = Ny[o + i] - rhs[o + i];
    float v = y[o + i] - e * g;
    if (l1) {
      const float a = fmaxf(__fsub_rn(fabsf(v), t), 0.f);
      v = v > 0.f ? a : (v < 0.f ? -a : 0.f);
    }
    const float xn = clip(v, lo, hi);
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
                             int d2, int rows, int n, int js) {
  const size_t cand = blockIdx.x;
  const int nd = C_u * d2;
  const float* tc = Tm + cand * l3 * rows;
  float acc = 0.f;
  for (int e = threadIdx.x; e < l3 * nd; e += blockDim.x) {
    const int m = e / nd, col = e % nd;
    const float* z = gram_at(gz, cand, C_u, col / d2, col % d2, l3, js) + (size_t)m * l3 * js;
    float u = 0.f;
    for (int k = 0; k < l3; ++k) u += z[(size_t)k * js] * tc[(size_t)k * rows + col];
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

// y[r, k] = bf16(x[r, k]) for rows of K, y's ldy apart: the reference's
// cast of X to the compute type
__global__ void cast_bf16_kernel(const float* __restrict__ x, bf16_t* __restrict__ y, size_t n,
                                 int K, int ldy) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    y[(i / K) * ldy + i % K] = __float2bfloat16(x[i]);
}

// ---------------------------------------------------------------------------
// bf16 streaming products: mma.sync m16n8k16 from ldmatrix, fed by a ring
// of STAGES K slices copied with cp.async.
//
// Both products are out^T[w, m] = sum_k Aw[w, k] B[m, k]: w runs over the
// wide side (A_top's rows for T = X . A_top^T; its d3^2 columns for
// Y = Gm . A_top, whose tile arrives [k][w] and goes to the tensor cores
// through ldmatrix.trans), m over the NW candidate rows (a multiple of 8,
// the mma's n side), k over the K slice. A block takes SW = 256 of the
// wide side and NW candidate rows; its 8 warps take 32 wide rows each and
// all NW columns.
constexpr int SW = 256, SK = 64, SNT = 256, STAGES = 4;
constexpr int PK = SK + 8;  // bf16 pitch of K-contiguous tiles (+16 B against bank conflicts)
constexpr int PW = SW + 8;  // bf16 pitch of the [k][w] tile
constexpr int PO = SW + 4;  // float pitch of the output staging tile

template <bool TRANS>
__host__ __device__ constexpr int a_tile_elems() { return TRANS ? SK * PW : SW * PK; }
template <int NW, bool TRANS>
__host__ __device__ constexpr size_t stream_smem_bytes() {
  return (size_t)STAGES * (a_tile_elems<TRANS>() + NW * PK) * 2;
}

// global -> shared copy of BYTES (4, 8 or 16); bytes < BYTES zero-fills the rest
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(BYTES),
                 "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying dst[r, c] = src[(r0 + r) * lds + c0 + c] for the ROWS x COLS
// tile of E (bf16 or float), zero where r0 + r >= rend or c0 + c >= cend.
// Runs of VEC elements (16, 8 or 4 bytes) move as one copy, so lds, c0 and
// src are VEC-aligned.
template <typename E, int ROWS, int COLS, int VEC>
__device__ __forceinline__ void load_rows(E* dst, int ldd, const E* src, size_t lds, int r0,
                                          int rend, int c0, int cend) {
  constexpr int RUNS = COLS / VEC;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * RUNS; e += SNT) {
    const int r = e / RUNS, c = (e % RUNS) * VEC, gr = r0 + r, gc = c0 + c;
    const E* p = src;
    int bytes = 0;
    if (gr < rend && gc < cend) {
      p = src + (size_t)gr * lds + gc;
      bytes = (int)sizeof(E) * min(VEC, cend - gc);
    }
    cp_async<(int)sizeof(E) * VEC>(dst + r * ldd + c, p, bytes);
  }
}

template <typename E, int ROWS, int COLS>
__device__ __forceinline__ void load_rows(int vec, E* dst, int ldd, const E* src, size_t lds,
                                          int r0, int rend, int c0, int cend) {
  constexpr int V16 = 16 / (int)sizeof(E);
  if (vec == V16) load_rows<E, ROWS, COLS, V16>(dst, ldd, src, lds, r0, rend, c0, cend);
  else if (vec == V16 / 2) load_rows<E, ROWS, COLS, V16 / 2>(dst, ldd, src, lds, r0, rend, c0, cend);
  else load_rows<E, ROWS, COLS, V16 / 4>(dst, ldd, src, lds, r0, rend, c0, cend);
}

// out[m0 + m, w0 + w] = stg[m * PO + w] for the NW x SW tile staged in
// shared memory (m < M, w < N): the stores run along w, 16 B each where
// vo allows.
template <int NW>
__device__ __forceinline__ void store_tile(const float* stg, float* out, int m0, int w0, int M,
                                           int N, int ld_out, int vo) {
  for (int e = threadIdx.x; e < NW * (SW / 4); e += SNT) {
    const int m = e / (SW / 4), w = (e % (SW / 4)) * 4, gm = m0 + m, gw = w0 + w;
    if (gm >= M || gw >= N) continue;
    float* o = out + (size_t)gm * ld_out + gw;
    const float* sv = stg + m * PO + w;
    if (vo && gw + 4 <= N)
      *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(sv);
    else
      for (int q = 0; q < 4 && gw + q < N; ++q) o[q] = sv[q];
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}
// c += a . b for one 16 x 8 x 16 tile, bf16 in, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[s, g, m, w] = sum_{k in split s} B[g, m, k] Aw[g, w, k] for w < N and
// m < M, with Aw[w, k] = A[w * lda + k] (TRANS false) or A[k * lda + w]
// (TRANS true); A's groups a_group elements apart, B's rows ldb apart,
// out's rows ld_out apart; va / vb: the copy width (elements) of A / B;
// vo: out takes float4 stores. K splits of kchunk (a multiple of SK) take
// blockIdx.y % nsplit, candidate tiles of NW rows blockIdx.y / nsplit.
template <int NW, bool TRANS>
__global__ void __launch_bounds__(SNT, 1) stream_product_kernel(
    const bf16_t* __restrict__ A, const bf16_t* __restrict__ B, float* __restrict__ out, int M,
    int N, int K, int lda, int ldb, int ld_out, size_t a_group, int kchunk, int nsplit, int va,
    int vb, int vo, int ngroups) {
  constexpr int AE = a_tile_elems<TRANS>(), STAGE = AE + NW * PK, NJ = NW / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16_t* smem = reinterpret_cast<bf16_t*>(smem_raw);
  const int g = blockIdx.z;
  const int mt = blockIdx.y / nsplit, s = blockIdx.y % nsplit;
  const int m0 = mt * NW, w0 = blockIdx.x * SW;
  const int kbeg = s * kchunk, kend = min(K, kbeg + kchunk);
  A += (size_t)g * a_group;
  B += (size_t)g * M * ldb;
  out += ((size_t)s * ngroups + g) * M * ld_out;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  auto load = [&](int stage, int k0) {
    bf16_t* a = smem + stage * STAGE;
    if (TRANS) load_rows<bf16_t, SK, SW>(va, a, PW, A, lda, k0, kend, w0, N);
    else load_rows<bf16_t, SW, SK>(va, a, PK, A, lda, w0, N, k0, kend);
    load_rows<bf16_t, NW, SK>(vb, a + AE, PK, B, ldb, m0, M, k0, kend);
  };

  float acc[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int nk = (kend - kbeg + SK - 1) / SK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, kbeg + st * SK);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();  // slice t has landed
    __syncthreads();              // and every warp is done with slice t - 1
    if (t + STAGES - 1 < nk) load((t + STAGES - 1) % STAGES, kbeg + (t + STAGES - 1) * SK);
    cp_async_commit();
    const bf16_t* a = smem + (t % STAGES) * STAGE;
    const bf16_t* b = a + AE;
#pragma unroll
    for (int kk = 0; kk < SK; kk += 16) {
      unsigned bf[NJ][2];
#pragma unroll
      for (int j = 0; j + 1 < NJ; j += 2) {
        unsigned r[4];
        const int q = lane >> 3;
        ldsm_x4(r, b + (8 * j + (lane & 7) + (q >> 1) * 8) * PK + kk + (q & 1) * 8);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
      if (NJ & 1) {
        unsigned r[2];
        const int l = lane & 15;
        ldsm_x2(r, b + (8 * (NJ - 1) + (l & 7)) * PK + kk + (l >> 3) * 8);
        bf[NJ - 1][0] = r[0];
        bf[NJ - 1][1] = r[1];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        unsigned af[4];
        const int wb = warp * 32 + i * 16;
        if (TRANS) {
          const int q = lane >> 3;
          ldsm_x4_trans(af, a + (kk + (lane & 7) + (q >> 1) * 8) * PW + wb + (q & 1) * 8);
        } else {
          ldsm_x4(af, a + (wb + (lane & 15)) * PK + kk + (lane >> 4) * 8);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // out^T through shared memory, so that the stores run along w, 16 B each
  float* stg = reinterpret_cast<float*>(smem_raw);
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int w = warp * 32 + i * 16 + gq, m = 8 * j + 2 * tq;
      stg[m * PO + w] = acc[i][j][0];
      stg[(m + 1) * PO + w] = acc[i][j][1];
      stg[m * PO + w + 8] = acc[i][j][2];
      stg[(m + 1) * PO + w + 8] = acc[i][j][3];
    }
  __syncthreads();
  store_tile<NW>(stg, out, m0, w0, M, N, ld_out, vo);
}

// ---------------------------------------------------------------------------
// float32 streaming products on the FMA units: the bf16 kernel's shape
// (the same out^T[w, m], SW = 256 of the wide side per block, NW candidate
// rows, a ring of STAGES K slices in cp.async copies, the output through
// the shared-memory transpose), with full float32 fmaf in place of the
// tensor cores (TF32 would lose the float32 contract, ROADMAP C3).
//
// K slices are FK = 32 floats (128 B a row). Thread t owns W wide x NW/NG
// narrow outputs in registers: W = 4 wide values (NG = 4 narrow groups of
// 64 threads) for tiles narrower than 48 candidate rows, W = 8 (NG = 8
// groups of 32) from 48 on. Its narrow group is t / (SW / W), so the 32
// lanes of a warp share it and read the candidate slice as float4
// broadcasts; its wide values are t % (SW / W) + (SW / W) i in the first
// product (float4 reads along k of the [w][k] rows, 144 B apart, so 8
// lanes hit 8 distinct 16-byte bank groups) and runs of 4 from 4 (t %
// (SW / W)) on in the second (float4 reads along w of the [k][w] tile,
// one per k and run). Per 4 k a thread makes W + NJ float4 reads for
// 4 W NJ fmaf (NJ = NW / NG). A float4 read holds the warp's shared-memory
// port for 4 cycles even as a broadcast, so at 80 rows W = 8 makes 18
// reads per 320 fmaf where W = 4 would make 24, which kept the second
// product ~10 % slower; at 8 rows W = 4 keeps the reads of A, which the
// ring has to keep pace with, at 4 per 4 k. Each output is one fmaf
// chain in k order, so a product repeats bit for bit.
constexpr int FK = 32;
constexpr int FPK = FK + 4;  // float pitch of K-contiguous tiles
constexpr int FPW = SW + 4;  // float pitch of the [k][w] tile

template <bool TRANS>
__host__ __device__ constexpr int f32_tile_elems() { return TRANS ? FK * FPW : SW * FPK; }
template <int NW, bool TRANS>
__host__ __device__ constexpr size_t f32_smem_bytes() {
  return (size_t)STAGES * (f32_tile_elems<TRANS>() + NW * FPK) * 4;
}

// The float32 counterpart of stream_product_kernel, with the same
// arguments (va / vb: copy widths of 4, 2 or 1 floats).
template <int NW, bool TRANS>
__global__ void __launch_bounds__(SNT, 1) stream_product_f32_kernel(
    const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ out, int M,
    int N, int K, int lda, int ldb, int ld_out, size_t a_group, int kchunk, int nsplit, int va,
    int vb, int vo, int ngroups) {
  constexpr int W = NW >= 48 ? 8 : 4, WL = SW / W, NJ = NW * WL / SNT;
  constexpr int AE = f32_tile_elems<TRANS>(), STAGE = AE + NW * FPK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int g = blockIdx.z;
  const int mt = blockIdx.y / nsplit, s = blockIdx.y % nsplit;
  const int m0 = mt * NW, w0 = blockIdx.x * SW;
  const int kbeg = s * kchunk, kend = min(K, kbeg + kchunk);
  A += (size_t)g * a_group;
  B += (size_t)g * M * ldb;
  out += ((size_t)s * ngroups + g) * M * ld_out;
  const int wl = threadIdx.x % WL, nq = threadIdx.x / WL;

  auto load = [&](int stage, int k0) {
    float* a = smem + stage * STAGE;
    if (TRANS) load_rows<float, FK, SW>(va, a, FPW, A, lda, k0, kend, w0, N);
    else load_rows<float, SW, FK>(va, a, FPK, A, lda, w0, N, k0, kend);
    load_rows<float, NW, FK>(vb, a + AE, FPK, B, ldb, m0, M, k0, kend);
  };

  float acc[W][NJ];
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = (kend - kbeg + FK - 1) / FK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, kbeg + st * FK);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();  // slice t has landed
    __syncthreads();              // and every warp is done with slice t - 1
    if (t + STAGES - 1 < nk) load((t + STAGES - 1) % STAGES, kbeg + (t + STAGES - 1) * FK);
    cp_async_commit();
    const float* a = smem + (t % STAGES) * STAGE;
    const float* b = a + AE + nq * NJ * FPK;
#pragma unroll 2
    for (int kk = 0; kk < FK; kk += 4) {
      float av[W][4];  // av[i][q]: wide value i at k = kk + q
      if (TRANS) {
#pragma unroll
        for (int h = 0; h < W / 4; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v =
                *reinterpret_cast<const float4*>(a + (kk + q) * FPW + 4 * wl + 4 * WL * h);
            av[4 * h][q] = v.x;
            av[4 * h + 1][q] = v.y;
            av[4 * h + 2][q] = v.z;
            av[4 * h + 3][q] = v.w;
          }
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(a + (wl + WL * i) * FPK + kk);
          av[i][0] = v.x;
          av[i][1] = v.y;
          av[i][2] = v.z;
          av[i][3] = v.w;
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(b + j * FPK + kk);
#pragma unroll
        for (int i = 0; i < W; ++i) {
          acc[i][j] = fmaf(av[i][0], bv.x, acc[i][j]);
          acc[i][j] = fmaf(av[i][1], bv.y, acc[i][j]);
          acc[i][j] = fmaf(av[i][2], bv.z, acc[i][j]);
          acc[i][j] = fmaf(av[i][3], bv.w, acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // out^T through shared memory, so that the stores run along w, 16 B each
  float* stg = smem;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float* r = stg + (nq * NJ + j) * PO;
    if (TRANS) {
#pragma unroll
      for (int h = 0; h < W / 4; ++h)
        *reinterpret_cast<float4*>(r + 4 * wl + 4 * WL * h) = make_float4(
            acc[4 * h][j], acc[4 * h + 1][j], acc[4 * h + 2][j], acc[4 * h + 3][j]);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) r[wl + WL * i] = acc[i][j];
    }
  }
  __syncthreads();
  store_tile<NW>(stg, out, m0, w0, M, N, ld_out, vo);
}

inline unsigned cdiv(size_t a, size_t b) { return (unsigned)((a + b - 1) / b); }

// the widest copy (16, 8 or 4 bytes) that rows lds elements of esize bytes
// apart from p allow, in elements; 0 if none
inline int copy_width(const void* p, size_t lds, int esize) {
  for (int b = 16; b >= 4; b /= 2)
    if ((lds * esize) % b == 0 && reinterpret_cast<uintptr_t>(p) % b == 0) return b / esize;
  return 0;
}

// the candidate tile width NW for M rows, and the number of tiles
constexpr int NWS[] = {8, 16, 32, 48, 80, 128};
inline int pick_width(int M, int* ntiles) {
  *ntiles = (int)cdiv(M, 128);
  const int per = (int)cdiv(M, *ntiles);
  for (int w : NWS)
    if (w >= per) return w;
  return 128;
}

// the operands of one streaming product; E is bf16_t or float
template <typename E>
struct StreamArgs {
  const E* A;
  const E* B;
  float* out;
  int M, N, K, lda, ldb, ld_out;
  size_t a_group;
  int kchunk, nsplit, G;
};

template <int NW, bool TRANS, typename E>
cudaError_t launch_stream(const StreamArgs<E>& a, int ny, cudaStream_t s) {
  constexpr bool F32 = sizeof(E) == 4;
  constexpr size_t bytes = F32 ? f32_smem_bytes<NW, TRANS>() : stream_smem_bytes<NW, TRANS>();
  static_assert(bytes <= 232448 && (size_t)NW * PO * 4 <= bytes, "shared memory");
  void (*kernel)(const E*, const E*, float*, int, int, int, int, int, int, size_t, int, int, int,
                 int, int, int);
  if constexpr (F32) kernel = stream_product_f32_kernel<NW, TRANS>;
  else kernel = stream_product_kernel<NW, TRANS>;
  // above 48 KB only once allowed (per device, so on every launch)
  const cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const int va = copy_width(a.A, a.lda, sizeof(E)), vb = copy_width(a.B, a.ldb, sizeof(E));
  if (!va || !vb) return cudaErrorInvalidValue;
  const int vo = a.ld_out % 4 == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  kernel<<<dim3(cdiv(a.N, SW), ny * a.nsplit, a.G), SNT, bytes, s>>>(
      a.A, a.B, a.out, a.M, a.N, a.K, a.lda, a.ldb, a.ld_out, a.a_group, a.kchunk, a.nsplit, va,
      vb, vo, a.G);
  return cudaGetLastError();
}

template <bool TRANS, typename E>
cudaError_t stream_product(const StreamArgs<E>& a, cudaStream_t s) {
  int ny;
  switch (pick_width(a.M, &ny)) {
    case 8: return launch_stream<8, TRANS>(a, ny, s);
    case 16: return launch_stream<16, TRANS>(a, ny, s);
    case 32: return launch_stream<32, TRANS>(a, ny, s);
    case 48: return launch_stream<48, TRANS>(a, ny, s);
    case 80: return launch_stream<80, TRANS>(a, ny, s);
    default: return launch_stream<128, TRANS>(a, ny, s);
  }
}

}  // namespace

extern "C" {

// out[s, g, m, n] = sum_{k in split s} X[g, m, k] A[g, n, k] for n < N: X
// (G, M, K) float32, rows ldx elements apart in float32; A has rows rows
// per group, lda elements apart; out's rows are rows elements apart, its
// nsplit K splits of kchunk (a multiple of 64) G * M * rows apart. xb:
// scratch for bf16(X), rows ldx elements apart (bf16 mode only).
int hts_gemm_xat(const float* X, const void* A, float* out, void* xb, int G, int M, int N, int K,
                 int rows, int lda, int ldx, int kchunk, int nsplit, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    const size_t n = (size_t)G * M * K;
    cast_bf16_kernel<<<cdiv(n, 256) < 8192u ? cdiv(n, 256) : 8192u, 256, 0, s>>>(X, (bf16_t*)xb, n,
                                                                               K, ldx);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const StreamArgs<bf16_t> a{(const bf16_t*)A, (const bf16_t*)xb, out, M, N, K, lda, ldx,
                               rows, (size_t)rows * lda, kchunk, nsplit, G};
    return (int)stream_product<false>(a, s);
  }
  const StreamArgs<float> a{(const float*)A, X, out, M, N, K, lda, ldx, rows,
                            (size_t)rows * lda, kchunk, nsplit, G};
  return (int)stream_product<false>(a, s);
}

// T's rows are rows elements apart, Gm's ldg (also below)
// js: Gz's element stride, 1 (j-independent) or d2 (j-dependent; also below)
int hts_glue_data(const float* Tm, const float* gz, void* Gm, int G, int R, int l3, int C_u,
                  int d2, int rows, int ldg, int js, int bf16, void* stream) {
  const dim3 grid(cdiv((size_t)C_u * d2, 128), R, G);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    glue_data_kernel<bf16_t><<<grid, 128, 0, s>>>(Tm, gz, (bf16_t*)Gm, R, l3, C_u, d2, rows, ldg,
                                                  js);
  else
    glue_data_kernel<float><<<grid, 128, 0, s>>>(Tm, gz, (float*)Gm, R, l3, C_u, d2, rows, ldg,
                                                 js);
  return (int)cudaGetLastError();
}

int hts_glue_sym(float* Tm, const float* mz, const float* af, const float* cn, const float* deg,
                 const float* mask, void* Gm, int G, int R, int l3, int nd, int O, int d3sq,
                 int rows, int ldg, int bf16, void* stream) {
  const dim3 grid(cdiv(d3sq, 128), R, G);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    glue_sym_kernel<bf16_t><<<grid, 128, 0, s>>>(Tm, mz, af, cn, deg, mask, (bf16_t*)Gm, R, l3, nd,
                                                 O, d3sq, rows, ldg);
  else
    glue_sym_kernel<float><<<grid, 128, 0, s>>>(Tm, mz, af, cn, deg, mask, (float*)Gm, R, l3, nd, O,
                                                d3sq, rows, ldg);
  return (int)cudaGetLastError();
}

// part[s, g, m, n] = sum_{k in split s} Gm[g, m, k] A[g, k, n]: Gm (G, M, K)
// with rows ldg elements apart, A (G, K, N) with rows lda apart.
int hts_gemm_ga(const void* Gm, const void* A, float* part, int G, int M, int N, int K, int ldg,
                int lda, int kchunk, int nsplit, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    const StreamArgs<bf16_t> a{(const bf16_t*)A, (const bf16_t*)Gm, part, M, N, K, lda, ldg, N,
                               (size_t)K * lda, kchunk, nsplit, G};
    return (int)stream_product<true>(a, s);
  }
  const StreamArgs<float> a{(const float*)A, (const float*)Gm, part, M, N, K, lda, ldg, N,
                            (size_t)K * lda, kchunk, nsplit, G};
  return (int)stream_product<true>(a, s);
}

// x and l2 both null (no ridge term) or both set
int hts_reduce_mask(const float* part, const float* mask, const float* x, const float* l2,
                    float* out, int nsplit, int G, int M, int N, int l3, void* stream) {
  const size_t total = (size_t)G * M * N;
  const unsigned blocks = cdiv(total, 256) < 8192u ? cdiv(total, 256) : 8192u;
  reduce_mask_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(part, mask, x, l2, out, nsplit,
                                                               total, M, N, l3);
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

// l1: null (no soft-threshold) or one value per candidate
int hts_fista_step(float* x, float* y, const float* Ny, const float* rhs, const float* eta,
                   const float* lb, const float* ub, const float* l1, float coef, int ncand, int n,
                   void* stream) {
  fista_step_kernel<<<ncand, NT, 0, (cudaStream_t)stream>>>(x, y, Ny, rhs, eta, lb, ub, l1, coef,
                                                            n);
  return (int)cudaGetLastError();
}

int hts_apply_mask(float* x, const float* mask, int ncand, int n, void* stream) {
  apply_mask_kernel<<<ncand, NT, 0, (cudaStream_t)stream>>>(x, mask, n);
  return (int)cudaGetLastError();
}

int hts_score(const float* Tm, const float* gz, const float* x, const float* rhs, const float* bn,
              float* score, int G, int R, int l3, int C_u, int d2, int rows, int n, int js,
              void* stream) {
  score_kernel<<<G * R, NT, 0, (cudaStream_t)stream>>>(Tm, gz, x, rhs, bn, score, l3, C_u, d2,
                                                       rows, n, js);
  return (int)cudaGetLastError();
}

}  // extern "C"
