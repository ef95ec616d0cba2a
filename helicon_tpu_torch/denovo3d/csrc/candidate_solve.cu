// Fused single-candidate solve (B2) and in-kernel operator build + solve
// + cosine score (B3) of the denovo3d separable formulation, for Hopper
// (sm_90a).
//
// Replaces helicon_tpu/denovo3d/pallas_solver.py::_kernel (v1: CG, power
// iteration seeded from ones, FISTA with l1, l2 and the box, on prebuilt
// factors) and ::_full_kernel (v2: the same solve on W2 and Mxy built in
// the kernel from per-copy and per-op angles, nearest-neighbour only,
// then the cosine score).
//
// What bounds them on the card: each matvec streams the candidate's
// stacked operand A = [W2; Mxy_0 .. Mxy_{O-1}] (rows x d3^2) twice, once
// per product, exactly as B1 streams A_top: at the amyloid's 2 A/px
// geometry A is ~20,000 x 1,444 (58 MB in bf16, 117 MB in float32),
// larger than the 50 MB L2, while M = l3 = 6 rows use the products'
// tiles poorly. The products are therefore bound by the bytes of A. The
// TPU design (both orientations of W2 and Mxy resident in one core's VMEM
// for the whole solve) does not carry over.
//
// What this design does about it: the matvec is B1's two-product shape,
// so the wrapper (candidate_solve.py) launches group_solve.cu's streaming
// product kernels on it with one candidate per blockIdx.z (k candidates
// of one shape per launch): A on the 256-wide side of a block, the 6
// candidate rows in an 8-wide tile, a cp.async ring, in bf16 on the
// tensor cores or in float32 on the FMA units, so that both types stream
// A near the memory rate; and B1's per-copy z-Gram mix (glue_data: its gz
// is per candidate and copy, which with R = 1 is B2's per-copy Gz mix).
// This file holds what B1 lacks: the B1 / pok / B1^T pair fold over the
// O*l3 op rows, the l2 term and the mask after the second product, the
// power iteration's ones seed, FISTA's l1 soft-threshold, the W2 and Mxy
// build kernels of B3, the copy of B3's data-column operand and its
// score. Beside the products only the pair fold does real work (2 * P*l3
// * O*l3 multiply-adds per cell, on data of a few MB): it runs as small
// shared-memory products in blocks of 32 cells, so that its 8 x 46
// blocks fill the card at k = 8 (a thread per cell with 256-float local
// arrays took 0.29 ms per matvec on an H100, 36 % of the bf16 solve at
// k = 8 of the amyloid geometry). The rest (the vector updates, the
// z-Gram mix, the l2 + mask pass) is below 6 % of a solve and stays
// simple. Fusing the two products so that A streams once per matvec is
// later work.
//
// Traps of the B3 build, each kept here:
// - jnp.round rounds half to even: rintf / __float2int_rn, never roundf.
// - nvcc contracts a*b+c into FMAs by default, which moves samples that
//   sit half-way between cells (the fault the reference's jitted XLA has,
//   ROADMAP C6). The coordinate arithmetic is written with __fmul_rn /
//   __fadd_rn / __fsub_rn / __fdiv_rn, which are never contracted, in the
//   order of the plain PyTorch version, so the built W2 and Mxy are
//   bit-identical to it.
// - cos and sin of the angles come from the wrapper in float32, so the
//   kernel and the plain version round the same inputs.
//
// Every C entry launches one kernel on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define OLMAX 256  // O * l3 the pair fold's per-thread ubar registers hold (8 warps x 32)

namespace {

constexpr int NT = 256;
using bf16_t = __nv_bfloat16;

__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(bf16_t* p, float v) { *p = __float2bfloat16(v); }

inline unsigned cdiv(size_t a, size_t b) { return (unsigned)((a + b - 1) / b); }
inline unsigned grid_of(size_t n) { return cdiv(n, NT) < 65535u ? cdiv(n, NT) : 65535u; }

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

// The pair fold: one block of NT threads per candidate (blockIdx.y) and
// tile of FQ = 32 in-plane cells q = blockIdx.x * FQ + lane, on the op
// columns of the first product:
//   tmp[c, q]  = T[n, nd + o*d3sq + q], c = o*l3 + n    (v . Mxy_o^T)
//   diff[r, q] = pok[r, q] * sum_c b1[r, c] tmp[c, q]
//   ubar[c, q] = sum_r b1[r, c] diff[r, q]               (B1^T diff)
//   Gm[m, nd + o*d3sq + q] = ubar[o*l3 + m, q]  (in the compute type)
// tmp (olp x FQ), FR rows of b1 at a time (FR x olp) and their diff
// (FR x FQ) sit in shared memory, zero past ol and pl (olp: ol rounded up
// to 4); the two small products run with lanes on cells (T, pok and Gm
// move in 128-byte rows, conflict-free) and warps on rows of b1 or on
// quads of its columns c = 4 (warp + 8 i) + u, both read as float4
// broadcasts; ubar stays in registers (OLMAX / 8 a thread, so O*l3 <=
// OLMAX). Every sum runs in order in one thread, as the per-cell kernel
// before it did, so a solve repeats bit for bit.
constexpr int FQ = 32, FR = 32, NWARP = NT / 32;

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }
inline size_t fold_smem_bytes(int ol) {
  return (size_t)(pad4(ol) * FQ + FR * pad4(ol) + FR * FQ) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(NT) sym_fold_kernel(const float* __restrict__ Tm,
                                                      const float* __restrict__ b1,
                                                      const float* __restrict__ pok,
                                                      T* __restrict__ Gm, int l3, int ol, int pl,
                                                      int nd, int d3sq, int rows) {
  extern __shared__ __align__(16) float fsm[];
  const int olp = pad4(ol);
  float* st = fsm;             // tmp[c][cell]
  float* sb = st + olp * FQ;   // b1[r0 + r][c]
  float* sd = sb + FR * olp;   // diff[r0 + r][cell]
  const size_t cand = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * FQ + lane;
  const bool in = q < d3sq;
  const size_t base = cand * l3 * rows + nd + q;
  const float* b1c = b1 + cand * pl * ol;
  const float* pokc = pok + cand * pl * d3sq + q;
  for (int c = warp; c < olp; c += NWARP)
    st[c * FQ + lane] =
        in && c < ol ? Tm[base + (size_t)(c % l3) * rows + (size_t)(c / l3) * d3sq] : 0.f;
  const int nqd = (olp / 4 - warp + NWARP - 1) / NWARP;  // this warp's column quads
  float4 ub[OLMAX / 4 / NWARP];
#pragma unroll
  for (int i = 0; i < OLMAX / 4 / NWARP; ++i) ub[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int r0 = 0; r0 < pl; r0 += FR) {
    __syncthreads();  // tmp is in place, the previous rows are used up
    for (int r = warp; r < FR; r += NWARP)
      for (int c = lane; c < olp; c += 32)
        sb[r * olp + c] = r0 + r < pl && c < ol ? b1c[(size_t)(r0 + r) * ol + c] : 0.f;
    __syncthreads();
    float d[FR / NWARP];  // rows r0 + warp + 8 j
#pragma unroll
    for (int j = 0; j < FR / NWARP; ++j) d[j] = 0.f;
    for (int c = 0; c < olp; c += 4) {
      const float t0 = st[c * FQ + lane], t1 = st[(c + 1) * FQ + lane];
      const float t2 = st[(c + 2) * FQ + lane], t3 = st[(c + 3) * FQ + lane];
#pragma unroll
      for (int j = 0; j < FR / NWARP; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(sb + (warp + NWARP * j) * olp + c);
        d[j] = fmaf(b.x, t0, d[j]);
        d[j] = fmaf(b.y, t1, d[j]);
        d[j] = fmaf(b.z, t2, d[j]);
        d[j] = fmaf(b.w, t3, d[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < FR / NWARP; ++j) {
      const int r = warp + NWARP * j;
      sd[r * FQ + lane] = (in && r0 + r < pl) ? d[j] * pokc[(size_t)(r0 + r) * d3sq] : 0.f;
    }
    __syncthreads();
    const int nr = min(FR, pl - r0);
    for (int r = 0; r < nr; ++r) {
      const float dv = sd[r * FQ + lane];
      const float* row = sb + r * olp + 4 * warp;
#pragma unroll
      for (int i = 0; i < OLMAX / 4 / NWARP; ++i) {
        if (i >= nqd) break;
        const float4 b = *reinterpret_cast<const float4*>(row + 4 * NWARP * i);
        ub[i].x = fmaf(b.x, dv, ub[i].x);
        ub[i].y = fmaf(b.y, dv, ub[i].y);
        ub[i].z = fmaf(b.z, dv, ub[i].z);
        ub[i].w = fmaf(b.w, dv, ub[i].w);
      }
    }
  }
  if (!in) return;
#pragma unroll
  for (int i = 0; i < OLMAX / 4 / NWARP; ++i) {
    if (i >= nqd) break;
    const float u[4] = {ub[i].x, ub[i].y, ub[i].z, ub[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * (warp + NWARP * i) + k;
      if (c < ol) stf(Gm + base + (size_t)(c % l3) * rows + (size_t)(c / l3) * d3sq, u[k]);
    }
  }
}

// out[b, i] = (sum_s part[s, b, i] + l2[b] * v[b, i]) * mask[i], splits in
// order; scal rows are [l2, l1, lb, ub].
__global__ void reduce_l2_mask_kernel(const float* __restrict__ part, const float* __restrict__ v,
                                      const float* __restrict__ scal,
                                      const float* __restrict__ mask, float* __restrict__ out,
                                      int nsplit, size_t total, int n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * total + i];
    const float l2 = scal[(i / n) * 4];
    out[i] = (s + l2 * v[i]) * mask[i % n];
  }
}

// v = ones / |ones|: the reference's power-iteration seed (ROADMAP C1)
__global__ void seed_ones_kernel(float* v, size_t total, int n) {
  const float val = __fdiv_rn(1.f, fmaxf(sqrtf((float)n), 1e-30f));
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x)
    v[i] = val;
}

__device__ __forceinline__ float clip(float v, float lo, float hi) { return fminf(fmaxf(v, lo), hi); }

// x = y = clip(x, lb, ub) per candidate (one block each)
__global__ void fista_init_kernel(float* x, float* y, const float* __restrict__ scal, int n) {
  const size_t o = (size_t)blockIdx.x * n;
  const float lo = scal[blockIdx.x * 4 + 2], hi = scal[blockIdx.x * 4 + 3];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = clip(x[o + i], lo, hi);
    x[o + i] = v;
    y[o + i] = v;
  }
}

// w = y - eta (N y - rhs); x_new = clip(sign(w) max(|w| - eta l1, 0));
// y = x_new + coef (x_new - x); x = x_new
__global__ void fista_step_kernel(float* x, float* y, const float* __restrict__ Ny,
                                  const float* __restrict__ rhs, const float* __restrict__ eta,
                                  const float* __restrict__ scal, float coef, int n) {
  const size_t o = (size_t)blockIdx.x * n;
  const float e = eta[blockIdx.x];
  const float* sc = scal + blockIdx.x * 4;
  const float el1 = __fmul_rn(e, sc[1]), lo = sc[2], hi = sc[3];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float g = Ny[o + i] - rhs[o + i];
    const float w = y[o + i] - e * g;
    const float xn = clip(copysignf(fmaxf(fabsf(w) - el1, 0.f), w), lo, hi);
    y[o + i] = xn + coef * (xn - x[o + i]);
    x[o + i] = xn;
  }
}

// Gm[b, m, c] = bf16/float(src[b, m, c]) for c < nd (skipped when src is
// null), 0 for nd <= c < rows: the data-column operand of a product whose
// op columns must not contribute.
template <typename T>
__global__ void pack_cols_kernel(const float* __restrict__ src, T* __restrict__ Gm, int nd,
                                 int rows, size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / rows;
    const int c = (int)(i % rows);
    if (c >= nd)
      stf(Gm + i, 0.f);
    else if (src != nullptr)
      stf(Gm + i, src[r * nd + c]);
  }
}

// W2 of B3 (the reference's build_copy, pallas_solver.py:373-400): for
// candidate b, copy c, row j and receiving cell g, count the ray samples
// kc in a window of n_taps around the cell's projection whose nearest
// cell is g, inside the ray and the in-plane mask; times cvf[b, c].
// Written into A[b, c*d2 + j, g]. Unfused arithmetic throughout.
template <typename T>
__global__ void build_w2_kernel(const float* __restrict__ cs_c, const float* __restrict__ sn_c,
                                const float* __restrict__ cvf, const float* __restrict__ plane_ok,
                                T* __restrict__ A, int C, int d2, int d3, float s, float s2,
                                float dy_pixel, int n_taps, int rows, size_t total) {
  const int d3sq = d3 * d3;
  const float half = (float)(d3 / 2);
  const int klo = -(d2 / 2), khi = d2 - 1 - d2 / 2;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int g = (int)(i % d3sq);
    const size_t row = i / d3sq;  // b * C * d2 + c * d2 + j
    const int j = (int)(row % d2);
    const size_t bc = row / d2;  // b * C + c
    const size_t b = bc / C;
    const float cs = cs_c[bc], sn = sn_c[bc];
    const float dx = __fmul_rn(-s, cs), dy = __fmul_rn(s, sn);
    const float y0 = __fsub_rn(__fmul_rn(s, (float)(j - d2 / 2)), dy_pixel);
    const float cx = __fadd_rn(__fmul_rn(y0, sn), half);
    const float cy = __fadd_rn(__fmul_rn(y0, cs), half);
    const int gxi = g % d3, gyi = g / d3;
    const float kcs = __fdiv_rn(__fadd_rn(__fmul_rn(__fsub_rn((float)gxi, cx), dx),
                                          __fmul_rn(__fsub_rn((float)gyi, cy), dy)),
                                s2);
    const float k0 = rintf(kcs);
    int count = 0;
    if (plane_ok[g] > 0.5f) {
      for (int t = -n_taps; t <= n_taps; ++t) {
        const float kc = __fadd_rn(k0, (float)t);
        if (kc < (float)klo || kc > (float)khi) continue;
        const int xi = __float2int_rn(__fadd_rn(cx, __fmul_rn(kc, dx)));
        const int yi = __float2int_rn(__fadd_rn(cy, __fmul_rn(kc, dy)));
        count += (xi == gxi && yi == gyi) ? 1 : 0;
      }
    }
    stf(A + b * (size_t)rows * d3sq + (row - b * (size_t)C * d2) * d3sq + g,
        (float)count * cvf[bc]);
  }
}

// Mxy of B3 (pallas_solver.py:423-451): for candidate b, op o, sample
// cell i and column j, 1 where j is the nearest cell of i rotated by the
// op, inside the volume and the in-plane mask. Written into
// A[b, nd + o*d3sq + i, j]. Unfused arithmetic throughout.
template <typename T>
__global__ void build_mxy_kernel(const float* __restrict__ cs_o, const float* __restrict__ sn_o,
                                 const float* __restrict__ plane_ok, T* __restrict__ A, int O,
                                 int d3, int nd, int rows, size_t total) {
  const int d3sq = d3 * d3;
  const float half = (float)(d3 / 2);
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int j = (int)(e % d3sq);
    const size_t oi = e / d3sq;  // (b * O + o) * d3sq + i
    const int i = (int)(oi % d3sq);
    const size_t bo = oi / d3sq;
    const size_t b = bo / O;
    const int o = (int)(bo % O);
    const float cs = cs_o[bo], sn = sn_o[bo];
    const float px = (float)(i % d3 - d3 / 2), py = (float)(i / d3 - d3 / 2);
    const float X = __fadd_rn(__fsub_rn(__fmul_rn(px, cs), __fmul_rn(py, sn)), half);
    const float Y = __fadd_rn(__fadd_rn(__fmul_rn(px, sn), __fmul_rn(py, cs)), half);
    const int xi = __float2int_rn(X), yi = __float2int_rn(Y);
    const bool inb = xi >= 0 && xi <= d3 - 1 && yi >= 0 && yi <= d3 - 1;
    const float v = (inb && j == yi * d3 + xi) ? plane_ok[j] : 0.f;
    stf(A + (b * (size_t)rows + nd + (size_t)o * d3sq + i) * d3sq + j, v);
  }
}

// score = <x, rhs> / (sqrt(max(<x, dt>, 0)) |b|), dt = the data term of
// x; guarded as the reference (one block per candidate)
__global__ void score_kernel(const float* __restrict__ x, const float* __restrict__ rhs,
                             const float* __restrict__ dt, const float* __restrict__ bn,
                             float* score, int n) {
  const size_t o = (size_t)blockIdx.x * n;
  float a = 0.f, d = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    a += x[o + i] * rhs[o + i];
    d += x[o + i] * dt[o + i];
  }
  const float num = block_sum(a);
  const float den2 = block_sum(d);
  if (threadIdx.x == 0) {
    const float den = sqrtf(fmaxf(den2, 0.f)) * bn[blockIdx.x];
    score[blockIdx.x] = den > 0.f ? num / fmaxf(den, 1e-30f) : 0.f;
  }
}

}  // namespace

extern "C" {

int hcs_sym_fold(const float* Tm, const float* b1, const float* pok, void* Gm, int ncand, int l3,
                 int ol, int pl, int nd, int d3sq, int rows, int bf16, void* stream) {
  if (ol > OLMAX) return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(d3sq, FQ), ncand);
  const size_t bytes = fold_smem_bytes(ol);
  cudaStream_t s = (cudaStream_t)stream;
  // above 48 KB only once allowed (per device, so on every launch)
  cudaError_t e;
  if (bf16) {
    e = cudaFuncSetAttribute(sym_fold_kernel<bf16_t>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e == cudaSuccess)
      sym_fold_kernel<bf16_t><<<grid, NT, bytes, s>>>(Tm, b1, pok, (bf16_t*)Gm, l3, ol, pl, nd,
                                                      d3sq, rows);
  } else {
    e = cudaFuncSetAttribute(sym_fold_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e == cudaSuccess)
      sym_fold_kernel<float><<<grid, NT, bytes, s>>>(Tm, b1, pok, (float*)Gm, l3, ol, pl, nd, d3sq,
                                                     rows);
  }
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

int hcs_reduce_l2_mask(const float* part, const float* v, const float* scal, const float* mask,
                       float* out, int nsplit, int ncand, int n, void* stream) {
  const size_t total = (size_t)ncand * n;
  reduce_l2_mask_kernel<<<grid_of(total), NT, 0, (cudaStream_t)stream>>>(part, v, scal, mask, out,
                                                                          nsplit, total, n);
  return (int)cudaGetLastError();
}

int hcs_seed_ones(float* v, int ncand, int n, void* stream) {
  const size_t total = (size_t)ncand * n;
  seed_ones_kernel<<<grid_of(total), NT, 0, (cudaStream_t)stream>>>(v, total, n);
  return (int)cudaGetLastError();
}

int hcs_fista_init(float* x, float* y, const float* scal, int ncand, int n, void* stream) {
  fista_init_kernel<<<ncand, NT, 0, (cudaStream_t)stream>>>(x, y, scal, n);
  return (int)cudaGetLastError();
}

int hcs_fista_step(float* x, float* y, const float* Ny, const float* rhs, const float* eta,
                   const float* scal, float coef, int ncand, int n, void* stream) {
  fista_step_kernel<<<ncand, NT, 0, (cudaStream_t)stream>>>(x, y, Ny, rhs, eta, scal, coef, n);
  return (int)cudaGetLastError();
}

int hcs_pack_cols(const float* src, void* Gm, int ncand, int l3, int nd, int rows, int bf16,
                  void* stream) {
  const size_t total = (size_t)ncand * l3 * rows;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    pack_cols_kernel<bf16_t><<<grid_of(total), NT, 0, s>>>(src, (bf16_t*)Gm, nd, rows, total);
  else
    pack_cols_kernel<float><<<grid_of(total), NT, 0, s>>>(src, (float*)Gm, nd, rows, total);
  return (int)cudaGetLastError();
}

int hcs_build_w2(const float* cs_c, const float* sn_c, const float* cvf, const float* plane_ok,
                 void* A, int ncand, int C, int d2, int d3, float s, float s2, float dy_pixel,
                 int n_taps, int rows, int bf16, void* stream) {
  const size_t total = (size_t)ncand * C * d2 * d3 * d3;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    build_w2_kernel<bf16_t><<<grid_of(total), NT, 0, st>>>(cs_c, sn_c, cvf, plane_ok, (bf16_t*)A, C,
                                                           d2, d3, s, s2, dy_pixel, n_taps, rows,
                                                           total);
  else
    build_w2_kernel<float><<<grid_of(total), NT, 0, st>>>(cs_c, sn_c, cvf, plane_ok, (float*)A, C,
                                                          d2, d3, s, s2, dy_pixel, n_taps, rows,
                                                          total);
  return (int)cudaGetLastError();
}

int hcs_build_mxy(const float* cs_o, const float* sn_o, const float* plane_ok, void* A, int ncand,
                  int O, int d3, int nd, int rows, int bf16, void* stream) {
  const size_t d3sq = (size_t)d3 * d3;
  const size_t total = (size_t)ncand * O * d3sq * d3sq;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    build_mxy_kernel<bf16_t><<<grid_of(total), NT, 0, st>>>(cs_o, sn_o, plane_ok, (bf16_t*)A, O, d3,
                                                            nd, rows, total);
  else
    build_mxy_kernel<float><<<grid_of(total), NT, 0, st>>>(cs_o, sn_o, plane_ok, (float*)A, O, d3,
                                                           nd, rows, total);
  return (int)cudaGetLastError();
}

int hcs_score(const float* x, const float* rhs, const float* dt, const float* bn, float* score,
              int ncand, int n, void* stream) {
  score_kernel<<<ncand, NT, 0, (cudaStream_t)stream>>>(x, rhs, dt, bn, score, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
