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
// so the wrapper (candidate_solve.py) launches group_solve.cu's product
// kernels on it with one candidate per blockIdx.z (k candidates of one
// shape per launch), and B1's per-copy z-Gram mix (glue_data: its gz is
// per candidate and copy, which with R = 1 is B2's per-copy Gz mix). This
// file holds what B1 lacks: the B1 / pok / B1^T pair fold over the O*l3
// op rows, the l2 term and the mask after the second product, the power
// iteration's ones seed, FISTA's l1 soft-threshold, the W2 and Mxy build
// kernels of B3, the copy of B3's data-column operand and its score. A
// simple kernel that is right comes first here; wgmma, TMA and fusing
// the glue into the products are later work.
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

#define OLMAX 256  // O * l3 the pair fold's per-thread arrays hold

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

// The symmetry term's glue for candidate blockIdx.y at in-plane cell q
// (one thread each), on the op columns of the first product:
//   tmp[o*l3 + n] = T[n, nd + o*d3sq + q]          (v . Mxy_o^T)
//   diff[r]       = pok[r, q] * sum_c b1[r, c] tmp[c]
//   ubar[c]       = sum_r b1[r, c] diff[r]          (B1^T diff)
//   Gm[m, nd + o*d3sq + q] = ubar[o*l3 + m]  (in the compute type)
template <typename T>
__global__ void sym_fold_kernel(const float* __restrict__ Tm, const float* __restrict__ b1,
                                const float* __restrict__ pok, T* __restrict__ Gm, int l3,
                                int ol, int pl, int nd, int d3sq, int rows) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= d3sq) return;
  const size_t cand = blockIdx.y;
  const size_t base = cand * l3 * rows + nd + q;
  const float* b1c = b1 + cand * pl * ol;
  const float* pokc = pok + cand * pl * d3sq + q;
  float tmp[OLMAX], ubar[OLMAX];
  for (int c = 0; c < ol; ++c) {
    const int o = c / l3, n = c % l3;
    tmp[c] = Tm[base + (size_t)n * rows + (size_t)o * d3sq];
    ubar[c] = 0.f;
  }
  for (int r = 0; r < pl; ++r) {
    const float* row = b1c + (size_t)r * ol;
    float d = 0.f;
    for (int c = 0; c < ol; ++c) d += row[c] * tmp[c];
    d *= pokc[(size_t)r * d3sq];
    for (int c = 0; c < ol; ++c) ubar[c] += row[c] * d;
  }
  for (int c = 0; c < ol; ++c) {
    const int o = c / l3, m = c % l3;
    stf(Gm + base + (size_t)m * rows + (size_t)o * d3sq, ubar[c]);
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
  const dim3 grid(cdiv(d3sq, 128), ncand);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    sym_fold_kernel<bf16_t><<<grid, 128, 0, s>>>(Tm, b1, pok, (bf16_t*)Gm, l3, ol, pl, nd, d3sq, rows);
  else
    sym_fold_kernel<float><<<grid, 128, 0, s>>>(Tm, b1, pok, (float*)Gm, l3, ol, pl, nd, d3sq, rows);
  return (int)cudaGetLastError();
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
