// The gather projector of denovo3d for any pose, and the pose Jacobian of
// refinement's Gauss-Newton step, for Hopper (sm_90a).
//
// No Pallas kernel stands behind these. They replace XLA gathers of the
// JAX package:
// - gather_project (K1): projector.py::data_operator's P (:153-228, with
//   _sample_nn :90 and _sample_linear :105): for each ray (candidate,
//   copy t, image row i, column j) the sum over the d2 samples along the
//   ray of the volume, nearest-neighbour or trilinear, and the ray's
//   validity (row_valid: >= 1 valid sample and the copy slot populated).
// - gather_backproject (K2): its transpose PT (the reference's jax.vjp of
//   P): each ray's residual added back into the voxels its samples read.
// - pose_jacobian (K3): refine.py::_gn_step (:50-94), jax.jacfwd of the
//   linear residual (P(x) - b) * row_valid with respect to (tilt, psi, dy),
//   reduced to J^T J, J^T r and r^T r per candidate; J is never stored.
// - sym_normal (K4): ST(S(x)) of projector.py's symmetry operator S (:230,
//   its sampling as P's) and its vjp ST: the symmetry term of the normal
//   operator every solve on the gather projector applies.
//
// What bounds them on the card: a ray reads d2 samples of a small volume
// (the amyloid's 6 x 38 x 38 float32 is 35 KB) and writes one float, so
// the bytes are ~4 per ray: at 124 M samples a P moves 10 MB (3 us of
// memory time), and only the ~3 % of the samples on rays that meet the
// volume need their ~25-60 float operations (a few us at the float32
// peak). All four are bound by the per-ray work and the latency of
// gathers from on-chip memory, far above both floors.
//
// What the design does about it: one warp per ray, its lanes striding over
// the d2 samples, the sums reduced by shuffles. The rays that cannot hold a
// valid sample are found 32 at a time, a lane each, and skipped (below);
// once per pose the wrapper lists the rays that hold one (K1's row
// validity), and K1 and K2 then take the listed rays alone, dealt evenly
// to the blocks, for the ~29 applications of a solve. A block serves one
// candidate (blockIdx.y) and keeps that candidate's volume and the sampler's
// validity volume (mask for nn, cell-valid volume for linear, one byte a
// voxel) in shared memory when both fit in smem_limit bytes; otherwise it
// reads them through the read-only cache (the production d3 = 64, l3 = 18
// volume is 295 KB). Both branches are the kernel's own. K2 and K4 add
// into a block-private copy of the volume in shared memory with shared
// atomics and flush it with one global atomic per nonzero voxel (124 M x 8
// global atomics onto a 35 KB volume would serialise); past smem_limit
// they add into device memory directly. Their sums are exact: each term is
// a 64-bit integer at a power-of-two scale (fixed() below), so neither the
// order of the atomics nor the split into blocks changes a bit, and the
// plain versions, which add the same integers, give the same result. K3
// keeps each ray's value and its three derivatives in registers and the
// per-candidate sums in float64, and adds the blocks' sums in block order.
// K4 takes one (pair, voxel) a thread. Copy slots that are padding are skipped
// whole, and so is every ray whose two end samples (Z is monotone along
// the ray) put all its samples outside the volume's z range: at the
// amyloid's geometry (l2 = 256 rows at 2/3 voxel, l3 = 6 planes) that is
// most rays. Every C entry serves the k candidates of a launch at once.
//
// Traps, each kept here:
// - nvcc contracts a*b+c into FMAs by default, which moves nearest-
//   neighbour samples that sit half-way between voxels (the reference's
//   jitted XLA has that fault, ROADMAP C6). The coordinate arithmetic is
//   written with __fmul_rn / __fadd_rn / __fsub_rn, which are never
//   contracted, in the order of the plain PyTorch version, so each sample
//   lands where the plain version puts it, bit for bit.
// - cos and sin of the copy angles and the rotation come from the wrapper
//   (projector_separable.cos_sin): CUDA's sinf / cosf would be a third
//   implementation of float32 cos (ROADMAP C11).
// - nearest-neighbour rounds half to even (rintf), as torch.round.
// - float atomics sum in an order that changes from run to run, and a
//   refinement's Gauss-Newton steps amplify that into other poses: K2 and
//   K4 sum in 64-bit integers, K3's float64 sums in a fixed order, so a
//   launch repeats bit for bit; the plain K1 sums a ray's samples in
//   warp_sum's order (gather_kernels._ray_sum), so P is the plain P's.
//
// Every C entry launches one kernel on the given stream (K2's and K4's
// after a max pass over their input and the zeroing of their scratch),
// allocates nothing, and returns cudaGetLastError(); in K2, K3 and K4 the
// last block of each candidate to finish writes its result.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads a block: 8 warps
constexpr int WARPS = NT / 32;

// The per-candidate tables of a launch (float32): R (k, 9) the inverse pose
// rotation, dR (k, 18) its derivatives by tilt and psi (K3 only), cs / sn /
// dz / cv (k, C) each copy's in-plane cos and sin, z shift and slot
// validity (0 / 1), x0 (d2) the ray parameter's x, y0 (k, d2) the column's
// y less dy, z0 (l2) the row's z.
// With a list of live rays (rptr non-null: candidate q's rays are ridx[rptr[q]
// .. rptr[q+1]), the rays of its pose that hold a valid sample), block b of a
// candidate takes its entries b*rpb .. (b+1)*rpb; without, every ray is
// tested (live()).
struct Tables {
  const float *R, *dR, *cs, *sn, *dz, *cv, *x0, *y0, *z0;
  int k, C, l2, d2, d3, l3;
  const int *rptr, *ridx;
  int rpb;
};

__device__ __forceinline__ float dot3_rn(const float* r, float x, float y, float z) {
  // (r0 x + r1 y) + r2 z, each operation rounded alone
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y)), __fmul_rn(r[2], z));
}

// The sample's volume coordinates, in the plain version's order:
// X = (bx c + by s) + d3//2, Y = (by c - bx s) + d3//2, Z = (bz - dz) + l3//2.
__device__ __forceinline__ void coords(float bx, float by, float bz, float c, float s, float dz,
                                       float h3, float hl, float& X, float& Y, float& Z) {
  X = __fadd_rn(__fadd_rn(__fmul_rn(bx, c), __fmul_rn(by, s)), h3);
  Y = __fadd_rn(__fsub_rn(__fmul_rn(by, c), __fmul_rn(bx, s)), h3);
  Z = __fadd_rn(__fsub_rn(bz, dz), hl);
}

// A volume and its validity bytes: in shared memory or in device memory.
struct Vol {
  const float* x;
  const uint8_t* ok;
};

// Whether no sample of the ray (its samples at x0[0 .. d2-1], y0, z0) can
// be valid by z alone. Z is monotone in x0 under round-to-nearest (each
// rounded operation is monotone in its inputs, and x0 is monotone in the
// ray parameter), so the two end samples bound every sample's rounded or
// floored z exactly: a ray this prunes has no valid sample. The reference
// engine's validity pruning, per ray.
__device__ __forceinline__ bool z_outside(const float* R, const float* x0, int d2, float y0,
                                          float z0, float dz, float hl, int l3, bool linear) {
  const float za = __fadd_rn(__fsub_rn(dot3_rn(R + 6, x0[0], y0, z0), dz), hl);
  const float zb = __fadd_rn(__fsub_rn(dot3_rn(R + 6, x0[d2 - 1], y0, z0), dz), hl);
  const float lo = fminf(za, zb), hi = fmaxf(za, zb);
  if (linear) return floorf(hi) < 0.f || floorf(lo) > (float)(l3 - 2);
  return rintf(hi) < 0.f || rintf(lo) > (float)(l3 - 1);
}

// Nearest-neighbour sample: the flat voxel index, or -1 when the rounded
// position leaves the volume or the mask.
__device__ __forceinline__ int nn_index(float X, float Y, float Z, int d3, int l3,
                                        const uint8_t* ok) {
  const float zr = rintf(Z), yr = rintf(Y), xr = rintf(X);
  if (!(zr >= 0.f && zr <= (float)(l3 - 1) && yr >= 0.f && yr <= (float)(d3 - 1) &&
        xr >= 0.f && xr <= (float)(d3 - 1)))
    return -1;
  const int idx = ((int)zr * d3 + (int)yr) * d3 + (int)xr;
  return ok[idx] ? idx : -1;
}

// Trilinear cell: the base corner's flat index (or -1 when the cell leaves
// the volume or is not valid) and the fractions.
__device__ __forceinline__ int cell(float X, float Y, float Z, int d3, int l3, const uint8_t* ok,
                                    float& wz, float& wy, float& wx) {
  const float zf = floorf(Z), yf = floorf(Y), xf = floorf(X);
  if (!(zf >= 0.f && zf <= (float)(l3 - 2) && yf >= 0.f && yf <= (float)(d3 - 2) &&
        xf >= 0.f && xf <= (float)(d3 - 2)))
    return -1;
  const int base = ((int)zf * d3 + (int)yf) * d3 + (int)xf;
  if (!ok[base]) return -1;
  wz = __fsub_rn(Z, zf);
  wy = __fsub_rn(Y, yf);
  wx = __fsub_rn(X, xf);
  return base;
}

// The eight trilinear weights in the plain version's order of corners
// (000, 001, 010, 011, 100, 101, 110, 111 as (z, y, x)), each (a * b) * c.
__device__ __forceinline__ void tri_weights(float wz, float wy, float wx, float w[8]) {
  const float uz = __fsub_rn(1.f, wz), uy = __fsub_rn(1.f, wy), ux = __fsub_rn(1.f, wx);
  w[0] = __fmul_rn(__fmul_rn(uz, uy), ux);
  w[1] = __fmul_rn(__fmul_rn(uz, uy), wx);
  w[2] = __fmul_rn(__fmul_rn(uz, wy), ux);
  w[3] = __fmul_rn(__fmul_rn(uz, wy), wx);
  w[4] = __fmul_rn(__fmul_rn(wz, uy), ux);
  w[5] = __fmul_rn(__fmul_rn(wz, uy), wx);
  w[6] = __fmul_rn(__fmul_rn(wz, wy), ux);
  w[7] = __fmul_rn(__fmul_rn(wz, wy), wx);
}

__device__ __forceinline__ void corner_offsets(int d3, int off[8]) {
  const int dzs = d3 * d3;
  off[0] = 0; off[1] = 1; off[2] = d3; off[3] = d3 + 1;
  off[4] = dzs; off[5] = dzs + 1; off[6] = dzs + d3; off[7] = dzs + d3 + 1;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage candidate q's volume (x may be null: zeros) and the validity bytes
// (aux > 0.5) in shared memory; returns the views the samplers read.
__device__ Vol stage(const float* x, const float* aux, int vol, bool smem, float* sx,
                     uint8_t* sok) {
  if (!smem) return Vol{x, nullptr};
  for (int v = threadIdx.x; v < vol; v += NT) {
    if (sx) sx[v] = x ? __ldg(x + v) : 0.f;
    sok[v] = __ldg(aux + v) > 0.5f;
  }
  __syncthreads();
  return Vol{sx, sok};
}

// A ray's constants: its image row i and column j, its copy's in-plane cos
// and sin and z shift, its y0 and z0.
struct Ray {
  int i, j;
  float c, s, dz, y0, z0;
};

__device__ __forceinline__ Ray ray_of(const Tables& tb, int q, int ray) {
  const int t = ray / (tb.l2 * tb.d2), i = (ray / tb.d2) % tb.l2, j = ray % tb.d2;
  const int tc = q * tb.C + t;
  return Ray{i, j, tb.cs[tc], tb.sn[tc], tb.dz[tc], tb.y0[q * tb.d2 + j], tb.z0[i]};
}

// Whether ray `ray` of candidate q may hold a valid sample: it exists, its
// copy slot is populated and its z range meets the volume (z_outside).
__device__ __forceinline__ bool live(const Tables& tb, int q, int ray, int n_rays,
                                     const float* R, float hl, bool linear) {
  if (ray >= n_rays || tb.cv[q * tb.C + ray / (tb.l2 * tb.d2)] == 0.f) return false;
  const Ray r = ray_of(tb, q, ray);
  return !z_outside(R, tb.x0, tb.d2, r.y0, r.z0, r.dz, hl, tb.l3, linear);
}

// The rays of candidate q go to the warps in one of two ways. With a list,
// a block's entries are dealt to its warps in turn. Without, the rays go in
// groups of 32: each lane tests one ray (live), the warp's ballot lists the
// live ones, and the whole warp then takes each live ray in turn. Either
// way a ray's lanes stride over its samples.

// The entries [e0, e1) of candidate q's list that block blockIdx.x takes.
__device__ __forceinline__ void block_entries(const Tables& tb, int q, int& e0, int& e1) {
  e0 = tb.rptr[q] + blockIdx.x * tb.rpb;
  e1 = min(tb.rptr[q + 1], e0 + tb.rpb);
}

// K1 on one ray: the sum of its samples (zero without x) and whether any
// is valid, written by lane 0.
template <bool LINEAR>
__device__ __forceinline__ void project_ray(const Tables& tb, int q, int ray, const float* R,
                                            const float* xs, const uint8_t* ok, float h3,
                                            float hl, int lane, float* pred, uint8_t* rowv,
                                            size_t out0) {
  const int d2 = tb.d2, d3 = tb.d3, l3 = tb.l3;
  const Ray rr = ray_of(tb, q, ray);
  float acc = 0.f;
  bool any = false;
  for (int kk = lane; kk < d2; kk += 32) {
    const float x0 = tb.x0[kk];
    float X, Y, Z;
    coords(dot3_rn(R, x0, rr.y0, rr.z0), dot3_rn(R + 3, x0, rr.y0, rr.z0),
           dot3_rn(R + 6, x0, rr.y0, rr.z0), rr.c, rr.s, rr.dz, h3, hl, X, Y, Z);
    if (LINEAR) {
      float wz, wy, wx;
      const int base = cell(X, Y, Z, d3, l3, ok, wz, wy, wx);
      if (base < 0) continue;
      any = true;
      if (xs) {
        float w[8];
        int off[8];
        tri_weights(wz, wy, wx, w);
        corner_offsets(d3, off);
        float v = __fmul_rn(w[0], xs[base]);
#pragma unroll
        for (int a = 1; a < 8; ++a) v = __fadd_rn(v, __fmul_rn(w[a], xs[base + off[a]]));
        acc += v;
      }
    } else {
      const int idx = nn_index(X, Y, Z, d3, l3, ok);
      if (idx < 0) continue;
      any = true;
      if (xs) acc += xs[idx];
    }
  }
  acc = warp_sum(acc);
  any = __any_sync(0xffffffffu, any);
  if (lane == 0) {
    if (pred) pred[out0 + ray] = acc;
    if (rowv) rowv[out0 + ray] = any ? 1 : 0;
  }
}

// K1: pred (k, C, l2, d2) and optionally row_valid (same shape, bytes).
// x (k, vol) may be null (row validity alone). ok_g (vol) holds the
// validity bytes in device memory for the branch without shared memory.
// With a list, only the listed rays are written: pred must hold zeros, and
// rowv is not written.
template <bool LINEAR>
__global__ void __launch_bounds__(NT) project_kernel(Tables tb, const float* __restrict__ x,
                                                     const float* __restrict__ aux,
                                                     const uint8_t* __restrict__ ok_g,
                                                     float* __restrict__ pred,
                                                     uint8_t* __restrict__ rowv, int smem) {
  extern __shared__ __align__(16) unsigned char shm[];
  const int q = blockIdx.y;
  int e0 = 0, e1 = 0;
  if (tb.rptr) {
    block_entries(tb, q, e0, e1);
    if (e0 >= e1) return;  // the whole block: nothing listed here
  }
  const int d2 = tb.d2, d3 = tb.d3, l3 = tb.l3;
  const int vol = l3 * d3 * d3;
  const float* xq = x ? x + (size_t)q * vol : nullptr;
  float* sx = x ? reinterpret_cast<float*>(shm) : nullptr;
  uint8_t* sok = shm + (x ? (size_t)vol * 4 : 0);
  Vol V = stage(xq, aux, vol, smem != 0, sx, sok);
  const uint8_t* ok = smem ? V.ok : ok_g;
  const float* xs = smem ? V.x : xq;
  const float h3 = (float)(d3 / 2), hl = (float)(l3 / 2);
  const float* R = tb.R + q * 9;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_rays = tb.C * tb.l2 * d2;
  const size_t out0 = (size_t)q * n_rays;
  if (tb.rptr) {
    for (int e = e0 + warp; e < e1; e += WARPS)
      project_ray<LINEAR>(tb, q, tb.ridx[e], R, xs, ok, h3, hl, lane, pred, nullptr, out0);
    return;
  }
  for (int g = (blockIdx.x * WARPS + warp) * 32; g < n_rays; g += gridDim.x * WARPS * 32) {
    const bool mine = live(tb, q, g + lane, n_rays, R, hl, LINEAR);
    if (!mine && g + lane < n_rays) {  // no valid sample: written here, coalesced
      if (pred) pred[out0 + g + lane] = 0.f;
      if (rowv) rowv[out0 + g + lane] = 0;
    }
    for (unsigned todo = __ballot_sync(0xffffffffu, mine); todo; todo &= todo - 1)
      project_ray<LINEAR>(tb, q, g + __ffs(todo) - 1, R, xs, ok, h3, hl, lane, pred, rowv,
                          out0);
  }
}

// The exact sums of the transposes (K2, K4). Each term t becomes the 64-bit
// integer rint(t * scale), scale a power of two per candidate that keeps
// every partial sum below 2^61 (gather_kernels.fixed_scales). Integer
// additions do not depend on their order, so every run, whatever order the
// atomics land in, and the plain version (an int64 index_add_ of the same
// terms) give the same bits. The last block of a candidate to finish turns
// its sums into float32: double(sum) / scale.
__device__ __forceinline__ unsigned long long fixed(float t, double scale) {
  return (unsigned long long)__double2ll_rn((double)t * scale);
}

constexpr int FIXED_BITS = 61;

// The pre-pass of the exact sums: amax (k,) (zeroed) gets the bits of
// max |v| over each candidate's n values (k, n); nonnegative floats order
// as their bits, and a NaN's bits exceed every other's.
__global__ void __launch_bounds__(NT) amax_kernel(const float* __restrict__ v, long n,
                                                  unsigned* amax) {
  const float* vq = v + (size_t)blockIdx.y * n;
  unsigned m = 0;
  for (long i = (long)blockIdx.x * NT + threadIdx.x; i < n; i += (long)gridDim.x * NT)
    m = max(m, __float_as_uint(fabsf(vq[i])));
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0 && m != 0u) atomicMax(amax + blockIdx.y, m);
}

// The scale of n_terms terms of at most the float of amax_bits each: the
// power of two that keeps their sum below 2^FIXED_BITS (NaN where the
// bound is not finite), as gather_kernels.fixed_scales.
__device__ __forceinline__ double scale_of(unsigned amax_bits, double n_terms) {
  const double bound = (double)__uint_as_float(amax_bits) * n_terms;
  if (!isfinite(bound)) return __longlong_as_double(0x7ff8000000000000ll);
  int e;
  frexp(bound, &e);
  return ldexp(1.0, FIXED_BITS - e);
}

// Called by every block of candidate q once its sums are in accg (k, vol):
// the last one writes out = double(accg) / scale.
__device__ void finish(const long long* accg, unsigned* done, double scale, float* out, int vol,
                       int q) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + q, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long* src = accg + (size_t)q * vol;
  float* dst = out + (size_t)q * vol;
  for (int v = threadIdx.x; v < vol; v += NT)
    dst[v] = __double2float_rn(__ll2double_rn(__ldcg(src + v)) / scale);
}

// A block's integer sums: a private volume in shared memory (zeroed here;
// flush() adds it into accg) or, past smem_limit, accg itself.
__device__ __forceinline__ unsigned long long* sums_of(unsigned char* shm, long long* accg, int q,
                                                      int vol, bool smem) {
  if (!smem) return reinterpret_cast<unsigned long long*>(accg + (size_t)q * vol);
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(shm);
  for (int v = threadIdx.x; v < vol; v += NT) acc[v] = 0ull;
  return acc;
}

__device__ __forceinline__ void flush(const unsigned long long* acc, long long* accg, int q,
                                      int vol, bool smem) {
  if (!smem) return;
  __syncthreads();
  unsigned long long* dst = reinterpret_cast<unsigned long long*>(accg + (size_t)q * vol);
  for (int v = threadIdx.x; v < vol; v += NT)
    if (acc[v] != 0ull) atomicAdd(dst + v, acc[v]);
}

// K2 on one ray of value rv: each valid sample's terms added into acc.
template <bool LINEAR>
__device__ __forceinline__ void backproject_ray(const Tables& tb, int q, int ray, float rv,
                                                const float* R, const uint8_t* ok, float h3,
                                                float hl, int lane, const int* off,
                                                unsigned long long* acc, double sc) {
  const int d2 = tb.d2, d3 = tb.d3, l3 = tb.l3;
  const Ray rr = ray_of(tb, q, ray);
  for (int kk = lane; kk < d2; kk += 32) {
    const float x0 = tb.x0[kk];
    float X, Y, Z;
    coords(dot3_rn(R, x0, rr.y0, rr.z0), dot3_rn(R + 3, x0, rr.y0, rr.z0),
           dot3_rn(R + 6, x0, rr.y0, rr.z0), rr.c, rr.s, rr.dz, h3, hl, X, Y, Z);
    if (LINEAR) {
      float wz, wy, wx, w[8];
      const int base = cell(X, Y, Z, d3, l3, ok, wz, wy, wx);
      if (base < 0) continue;
      tri_weights(wz, wy, wx, w);
#pragma unroll
      for (int a = 0; a < 8; ++a) atomicAdd(acc + base + off[a], fixed(__fmul_rn(w[a], rv), sc));
    } else {
      const int idx = nn_index(X, Y, Z, d3, l3, ok);
      if (idx >= 0) atomicAdd(acc + idx, fixed(rv, sc));
    }
  }
}

// K2: out (k, vol) = the transpose of K1 applied to r (k, C, l2, d2), summed
// exactly (above) at the scale of n_terms terms of at most amax each.
// accg (k, vol) and done (k,) must hold zeros. With a list, a block with
// no entries only counts itself done.
template <bool LINEAR>
__global__ void __launch_bounds__(NT) backproject_kernel(Tables tb, const float* __restrict__ r,
                                                         const uint8_t* __restrict__ ok_g,
                                                         const unsigned* __restrict__ amax,
                                                         double n_terms, long long* accg,
                                                         unsigned* done, float* __restrict__ out,
                                                         int smem) {
  extern __shared__ __align__(16) unsigned char shm[];
  const int q = blockIdx.y;
  const int d2 = tb.d2, d3 = tb.d3, l3 = tb.l3;
  const int vol = l3 * d3 * d3;
  const double sc = scale_of(amax[q], n_terms);
  int e0 = 0, e1 = 0;
  if (tb.rptr) block_entries(tb, q, e0, e1);
  if (!tb.rptr || e0 < e1) {  // the whole block alike
    unsigned long long* acc = sums_of(shm, accg, q, vol, smem != 0);
    const uint8_t* ok = ok_g;
    if (smem) {
      uint8_t* sok = shm + (size_t)vol * 8;
      for (int v = threadIdx.x; v < vol; v += NT) sok[v] = __ldg(ok_g + v);
      ok = sok;
    }
    __syncthreads();
    const float h3 = (float)(d3 / 2), hl = (float)(l3 / 2);
    const float* R = tb.R + q * 9;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_rays = tb.C * tb.l2 * d2;
    const float* rq = r + (size_t)q * n_rays;
    int off[8];
    corner_offsets(d3, off);
    if (tb.rptr) {
      for (int e = e0 + warp; e < e1; e += WARPS) {
        const int ray = tb.ridx[e];
        const float rv = rq[ray];
        if (rv != 0.f)
          backproject_ray<LINEAR>(tb, q, ray, rv, R, ok, h3, hl, lane, off, acc, sc);
      }
    } else {
      for (int g = (blockIdx.x * WARPS + warp) * 32; g < n_rays; g += gridDim.x * WARPS * 32) {
        const bool mine = live(tb, q, g + lane, n_rays, R, hl, LINEAR) && rq[g + lane] != 0.f;
        for (unsigned todo = __ballot_sync(0xffffffffu, mine); todo; todo &= todo - 1) {
          const int ray = g + __ffs(todo) - 1;
          backproject_ray<LINEAR>(tb, q, ray, rq[ray], R, ok, h3, hl, lane, off, acc, sc);
        }
      }
    }
    flush(acc, accg, q, vol, smem != 0);
  }
  finish(accg, done, sc, out, vol, q);
}

// The most blocks a candidate of K3 takes: its per-block sums go to part
// (k, MAX_BLOCKS, 10), which the last block adds up in block order.
constexpr int MAX_BLOCKS = 1024;

// K3: per candidate, out (k, 10) float64 = [J^T J (xx, xy, xz, yy, yz, zz),
// J^T r (3), r^T r] of the linear residual r = P(x) - b over the valid
// rows, J its derivative by (tilt, psi, dy). b (l2, d2). Each block's sums
// go to part, and the candidate's last block adds them in block order, so
// the result does not depend on which block finishes first. done (k,)
// must hold zeros.
__global__ void __launch_bounds__(NT) pose_jacobian_kernel(Tables tb,
                                                           const float* __restrict__ x,
                                                           const float* __restrict__ cellok,
                                                           const uint8_t* __restrict__ ok_g,
                                                           const float* __restrict__ b,
                                                           double* part, unsigned* done,
                                                           double* __restrict__ out, int smem) {
  extern __shared__ __align__(16) unsigned char shm[];
  __shared__ double red[WARPS][10];
  __shared__ bool last;
  const int q = blockIdx.y;
  const int d2 = tb.d2, d3 = tb.d3, l3 = tb.l3;
  const int vol = l3 * d3 * d3;
  const float* xq = x + (size_t)q * vol;
  Vol V = stage(xq, cellok, vol, smem != 0, reinterpret_cast<float*>(shm), shm + (size_t)vol * 4);
  const uint8_t* ok = smem ? V.ok : ok_g;
  const float* xs = smem ? V.x : xq;
  const float h3 = (float)(d3 / 2), hl = (float)(l3 / 2);
  const float* R = tb.R + q * 9;
  const float* Dt = tb.dR + q * 18;
  const float* Dp = Dt + 9;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_rays = tb.C * tb.l2 * d2;
  int off[8];
  corner_offsets(d3, off);
  // dy moves y0 by -1: its coordinate derivatives before the copy's turn
  const float dyx = -R[1], dyy = -R[4], dyz = -R[7];
  double s[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int g = (blockIdx.x * WARPS + warp) * 32; g < n_rays; g += gridDim.x * WARPS * 32) {
    const bool mine = live(tb, q, g + lane, n_rays, R, hl, true);
    for (unsigned todo = __ballot_sync(0xffffffffu, mine); todo; todo &= todo - 1) {
      const int ray = g + __ffs(todo) - 1;
      const Ray rr = ray_of(tb, q, ray);
      const float c = rr.c, sn = rr.s, y0 = rr.y0, z0 = rr.z0;
      const float dXd = dyx * c + dyy * sn, dYd = dyy * c - dyx * sn;
      float v = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f;
      bool any = false;
      for (int kk = lane; kk < d2; kk += 32) {
        const float x0 = tb.x0[kk];
        float X, Y, Z, wz, wy, wx;
        coords(dot3_rn(R, x0, y0, z0), dot3_rn(R + 3, x0, y0, z0), dot3_rn(R + 6, x0, y0, z0),
               c, sn, rr.dz, h3, hl, X, Y, Z);
        const int base = cell(X, Y, Z, d3, l3, ok, wz, wy, wx);
        if (base < 0) continue;
        any = true;
        float w[8], a[8];
        tri_weights(wz, wy, wx, w);
#pragma unroll
        for (int m = 0; m < 8; ++m) a[m] = xs[base + off[m]];
        float val = __fmul_rn(w[0], a[0]);
#pragma unroll
        for (int m = 1; m < 8; ++m) val = __fadd_rn(val, __fmul_rn(w[m], a[m]));
        v += val;
        // the trilinear sample's partials by Z, Y, X
        const float ux = 1.f - wx, uy = 1.f - wy, uz = 1.f - wz;
        const float c00 = a[0] * ux + a[1] * wx, c01 = a[2] * ux + a[3] * wx;
        const float c10 = a[4] * ux + a[5] * wx, c11 = a[6] * ux + a[7] * wx;
        const float c0 = c00 * uy + c01 * wy, c1 = c10 * uy + c11 * wy;
        const float gZ = c1 - c0;
        const float gY = (c01 - c00) * uz + (c11 - c10) * wz;
        const float gX = ((a[1] - a[0]) * uy + (a[3] - a[2]) * wy) * uz +
                         ((a[5] - a[4]) * uy + (a[7] - a[6]) * wy) * wz;
        // the coordinates' derivatives by tilt and psi (degrees)
        const float tx = Dt[0] * x0 + Dt[1] * y0 + Dt[2] * z0;
        const float ty = Dt[3] * x0 + Dt[4] * y0 + Dt[5] * z0;
        const float tz = Dt[6] * x0 + Dt[7] * y0 + Dt[8] * z0;
        const float px = Dp[0] * x0 + Dp[1] * y0 + Dp[2] * z0;
        const float py = Dp[3] * x0 + Dp[4] * y0 + Dp[5] * z0;
        const float pz = Dp[6] * x0 + Dp[7] * y0 + Dp[8] * z0;
        g0 += gX * (tx * c + ty * sn) + gY * (ty * c - tx * sn) + gZ * tz;
        g1 += gX * (px * c + py * sn) + gY * (py * c - px * sn) + gZ * pz;
        g2 += gX * dXd + gY * dYd + gZ * dyz;
      }
      v = warp_sum(v);
      g0 = warp_sum(g0);
      g1 = warp_sum(g1);
      g2 = warp_sum(g2);
      if (__any_sync(0xffffffffu, any) && lane == 0) {
        const double res = (double)v - (double)b[rr.i * d2 + rr.j];
        const double J0 = g0, J1 = g1, J2 = g2;
        s[0] += J0 * J0; s[1] += J0 * J1; s[2] += J0 * J2;
        s[3] += J1 * J1; s[4] += J1 * J2; s[5] += J2 * J2;
        s[6] += J0 * res; s[7] += J1 * res; s[8] += J2 * res;
        s[9] += res * res;
      }
    }
  }
  if (lane == 0)
    for (int m = 0; m < 10; ++m) red[warp][m] = s[m];
  __syncthreads();
  double* mine = part + ((size_t)q * MAX_BLOCKS + blockIdx.x) * 10;
  if (threadIdx.x < 10) {
    double t = 0;
    for (int w = 0; w < WARPS; ++w) t += red[w][threadIdx.x];
    mine[threadIdx.x] = t;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + q, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last || threadIdx.x >= 10) return;
  __threadfence();
  double t = 0;
  for (int blk = 0; blk < (int)gridDim.x; ++blk)
    t += __ldcg(part + ((size_t)q * MAX_BLOCKS + blk) * 10 + threadIdx.x);
  out[q * 10 + threadIdx.x] = t;
}

// The symmetry term's tables (float32 unless said): cs, sn, dz (k, P, 2)
// each pair's two ops' in-plane cos and sin and z shift (h * rise), pv (k,
// P) the slot's validity (0 / 1), keep (k, P, vol) bytes (null: all) the
// deduplication mask, inmask (vol) bytes the voxels inside the mask.
struct SymTables {
  const float *cs, *sn, *dz, *pv;
  const uint8_t *keep, *inmask;
  int k, P, d3, l3;
};

// The value of x at op (c, s, dz) applied to the voxel (xc, yc, zc)
// (centred coordinates), in the plain version's order: X = (xc c - yc s) +
// d3//2, Y = (xc s + yc c) + d3//2, Z = (zc + dz) + l3//2. Returns the
// sample's flat index (the cell's base corner for linear), or -1 when it is
// not valid; w gets linear's weights.
template <bool LINEAR>
__device__ __forceinline__ int sym_sample(float xc, float yc, float zc, float c, float s, float dz,
                                          float h3, float hl, int d3, int l3, const uint8_t* ok,
                                          const float* xs, const int* off, float w[8],
                                          float& val) {
  const float X = __fadd_rn(__fsub_rn(__fmul_rn(xc, c), __fmul_rn(yc, s)), h3);
  const float Y = __fadd_rn(__fadd_rn(__fmul_rn(xc, s), __fmul_rn(yc, c)), h3);
  const float Z = __fadd_rn(__fadd_rn(zc, dz), hl);
  if (!LINEAR) {
    const int idx = nn_index(X, Y, Z, d3, l3, ok);
    if (idx >= 0) val = xs[idx];
    return idx;
  }
  float wz, wy, wx;
  const int base = cell(X, Y, Z, d3, l3, ok, wz, wy, wx);
  if (base < 0) return -1;
  tri_weights(wz, wy, wx, w);
  val = __fmul_rn(w[0], xs[base]);
#pragma unroll
  for (int a = 1; a < 8; ++a) val = __fadd_rn(val, __fmul_rn(w[a], xs[base + off[a]]));
  return base;
}

// K4: out (k, vol) = ST(S(x)) of the symmetry pairs, the symmetry term of
// the gather projector's normal operator. For candidate q, pair p and
// voxel v (v in the mask, the slot populated, keep set): with both ops'
// samples valid, s = x(g1 v) - x(g2 v) is added back at g1 v's taps and
// subtracted at g2 v's, summed exactly (above) at the scale of n_terms
// terms of at most amax each. accg (k, vol) and done (k,) must hold
// zeros.
template <bool LINEAR>
__global__ void __launch_bounds__(NT) sym_normal_kernel(SymTables st, const float* __restrict__ x,
                                                        const uint8_t* __restrict__ ok_g,
                                                        const unsigned* __restrict__ amax,
                                                        double n_terms, long long* accg,
                                                        unsigned* done, float* __restrict__ out,
                                                        int smem) {
  extern __shared__ __align__(16) unsigned char shm[];
  const int q = blockIdx.y;
  const int d3 = st.d3, l3 = st.l3, plane = d3 * d3;
  const int vol = l3 * plane;
  unsigned long long* acc = sums_of(shm, accg, q, vol, smem != 0);
  const float* xq = x + (size_t)q * vol;
  const float* xs = xq;
  const uint8_t* ok = ok_g;
  if (smem) {
    float* sx = reinterpret_cast<float*>(shm + (size_t)vol * 8);
    uint8_t* sok = shm + (size_t)vol * 12;
    for (int v = threadIdx.x; v < vol; v += NT) {
      sx[v] = __ldg(xq + v);
      sok[v] = __ldg(ok_g + v);
    }
    xs = sx;
    ok = sok;
  }
  __syncthreads();
  const double sc = scale_of(amax[q], n_terms);
  const float h3 = (float)(d3 / 2), hl = (float)(l3 / 2);
  int off[8];
  corner_offsets(d3, off);
  const long n = (long)st.P * vol;
  for (long it = (long)blockIdx.x * NT + threadIdx.x; it < n; it += (long)gridDim.x * NT) {
    const int p = (int)(it / vol), v = (int)(it % vol);
    const int qp = q * st.P + p;
    if (st.pv[qp] == 0.f || !st.inmask[v] || (st.keep && !st.keep[(size_t)qp * vol + v]))
      continue;
    const float zc = (float)(v / plane - l3 / 2), yc = (float)((v / d3) % d3 - d3 / 2);
    const float xc = (float)(v % d3 - d3 / 2);
    float w1[8], w2[8], a1 = 0.f, a2 = 0.f;
    const int i1 = sym_sample<LINEAR>(xc, yc, zc, st.cs[2 * qp], st.sn[2 * qp], st.dz[2 * qp],
                                      h3, hl, d3, l3, ok, xs, off, w1, a1);
    if (i1 < 0) continue;
    const int i2 = sym_sample<LINEAR>(xc, yc, zc, st.cs[2 * qp + 1], st.sn[2 * qp + 1],
                                      st.dz[2 * qp + 1], h3, hl, d3, l3, ok, xs, off, w2, a2);
    if (i2 < 0) continue;
    const float s = __fsub_rn(a1, a2);
    if (s == 0.f) continue;
    if (LINEAR) {
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        atomicAdd(acc + i1 + off[a], fixed(__fmul_rn(w1[a], s), sc));
        atomicAdd(acc + i2 + off[a], fixed(__fmul_rn(w2[a], -s), sc));
      }
    } else {
      atomicAdd(acc + i1, fixed(s, sc));
      atomicAdd(acc + i2, fixed(-s, sc));
    }
  }
  flush(acc, accg, q, vol, smem != 0);
  finish(accg, done, sc, out, vol, q);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// Blocks a candidate: about six blocks an SM over the launch, at most one
// warp a group of 32 rays.
dim3 grid_of(const Tables& tb) {
  const long groups = ((long)tb.C * tb.l2 * tb.d2 + 31) / 32;
  long per = (6L * sm_count() + tb.k - 1) / tb.k;
  const long most = (groups + WARPS - 1) / WARPS;
  if (per > most) per = most;
  if (per > MAX_BLOCKS) per = MAX_BLOCKS;
  if (per < 1) per = 1;
  return dim3((unsigned)per, (unsigned)tb.k);
}

// Blocks a candidate of K4: about two blocks an SM over the launch (each
// zeroes, and flushes, a whole volume of sums), one (pair, voxel) a thread
// at most.
dim3 sym_grid_of(const SymTables& st) {
  const long items = (long)st.P * st.l3 * st.d3 * st.d3;
  long per = (2L * sm_count() + st.k - 1) / st.k;
  const long most = (items + NT - 1) / NT;
  if (per > most) per = most;
  if (per < 1) per = 1;
  return dim3((unsigned)per, (unsigned)st.k);
}

// Shared memory bytes the kernel's staging needs at `per` bytes a voxel
// (0: the device-memory branch), within smem_limit.
size_t smem_bytes(const void* fn, int vol, int per, int smem_limit) {
  const size_t need = (size_t)vol * per;
  if ((long)need > (long)smem_limit) return 0;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
  return need;
}

Tables tables(const float* R, const float* dR, const float* cs, const float* sn, const float* dz,
              const float* cv, const float* x0, const float* y0, const float* z0, int k, int C,
              int l2, int d2, int d3, int l3) {
  return Tables{R, dR, cs, sn, dz, cv, x0, y0, z0, k, C, l2, d2, d3, l3, nullptr, nullptr, 0};
}

// The grid of a launch on the list (rptr, ridx), n_max the longest
// candidate's entries: rays a block (tb.rpb) so that the launch has about
// eight blocks an SM, at least 32; blocks a candidate to cover n_max.
dim3 list_grid(Tables& tb, const int* rptr, const int* ridx, int n_max) {
  tb.rptr = rptr;
  tb.ridx = ridx;
  long rpb = ((long)n_max * tb.k + 8L * sm_count() - 1) / (8L * sm_count());
  if (rpb < 32) rpb = 32;
  tb.rpb = (int)rpb;
  long per = ((long)n_max + rpb - 1) / rpb;
  if (per < 1) per = 1;
  return dim3((unsigned)per, (unsigned)tb.k);
}

}  // namespace

extern "C" {

// K1. ok_g (vol bytes): the validity bytes (aux > 0.5) the device-memory
// branch reads. x, pred, rowv may be null.
// rptr (k + 1) / ridx: the list of live rays, or null (every ray tested);
// n_max its longest candidate's entries. With the list pred is zeroed
// here and the kernel writes the listed rays.
int hgp_project(const float* x, const float* aux, const uint8_t* ok_g, const float* R,
                const float* cs, const float* sn, const float* dz, const float* cv,
                const float* x0, const float* y0, const float* z0, const int* rptr,
                const int* ridx, float* pred, uint8_t* rowv, int k, int C, int l2, int d2,
                int d3, int l3, int linear, int n_max, int smem_limit, cudaStream_t st) {
  Tables tb = tables(R, nullptr, cs, sn, dz, cv, x0, y0, z0, k, C, l2, d2, d3, l3);
  const dim3 grid = rptr ? list_grid(tb, rptr, ridx, n_max) : grid_of(tb);
  const int vol = l3 * d3 * d3;
  // the listed launch writes the live rays alone
  if (rptr && pred) cudaMemsetAsync(pred, 0, sizeof(float) * k * C * l2 * d2, st);
  const void* fn = linear ? (const void*)project_kernel<true> : (const void*)project_kernel<false>;
  const size_t sm = smem_bytes(fn, vol, x != nullptr ? 5 : 1, smem_limit);
  if (linear)
    project_kernel<true><<<grid, NT, sm, st>>>(tb, x, aux, ok_g, pred, rowv, sm > 0);
  else
    project_kernel<false><<<grid, NT, sm, st>>>(tb, x, aux, ok_g, pred, rowv, sm > 0);
  return (int)cudaGetLastError();
}

// The max pass of the exact sums on v (k, n) into amax (k,), zeroed here.
void launch_amax(const float* v, long n, int k, unsigned* amax, cudaStream_t st) {
  cudaMemsetAsync(amax, 0, sizeof(unsigned) * k, st);
  long per = (2L * sm_count() + k - 1) / k;
  const long most = (n + NT - 1) / NT;
  if (per > most) per = most;
  if (per < 1) per = 1;
  amax_kernel<<<dim3((unsigned)per, (unsigned)k), NT, 0, st>>>(v, n, amax);
}

// K2. ok_g (vol) the validity bytes; amax (k,) uint32, accg (k, vol) int64
// and done (k,) scratch, zeroed here; out (k, vol). Launches the max pass
// over r, then the kernel.
int hgp_backproject(const float* r, const uint8_t* ok_g, const float* R, const float* cs,
                    const float* sn, const float* dz, const float* cv, const float* x0,
                    const float* y0, const float* z0, const int* rptr, const int* ridx,
                    unsigned* amax, long long* accg, unsigned* done, float* out, int k, int C,
                    int l2, int d2, int d3, int l3, int linear, int n_max, int smem_limit,
                    cudaStream_t st) {
  Tables tb = tables(R, nullptr, cs, sn, dz, cv, x0, y0, z0, k, C, l2, d2, d3, l3);
  const dim3 grid = rptr ? list_grid(tb, rptr, ridx, n_max) : grid_of(tb);
  const int vol = l3 * d3 * d3;
  const long n_rays = (long)C * l2 * d2;
  cudaMemsetAsync(accg, 0, sizeof(long long) * k * vol, st);
  cudaMemsetAsync(done, 0, sizeof(unsigned) * k, st);
  launch_amax(r, n_rays, k, amax, st);
  // a sample's weights sum to 1: at most max |r| a sample
  const double n_terms = (double)n_rays * d2;
  const void* fn =
      linear ? (const void*)backproject_kernel<true> : (const void*)backproject_kernel<false>;
  const size_t sm = smem_bytes(fn, vol, 9, smem_limit);
  if (linear)
    backproject_kernel<true><<<grid, NT, sm, st>>>(tb, r, ok_g, amax, n_terms, accg, done, out,
                                                   sm > 0);
  else
    backproject_kernel<false><<<grid, NT, sm, st>>>(tb, r, ok_g, amax, n_terms, accg, done, out,
                                                    sm > 0);
  return (int)cudaGetLastError();
}

// K3. part (k, MAX_BLOCKS, 10) float64 scratch; done (k,) must hold zeros;
// out (k, 10) float64.
int hgp_pose_jacobian(const float* x, const float* cellok, const uint8_t* ok_g, const float* R,
                      const float* dR, const float* cs, const float* sn, const float* dz,
                      const float* cv, const float* x0, const float* y0, const float* z0,
                      const float* b, double* part, unsigned* done, double* out, int k, int C,
                      int l2, int d2, int d3, int l3, int smem_limit, cudaStream_t st) {
  const Tables tb = tables(R, dR, cs, sn, dz, cv, x0, y0, z0, k, C, l2, d2, d3, l3);
  const int vol = l3 * d3 * d3;
  const size_t sm = smem_bytes((const void*)pose_jacobian_kernel, vol, 5, smem_limit);
  pose_jacobian_kernel<<<grid_of(tb), NT, sm, st>>>(tb, x, cellok, ok_g, b, part, done, out,
                                                    sm > 0);
  return (int)cudaGetLastError();
}

// K4. cs, sn, dz (k, P, 2), pv (k, P), keep (k, P, vol) bytes or null,
// inmask and ok_g (vol) bytes (the voxels in the mask, the sampler's
// validity); amax (k,) uint32, accg (k, vol) int64 and done (k,) scratch,
// zeroed here; out (k, vol). Launches the max pass over x, then the kernel.
int hgp_sym_normal(const float* x, const uint8_t* ok_g, const float* cs, const float* sn,
                   const float* dz, const float* pv, const uint8_t* keep, const uint8_t* inmask,
                   unsigned* amax, long long* accg, unsigned* done, float* out, int k, int P,
                   int d3, int l3, int linear, int smem_limit, cudaStream_t stream) {
  const SymTables st{cs, sn, dz, pv, keep, inmask, k, P, d3, l3};
  const int vol = l3 * d3 * d3;
  cudaMemsetAsync(accg, 0, sizeof(long long) * k * vol, stream);
  cudaMemsetAsync(done, 0, sizeof(unsigned) * k, stream);
  launch_amax(x, vol, k, amax, stream);
  // a pair's row is at most 2 max |x|, added back at two samples
  const double n_terms = 4.0 * P * vol;
  const void* fn =
      linear ? (const void*)sym_normal_kernel<true> : (const void*)sym_normal_kernel<false>;
  const size_t sm = smem_bytes(fn, vol, 13, smem_limit);
  if (linear)
    sym_normal_kernel<true><<<sym_grid_of(st), NT, sm, stream>>>(st, x, ok_g, amax, n_terms,
                                                                 accg, done, out, sm > 0);
  else
    sym_normal_kernel<false><<<sym_grid_of(st), NT, sm, stream>>>(st, x, ok_g, amax, n_terms,
                                                                  accg, done, out, sm > 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
