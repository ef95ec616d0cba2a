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
// - gather_normal: the data term of the solver's normal operator,
//   PT(rows * P(x)), K1 and K2 on the list of live rays in one call.
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
// peak). All of them are bound by the per-ray work and the latency of
// gathers from on-chip memory, far above both floors.
//
// What the design does about it: one warp per ray, its lanes striding over the
// d2 samples, the sums reduced by shuffles. The rays that cannot hold a valid
// sample are found 32 at a time, a lane each, and skipped (below); once per
// pose the wrapper lists the rays that hold one (K1's row validity), and K1
// and K2 then take the listed rays alone for the ~30 applications of a solve.
// K1 and K2 run one block of 32 warps an SM (the grid the wrapper sizes:
// blocks a candidate so that the launch fills the SMs once, each block walking
// a contiguous share of the list, at least MIN_RAYS rays), so a block's fixed
// costs (its tables, its sums) are paid once an SM and not once for a few
// dozen rays. A block serves one candidate (blockIdx.y). Each block computes
// the rotation's products with the ray parameter once (xr, in shared memory)
// and each ray's products with its y and z once, so a sample's coordinates are
// sixteen rounded operations. With an nn list's sample table (built once a
// pose, sample_table_kernel), K1 and K2 read each sample's voxel instead of
// computing it: four bytes a sample against ~40 instructions, which measured a
// third faster; a linear table (sixteen bytes a sample) measured slower than
// computing, so linear lists have none (PERF.md). Each warp loads the list
// entries of its run 32 at a time (warp_run). K1 reads the volume and the
// validity bytes through the cache (35 KB stays in L1), which measured faster
// than staging them in shared memory (PERF.md). K2 adds into a block-private
// copy of the volume in shared memory with shared atomics (past smem_limit,
// into the block's own slice of device memory) and writes it once, without
// atomics, to a partial buffer (blocks, vol); a reduce pass adds a candidate's
// partials and converts them. The sums are exact: each term is a 64-bit
// integer at a power-of-two scale (fixed() below), so neither the order of the
// atomics nor the split into blocks changes a bit, and the plain versions,
// which add the same integers, give the same result. gather_normal's first
// kernel writes each listed ray's rows * P(x) to a compact (k, n_max) buffer
// with each block's max |value|, so the dense prediction, its memset, the
// multiply and the max pass over every ray are gone. K3 walks the same list
// (built at the Gauss-Newton pose), its blocks of 8 warps sized to it
// (gather_kernels.jacobian_grid), the volume read through the cache; it keeps
// each ray's value and its three derivatives in registers and the
// per-candidate sums in float64, and adds the blocks' sums in a fixed order.
// K4's symmetry term touches pairs x l3 x d3^2 items of a 35 KB volume, so a
// call is as short as a launch: its bound is the host's and the launches'.
// Once per symmetry tables (the pose's solve), two build kernels list its
// items (the (pair, voxel) rows of S that can be nonzero) with their samples
// (nn: two voxels; linear: two cells and their weights), and the wrapper
// sorts their incidences by output voxel; a call is then two kernels, no
// memset and no atomics: the rows' differences with the max pass, and a
// gather of each voxel's incidences into its own integer sum. Copy slots that
// are padding are skipped whole, and so is every ray
// whose two end samples (Z is monotone along the ray) put all its samples
// outside the volume's z range: at the amyloid's geometry (l2 = 256 rows at
// 2/3 voxel, l3 = 6 planes) that is most rays. Every C entry serves the k
// candidates of a launch at once.
//
// Traps, each kept here:
// - nvcc contracts a*b+c into FMAs by default, which moves nearest-
//   neighbour samples that sit half-way between voxels (the reference's
//   jitted XLA has that fault, ROADMAP C6). The coordinate arithmetic is
//   written with __fmul_rn / __fadd_rn / __fsub_rn, which are never
//   contracted, in the order of the plain PyTorch version, so each sample
//   lands where the plain version puts it, bit for bit (a product hoisted
//   out of the sample loop is the same rounded product).
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
// Every C entry launches its kernels on the given stream (a mask `steps`
// picks some of them, for timing them alone), allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <mutex>

namespace {

constexpr int NT = 256;  // threads a block of K3, K4 and the max pass: 8 warps
constexpr int WARPS = NT / 32;
constexpr int GT = 1024;  // threads a block of K1 and K2: 32 warps, one block an SM
constexpr int GWARPS = GT / 32;

// The per-candidate tables of a launch (float32): R (k, 9) the inverse pose
// rotation, dR (k, 18) its derivatives by tilt and psi (K3 only), cs / sn /
// dz / cv (k, C) each copy's in-plane cos and sin, z shift and slot
// validity (0 / 1), x0 (d2) the ray parameter's x, y0 (k, d2) the column's
// y less dy, z0 (l2) the row's z.
// With a list of live rays (rptr non-null: candidate q's rays are ridx[rptr[q]
// .. rptr[q+1]), the rays of its pose that hold a valid sample; n_max the
// longest candidate's), block b of a candidate takes its entries b*rpb ..
// (b+1)*rpb; without, every ray is tested (live()). With the list's sample
// table (nn; sidx non-null, sample_table_kernel), entry s = e - rptr[q] of
// candidate q reads sample kk's voxel, -1 where it is not valid, at
// sidx[(q * n_max + s) * d2 + kk] instead of computing it.
struct Tables {
  const float *R, *dR, *cs, *sn, *dz, *cv, *x0, *y0, *z0;
  int k, C, l2, d2, d3, l3;
  const int *rptr, *ridx;
  int rpb, n_max;
  const int* sidx;
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

// K1 and K2 sample a ray at (X, Y, Z) = coords of dot3_rn(R, x0, y0, z0)
// for each row of R. The products R[3a] * x0[kk] are the same for every ray
// of a candidate (xr, (3, d2) in shared memory, made by xr_table) and
// R[3a + 1] * y0, R[3a + 2] * z0 for every sample of a ray (RayCoords), so
// a sample adds them in dot3_rn's order: the same rounded operations.
__device__ __forceinline__ void xr_table(const float* R, const float* x0, int d2, float* xr) {
  for (int t = threadIdx.x; t < 3 * d2; t += blockDim.x)
    xr[t] = __fmul_rn(R[3 * (t / d2)], x0[t % d2]);
}

struct RayCoords {
  float ry[3], rz[3];
  float c, s, dz;
};

__device__ __forceinline__ RayCoords ray_coords(const Ray& rr, const float* R) {
  RayCoords rc;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    rc.ry[a] = __fmul_rn(R[3 * a + 1], rr.y0);
    rc.rz[a] = __fmul_rn(R[3 * a + 2], rr.z0);
  }
  rc.c = rr.c;
  rc.s = rr.s;
  rc.dz = rr.dz;
  return rc;
}

// Sample kk of the ray: its volume coordinates (X, Y, Z).
__device__ __forceinline__ void sample_at(const RayCoords& rc, const float* xr, int d2, int kk,
                                          float h3, float hl, float& X, float& Y, float& Z) {
  const float bx = __fadd_rn(__fadd_rn(xr[kk], rc.ry[0]), rc.rz[0]);
  const float by = __fadd_rn(__fadd_rn(xr[d2 + kk], rc.ry[1]), rc.rz[1]);
  const float bz = __fadd_rn(__fadd_rn(xr[2 * d2 + kk], rc.ry[2]), rc.rz[2]);
  coords(bx, by, bz, rc.c, rc.s, rc.dz, h3, hl, X, Y, Z);
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

// The run [w0, w1) of the block's entries [e0, e1) that warp `warp` of
// `warps` takes: a contiguous 1 / warps of them. Its lanes load up to 32
// entries of the run (the ray and its value) at once, and the warp then
// takes them in turn from the lanes' registers, so the list's two
// dependent loads a ray are paid once for 32 rays.
__device__ __forceinline__ void warp_run(int e0, int e1, int warp, int warps, int& w0, int& w1) {
  const int m = (e1 - e0 + warps - 1) / warps;
  w0 = min(e1, e0 + warp * m);
  w1 = min(e1, w0 + m);
}

// Sample kk of a ray: its voxel (nn) or its cell's base corner and
// fractions (linear), -1 where it is not valid; with the ray's row of the
// sample table (si, nn) the table's entry tix (si[kk]), else computed from
// its coordinates (rc).
template <bool LINEAR>
__device__ __forceinline__ int sample_of(const RayCoords& rc, const float* xr, const int* si,
                                         int tix, int d2, int kk, int d3, int l3,
                                         const uint8_t* ok, float h3, float hl, float& wz,
                                         float& wy, float& wx) {
  if (!LINEAR && si) return tix;
  float X, Y, Z;
  sample_at(rc, xr, d2, kk, h3, hl, X, Y, Z);
  return LINEAR ? cell(X, Y, Z, d3, l3, ok, wz, wy, wx) : nn_index(X, Y, Z, d3, l3, ok);
}

// The row of the sample table of candidate q's list slot s (null without
// a table).
__device__ __forceinline__ const int* table_si(const Tables& tb, int q, int s) {
  return tb.sidx ? tb.sidx + ((size_t)q * tb.n_max + s) * tb.d2 : nullptr;
}

// A ray's first two table entries that a lane takes (kk = lane, lane + 32;
// -1 past d2 or without a table), loaded a ray ahead of their use so that
// their latency hides behind the ray before.
struct Ahead {
  int a, b;
};

__device__ __forceinline__ Ahead ahead_of(const int* si, int d2, int lane) {
  Ahead h{-1, -1};
  if (si) {
    if (lane < d2) h.a = si[lane];
    if (lane + 32 < d2) h.b = si[lane + 32];
  }
  return h;
}

// The table entry of the m-th sample a lane takes (kk = lane + 32 m).
__device__ __forceinline__ int table_entry(const int* si, const Ahead& h, int m, int kk) {
  return !si ? 0 : m == 0 ? h.a : m == 1 ? h.b : si[kk];
}

// K1 on one ray: the sum of its samples in warp_sum's order (lane 0's
// value is the plain version's) and whether any is valid; si its row of
// the sample table (h its first entries), or null.
template <bool LINEAR>
__device__ __forceinline__ float project_ray(const Tables& tb, int q, int ray, const int* si,
                                             const Ahead& h, const float* R, const float* xr,
                                             const float* xs, const uint8_t* ok, float h3,
                                             float hl, int lane, bool& valid) {
  const int d2 = tb.d2, d3 = tb.d3, l3 = tb.l3;
  RayCoords rc;
  if (!si) rc = ray_coords(ray_of(tb, q, ray), R);
  float acc = 0.f;
  bool any = false;
  for (int m = 0, kk = lane; kk < d2; ++m, kk += 32) {
    float wz, wy, wx;
    const int base = sample_of<LINEAR>(rc, xr, si, table_entry(si, h, m, kk), d2, kk, d3, l3,
                                       ok, h3, hl, wz, wy, wx);
    if (LINEAR) {
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
      if (base < 0) continue;
      any = true;
      if (xs) acc += xs[base];
    }
  }
  valid = __any_sync(0xffffffffu, any);
  return warp_sum(acc);
}

// Each block's max |value| as bits into bmax (nonnegative floats order as
// their bits, and a NaN's bits exceed every other's); every thread of the
// block calls it.
__device__ void block_max(unsigned m, unsigned* bmax) {
  __shared__ unsigned wm[32];
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) wm[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = max(m, wm[w]);
    *bmax = m;
  }
}

// K1: pred (k, C, l2, d2) and optionally row_valid (same shape, bytes).
// x (k, vol) may be null (row validity alone); it and the validity bytes
// ok (vol) are read through the cache (35 KB stays in L1). With a list,
// only the listed rays are written: pred must hold zeros, and rowv is not
// written. With rows (k, C, l2, d2) (gather_normal's first kernel, on a
// list), entry e of candidate q writes rows * P(x) of its ray to comp[q *
// n_max + e - rptr[q]] instead of pred, and each block its max |value| to
// bmax (k, gridDim.x).
template <bool LINEAR>
__global__ void __launch_bounds__(GT) project_kernel(Tables tb, const float* __restrict__ x,
                                                     const uint8_t* __restrict__ ok,
                                                     float* __restrict__ pred,
                                                     uint8_t* __restrict__ rowv,
                                                     const float* __restrict__ rows,
                                                     float* __restrict__ comp,
                                                     unsigned* __restrict__ bmax) {
  extern __shared__ __align__(16) unsigned char shm[];
  const int q = blockIdx.y;
  int e0 = 0, e1 = 0;
  if (tb.rptr) {
    block_entries(tb, q, e0, e1);
    if (e0 >= e1) {  // the whole block: nothing listed here
      if (bmax && threadIdx.x == 0) bmax[q * gridDim.x + blockIdx.x] = 0u;
      return;
    }
  }
  const int d2 = tb.d2, d3 = tb.d3, l3 = tb.l3;
  const int vol = l3 * d3 * d3;
  const float* R = tb.R + q * 9;
  float* xr = reinterpret_cast<float*>(shm);
  xr_table(R, tb.x0, d2, xr);
  __syncthreads();
  const float* xs = x ? x + (size_t)q * vol : nullptr;
  const float h3 = (float)(d3 / 2), hl = (float)(l3 / 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_rays = tb.C * tb.l2 * d2;
  const size_t out0 = (size_t)q * n_rays;
  bool valid;
  if (tb.rptr) {
    unsigned m = 0;
    int w0, w1;
    warp_run(e0, e1, warp, GWARPS, w0, w1);
    for (int base = w0; base < w1; base += 32) {
      int ray = 0;
      float rw = 0.f;
      if (base + lane < w1) {
        ray = tb.ridx[base + lane];
        if (comp) rw = rows[out0 + ray];
      }
      const int n = min(32, w1 - base);
      Ahead next = ahead_of(table_si(tb, q, base - tb.rptr[q]), d2, lane);
      for (int j = 0; j < n; ++j) {
        const int rj = __shfl_sync(0xffffffffu, ray, j);
        const float wj = __shfl_sync(0xffffffffu, rw, j);
        const int slot = base + j - tb.rptr[q];
        const Ahead cur = next;
        if (j + 1 < n) next = ahead_of(table_si(tb, q, slot + 1), d2, lane);
        const float v = project_ray<LINEAR>(tb, q, rj, table_si(tb, q, slot), cur, R, xr, xs,
                                            ok, h3, hl, lane, valid);
        if (lane == 0 && comp) {
          const float t = __fmul_rn(v, wj);
          comp[(size_t)q * tb.n_max + (base + j - tb.rptr[q])] = t;
          m = max(m, __float_as_uint(fabsf(t)));
        } else if (lane == 0) {
          pred[out0 + rj] = v;
        }
      }
    }
    if (bmax) block_max(m, bmax + q * gridDim.x + blockIdx.x);
    return;
  }
  for (int g = (blockIdx.x * GWARPS + warp) * 32; g < n_rays; g += gridDim.x * GWARPS * 32) {
    const bool mine = live(tb, q, g + lane, n_rays, R, hl, LINEAR);
    if (!mine && g + lane < n_rays) {  // no valid sample: written here, coalesced
      if (pred) pred[out0 + g + lane] = 0.f;
      if (rowv) rowv[out0 + g + lane] = 0;
    }
    for (unsigned todo = __ballot_sync(0xffffffffu, mine); todo; todo &= todo - 1) {
      const int ray = g + __ffs(todo) - 1;
      const float v = project_ray<LINEAR>(tb, q, ray, nullptr, Ahead{-1, -1}, R, xr, xs, ok, h3,
                                          hl, lane, valid);
      if (lane == 0) {
        if (pred) pred[out0 + ray] = v;
        if (rowv) rowv[out0 + ray] = valid ? 1 : 0;
      }
    }
  }
}

// The exact sums of the transposes (K2, K4). Each term t becomes the 64-bit
// integer rint(t * scale), scale a power of two per candidate that keeps
// every partial sum below 2^61 (gather_kernels.fixed_scales). Integer
// additions do not depend on their order, so every run, whatever order the
// atomics land in and however the blocks split the rays, and the plain
// version (an int64 index_add_ of the same terms) give the same bits. The
// sums become float32 once: double(sum) / scale.
__device__ __forceinline__ unsigned long long fixed(float t, double scale) {
  return (unsigned long long)__double2ll_rn((double)t * scale);
}

constexpr int FIXED_BITS = 61;

// K2's max pass: each block's max |v| over its share of each candidate's n
// values (k, n) into bmax (k, gridDim.x), without atomics or zeroing.
__global__ void __launch_bounds__(NT) max_kernel(const float* __restrict__ v, long n,
                                                 unsigned* __restrict__ bmax) {
  const float* vq = v + (size_t)blockIdx.y * n;
  unsigned m = 0;
  long i = (long)blockIdx.x * NT + threadIdx.x;
  const long stride = (long)gridDim.x * NT;
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(vq) & 15) == 0) {  // 16 bytes a load
    const float4* v4 = reinterpret_cast<const float4*>(vq);
    for (; i < n / 4; i += stride) {
      const float4 a = __ldg(v4 + i);
      m = max(max(m, __float_as_uint(fabsf(a.x))), __float_as_uint(fabsf(a.y)));
      m = max(max(m, __float_as_uint(fabsf(a.z))), __float_as_uint(fabsf(a.w)));
    }
  } else {
    for (; i < n; i += stride) m = max(m, __float_as_uint(fabsf(__ldg(vq + i))));
  }
  block_max(m, bmax + blockIdx.y * gridDim.x + blockIdx.x);
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

// scale_of the max of a candidate's nb block maxima (bmax); every thread
// of the block calls it and gets the scale.
__device__ double block_scale(const unsigned* bmax, int nb, double n_terms) {
  __shared__ double sc;
  if (threadIdx.x < 32) {
    unsigned m = 0;
    for (int b = threadIdx.x; b < nb; b += 32) m = max(m, bmax[b]);
    for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) sc = scale_of(m, n_terms);
  }
  __syncthreads();
  return sc;
}

// K2 on one ray of value rv: each valid sample's terms added into acc; si
// its row of the sample table (h its first entries), or null.
template <bool LINEAR>
__device__ __forceinline__ void backproject_ray(const Tables& tb, int q, int ray, const int* si,
                                                const Ahead& h, float rv, const float* R,
                                                const float* xr, const uint8_t* ok, float h3,
                                                float hl, int lane, unsigned long long* acc,
                                                double sc) {
  const int d2 = tb.d2, d3 = tb.d3, l3 = tb.l3;
  RayCoords rc;
  if (!si) rc = ray_coords(ray_of(tb, q, ray), R);
  const unsigned long long term = fixed(rv, sc);  // nn: every sample's
  for (int m = 0, kk = lane; kk < d2; ++m, kk += 32) {
    float wz, wy, wx;
    const int base = sample_of<LINEAR>(rc, xr, si, table_entry(si, h, m, kk), d2, kk, d3, l3,
                                       ok, h3, hl, wz, wy, wx);
    if (base < 0) continue;
    if (LINEAR) {
      float w[8];
      int off[8];
      tri_weights(wz, wy, wx, w);
      corner_offsets(d3, off);
#pragma unroll
      for (int a = 0; a < 8; ++a) atomicAdd(acc + base + off[a], fixed(__fmul_rn(w[a], rv), sc));
    } else {
      atomicAdd(acc + base, term);
    }
  }
}

// K2's sums: block (b, q) adds the terms of its rays, at the scale of
// n_terms terms of at most the max of bmax (k, nbmax) each, into a
// private volume and writes it to part[q, b] (part (k, gridDim.x, vol)
// int64), which reduce_kernel adds up. The values are r (k, C, l2, d2) at
// each ray or, with comp (gather_normal, on a list), comp[q * n_max + e -
// rptr[q]] at entry e. A listed block with no entries writes nothing.
template <bool LINEAR>
__global__ void __launch_bounds__(GT) backproject_kernel(Tables tb, const float* __restrict__ r,
                                                         const float* __restrict__ comp,
                                                         const uint8_t* __restrict__ ok_g,
                                                         const unsigned* __restrict__ bmax,
                                                         int nbmax, double n_terms,
                                                         unsigned long long* __restrict__ part,
                                                         int smem) {
  extern __shared__ __align__(16) unsigned char shm[];
  const int q = blockIdx.y;
  int e0 = 0, e1 = 0;
  if (tb.rptr) {
    block_entries(tb, q, e0, e1);
    if (e0 >= e1) return;  // the whole block alike
  }
  const int d2 = tb.d2, d3 = tb.d3, l3 = tb.l3;
  const int vol = l3 * d3 * d3;
  const double sc = block_scale(bmax + q * nbmax, nbmax, n_terms);
  const float* R = tb.R + q * 9;
  unsigned long long* mine = part + ((size_t)q * gridDim.x + blockIdx.x) * vol;
  unsigned long long* acc = smem ? reinterpret_cast<unsigned long long*>(shm) : mine;
  float* xr = reinterpret_cast<float*>(shm + (smem ? (size_t)vol * 8 : 0));
  for (int v = threadIdx.x; v < vol; v += GT) acc[v] = 0ull;
  xr_table(R, tb.x0, d2, xr);
  const uint8_t* ok = ok_g;
  if (smem) {
    uint8_t* sok = reinterpret_cast<uint8_t*>(xr + 3 * d2);
    for (int v = threadIdx.x; v < vol; v += GT) sok[v] = __ldg(ok_g + v);
    ok = sok;
  }
  __syncthreads();
  const float h3 = (float)(d3 / 2), hl = (float)(l3 / 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_rays = tb.C * tb.l2 * d2;
  if (tb.rptr) {
    const float* cq = comp ? comp + (size_t)q * tb.n_max - tb.rptr[q] : nullptr;
    const float* rq = r ? r + (size_t)q * n_rays : nullptr;
    int w0, w1;
    warp_run(e0, e1, warp, GWARPS, w0, w1);
    for (int base = w0; base < w1; base += 32) {
      int ray = 0;
      float val = 0.f;
      if (base + lane < w1) {
        ray = tb.ridx[base + lane];
        val = cq ? cq[base + lane] : rq[ray];
      }
      const int n = min(32, w1 - base);
      Ahead next = ahead_of(table_si(tb, q, base - tb.rptr[q]), d2, lane);
      for (int j = 0; j < n; ++j) {
        const int rj = __shfl_sync(0xffffffffu, ray, j);
        const float rv = __shfl_sync(0xffffffffu, val, j);
        const int slot = base + j - tb.rptr[q];
        const Ahead cur = next;
        if (j + 1 < n) next = ahead_of(table_si(tb, q, slot + 1), d2, lane);
        if (rv != 0.f)
          backproject_ray<LINEAR>(tb, q, rj, table_si(tb, q, slot), cur, rv, R, xr, ok, h3, hl,
                                  lane, acc, sc);
      }
    }
  } else {
    const float* rq = r + (size_t)q * n_rays;
    for (int g = (blockIdx.x * GWARPS + warp) * 32; g < n_rays; g += gridDim.x * GWARPS * 32) {
      const bool take = live(tb, q, g + lane, n_rays, R, hl, LINEAR) && rq[g + lane] != 0.f;
      for (unsigned todo = __ballot_sync(0xffffffffu, take); todo; todo &= todo - 1) {
        const int ray = g + __ffs(todo) - 1;
        backproject_ray<LINEAR>(tb, q, ray, nullptr, Ahead{-1, -1}, rq[ray], R, xr, ok, h3, hl,
                                lane, acc, sc);
      }
    }
  }
  if (!smem) return;
  __syncthreads();
  for (int v = threadIdx.x; v < vol; v += GT) mine[v] = acc[v];
}

// The sample table of an nn list (Tables' sidx, which it writes): for
// every listed ray, each sample's voxel, -1 where it is not valid,
// computed as K1 computes it, so that K1 and K2 on the table read what they
// would compute. Built once a pose; slots past a candidate's entries are
// left as they are.
__global__ void __launch_bounds__(GT) sample_table_kernel(Tables tb,
                                                          const uint8_t* __restrict__ ok,
                                                          int* __restrict__ sidx) {
  extern __shared__ __align__(16) unsigned char shm[];
  const int q = blockIdx.y;
  int e0, e1;
  block_entries(tb, q, e0, e1);
  if (e0 >= e1) return;
  const int d2 = tb.d2, d3 = tb.d3, l3 = tb.l3;
  const float* R = tb.R + q * 9;
  float* xr = reinterpret_cast<float*>(shm);
  xr_table(R, tb.x0, d2, xr);
  __syncthreads();
  const float h3 = (float)(d3 / 2), hl = (float)(l3 / 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int w0, w1;
  warp_run(e0, e1, warp, GWARPS, w0, w1);
  for (int e = w0; e < w1; ++e) {
    const RayCoords rc = ray_coords(ray_of(tb, q, tb.ridx[e]), R);
    int* row = sidx + ((size_t)q * tb.n_max + (e - tb.rptr[q])) * d2;
    for (int kk = lane; kk < d2; kk += 32) {
      float X, Y, Z;
      sample_at(rc, xr, d2, kk, h3, hl, X, Y, Z);
      row[kk] = nn_index(X, Y, Z, d3, l3, ok);
    }
  }
}

// K2's second pass: out (k, vol) = double(sum of candidate q's partials) /
// scale. A block takes 32 voxels (a lane each) and its 32 warps the
// partials in turn; with a list only the blocks that held entries wrote
// theirs.
constexpr int RV = 32;  // voxels a block of the reduce

__global__ void __launch_bounds__(GT) reduce_kernel(Tables tb, const unsigned long long* part,
                                                    int per, const unsigned* __restrict__ bmax,
                                                    int nbmax, double n_terms,
                                                    float* __restrict__ out, int vol) {
  __shared__ unsigned long long red[GWARPS][RV];
  const int q = blockIdx.y;
  const double sc = block_scale(bmax + q * nbmax, nbmax, n_terms);
  int nb = per;
  if (tb.rptr) nb = min(per, (tb.rptr[q + 1] - tb.rptr[q] + tb.rpb - 1) / tb.rpb);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v = blockIdx.x * RV + lane;
  unsigned long long s = 0;
  if (v < vol)
    for (int b = warp; b < nb; b += GWARPS) s += __ldcs(part + ((size_t)q * per + b) * vol + v);
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || v >= vol) return;
  for (int w = 1; w < GWARPS; ++w) s += red[w][lane];
  out[(size_t)q * vol + v] = __double2float_rn(__ll2double_rn((long long)s) / sc);
}

// K3: per candidate, out (k, 13) float64 = [J^T J (3 x 3, row-major), J^T r
// (3), r^T r] of the linear residual r = P(x) - b over the listed rays
// (the pose's live rays, K1's row validity: the rays the residual counts),
// J its derivative by (tilt, psi, dy). b (l2, d2). Block (blk, q) takes the
// entries of candidate q's list that K1's would (block_entries), each of its
// warps a contiguous run of them, a ray at a time; the volume and the
// validity bytes are read through the cache. Each block's sums go to part
// (k, gridDim.x, 10) (an empty block's are zeros), and the candidate's last
// block adds them in a fixed order (lane l the blocks l, l + 32, ... in
// turn, then the lanes by shuffles), so the result does not depend on which
// block finishes first; it then sets done[q] back to 0 for the next launch
// (done must hold zeros at the first).
__global__ void __launch_bounds__(NT) pose_jacobian_kernel(Tables tb,
                                                           const float* __restrict__ x,
                                                           const uint8_t* __restrict__ ok,
                                                           const float* __restrict__ b,
                                                           double* part, unsigned* done,
                                                           double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char shm[];
  __shared__ double red[WARPS][10];
  __shared__ bool last;
  const int q = blockIdx.y;
  const int d2 = tb.d2, d3 = tb.d3, l3 = tb.l3;
  const float* xs = x + (size_t)q * l3 * d3 * d3;
  const float* R = tb.R + q * 9;
  const float* Dt = tb.dR + q * 18;
  const float* Dp = Dt + 9;
  float* xr = reinterpret_cast<float*>(shm);
  xr_table(R, tb.x0, d2, xr);
  __syncthreads();
  const float h3 = (float)(d3 / 2), hl = (float)(l3 / 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int off[8];
  corner_offsets(d3, off);
  // dy moves y0 by -1: its coordinate derivatives before the copy's turn
  const float dyx = -R[1], dyy = -R[4], dyz = -R[7];
  double s[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  int e0, e1, w0, w1;
  block_entries(tb, q, e0, e1);
  warp_run(e0, e1, warp, WARPS, w0, w1);
  for (int base = w0; base < w1; base += 32) {
    const int mine = base + lane < w1 ? tb.ridx[base + lane] : 0;
    const int n = min(32, w1 - base);
    for (int jj = 0; jj < n; ++jj) {
      const Ray rr = ray_of(tb, q, __shfl_sync(0xffffffffu, mine, jj));
      const RayCoords rc = ray_coords(rr, R);
      const float c = rr.c, sn = rr.s, y0 = rr.y0, z0 = rr.z0;
      const float dXd = dyx * c + dyy * sn, dYd = dyy * c - dyx * sn;
      float v = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f;
      bool any = false;
      for (int kk = lane; kk < d2; kk += 32) {
        float X, Y, Z, wz, wy, wx;
        sample_at(rc, xr, d2, kk, h3, hl, X, Y, Z);
        const int cb = cell(X, Y, Z, d3, l3, ok, wz, wy, wx);
        if (cb < 0) continue;
        any = true;
        const float x0 = tb.x0[kk];
        float w[8], a[8];
        tri_weights(wz, wy, wx, w);
#pragma unroll
        for (int m = 0; m < 8; ++m) a[m] = __ldg(xs + cb + off[m]);
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
  const int nb = gridDim.x;
  if (threadIdx.x < 10) {
    double t = 0;
    for (int w = 0; w < WARPS; ++w) t += red[w][threadIdx.x];
    part[((size_t)q * nb + blockIdx.x) * 10 + threadIdx.x] = t;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + q, 1u) == (unsigned)nb - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // sum m's places in out's row: J^T J's six into both of theirs in the
  // 3 x 3 matrix, then J^T r and r^T r
  constexpr int at[10] = {0, 1, 2, 4, 5, 8, 9, 10, 11, 12};
  constexpr int twin[10] = {0, 3, 6, 4, 7, 8, 9, 10, 11, 12};
  for (int m = warp; m < 10; m += WARPS) {
    double t = 0;
    for (int blk = lane; blk < nb; blk += 32) t += __ldcg(part + ((size_t)q * nb + blk) * 10 + m);
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
    if (lane == 0) out[q * 13 + at[m]] = out[q * 13 + twin[m]] = t;
  }
  if (threadIdx.x == 0) done[q] = 0;
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

// Op (c, s, dz)'s sample of the voxel (xc, yc, zc) (centred coordinates),
// in the plain version's order: X = (xc c - yc s) + d3//2, Y = (xc s + yc c)
// + d3//2, Z = (zc + dz) + l3//2. Returns its flat voxel (nn) or its cell's
// base corner with the eight weights in w (linear), -1 where it is not
// valid.
template <bool LINEAR>
__device__ __forceinline__ int sym_tap(float xc, float yc, float zc, float c, float s, float dz,
                                       float h3, float hl, int d3, int l3, const uint8_t* ok,
                                       float w[8]) {
  const float X = __fadd_rn(__fsub_rn(__fmul_rn(xc, c), __fmul_rn(yc, s)), h3);
  const float Y = __fadd_rn(__fadd_rn(__fmul_rn(xc, s), __fmul_rn(yc, c)), h3);
  const float Z = __fadd_rn(__fadd_rn(zc, dz), hl);
  if (!LINEAR) return nn_index(X, Y, Z, d3, l3, ok);
  float wz, wy, wx;
  const int base = cell(X, Y, Z, d3, l3, ok, wz, wy, wx);
  if (base >= 0) tri_weights(wz, wy, wx, w);
  return base;
}

// K4's items: (candidate q, pair slot p, voxel v) with v in the mask, the
// slot populated, keep set and both ops' samples valid: the rows of S that
// can be nonzero. Item it = p * vol + v of candidate q: its two samples (t1,
// t2; linear's weights w1, w2), or false where it is not an item.
template <bool LINEAR>
__device__ __forceinline__ bool sym_item(const SymTables& st, const uint8_t* ok, int q, long it,
                                         int& t1, int& t2, float w1[8], float w2[8]) {
  const int d3 = st.d3, l3 = st.l3, vol = l3 * d3 * d3;
  const int p = (int)(it / vol), v = (int)(it % vol);
  const int qp = q * st.P + p;
  if (st.pv[qp] == 0.f || !st.inmask[v] || (st.keep && !st.keep[(size_t)qp * vol + v]))
    return false;
  const float zc = (float)(v / (d3 * d3) - l3 / 2), yc = (float)((v / d3) % d3 - d3 / 2);
  const float xc = (float)(v % d3 - d3 / 2);
  const float h3 = (float)(d3 / 2), hl = (float)(l3 / 2);
  t1 = sym_tap<LINEAR>(xc, yc, zc, st.cs[2 * qp], st.sn[2 * qp], st.dz[2 * qp], h3, hl, d3, l3,
                       ok, w1);
  if (t1 < 0) return false;
  t2 = sym_tap<LINEAR>(xc, yc, zc, st.cs[2 * qp + 1], st.sn[2 * qp + 1], st.dz[2 * qp + 1], h3,
                       hl, d3, l3, ok, w2);
  return t2 >= 0;
}

// The item list's first pass: flag (k, P, vol) bytes, 1 at the items.
template <bool LINEAR>
__global__ void __launch_bounds__(NT) sym_flags_kernel(SymTables st, const uint8_t* __restrict__ ok,
                                                       uint8_t* __restrict__ flag) {
  const int q = blockIdx.y;
  const long n = (long)st.P * st.l3 * st.d3 * st.d3;
  float w1[8], w2[8];
  for (long it = (long)blockIdx.x * NT + threadIdx.x; it < n; it += (long)gridDim.x * NT) {
    int t1, t2;
    flag[(size_t)q * n + it] = sym_item<LINEAR>(st, ok, q, it, t1, t2, w1, w2) ? 1 : 0;
  }
}

// Its second pass: for each of the n_items items, ids (int64) its flat (q,
// p, v), in order: itap (n_items, 2) its two samples and, linear, iw
// (n_items, 2, 8) their weights.
template <bool LINEAR>
__global__ void __launch_bounds__(NT) sym_items_kernel(SymTables st, const uint8_t* __restrict__ ok,
                                                       const long long* __restrict__ ids,
                                                       int n_items, int* __restrict__ itap,
                                                       float* __restrict__ iw) {
  const long per = (long)st.P * st.l3 * st.d3 * st.d3;
  for (int e = blockIdx.x * NT + threadIdx.x; e < n_items; e += gridDim.x * NT) {
    const long id = ids[e];
    int t1 = -1, t2 = -1;
    float w1[8], w2[8];
    sym_item<LINEAR>(st, ok, (int)(id / per), id % per, t1, t2, w1, w2);
    itap[2 * e] = t1;
    itap[2 * e + 1] = t2;
    if (LINEAR) {
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        iw[16 * (size_t)e + a] = w1[a];
        iw[16 * (size_t)e + 8 + a] = w2[a];
      }
    }
  }
}

// A sample's value: x at the voxel (nn), or the cell's eight corners
// weighted, in the plain version's order (linear; w its weights).
template <bool LINEAR>
__device__ __forceinline__ float sym_value(const float* xq, int t, const float* w, const int* off) {
  if (!LINEAR) return __ldg(xq + t);
  const float4 wa = __ldg(reinterpret_cast<const float4*>(w));
  const float4 wb = __ldg(reinterpret_cast<const float4*>(w) + 1);
  const float ws[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
  float val = __fmul_rn(ws[0], __ldg(xq + t));
#pragma unroll
  for (int a = 1; a < 8; ++a) val = __fadd_rn(val, __fmul_rn(ws[a], __ldg(xq + t + off[a])));
  return val;
}

// K4's first kernel: for candidate q's items iptr[q] .. iptr[q + 1] each
// row of S, s = x(g1 v) - x(g2 v), into s (n_items); and each block's max
// |x| over its share of the volume into bmax (k, gridDim.x), which the
// scale of the sums needs.
template <bool LINEAR>
__global__ void __launch_bounds__(NT) sym_diff_kernel(const float* __restrict__ x,
                                                      const int* __restrict__ iptr,
                                                      const int* __restrict__ itap,
                                                      const float* __restrict__ iw, int d3,
                                                      int vol, float* __restrict__ s,
                                                      unsigned* __restrict__ bmax) {
  const int q = blockIdx.y;
  const float* xq = x + (size_t)q * vol;
  const int t0 = blockIdx.x * NT + threadIdx.x, stride = gridDim.x * NT;
  unsigned m = 0;
  for (int v = t0; v < vol; v += stride) m = max(m, __float_as_uint(fabsf(__ldg(xq + v))));
  int off[8];
  corner_offsets(d3, off);
  const int end = iptr[q + 1];
  for (int e = iptr[q] + t0; e < end; e += stride) {
    const int2 t = __ldg(reinterpret_cast<const int2*>(itap) + e);
    const float a1 = sym_value<LINEAR>(xq, t.x, iw + 16 * (size_t)e, off);
    const float a2 = sym_value<LINEAR>(xq, t.y, iw + 16 * (size_t)e + 8, off);
    s[e] = __fsub_rn(a1, a2);
  }
  block_max(m, bmax + q * gridDim.x + blockIdx.x);
}

// K4's second kernel: out (k, vol), each output voxel o = (q, v) the exact
// sum of its incidences cptr[o] .. cptr[o + 1] (an item e that samples v,
// the tap's signed weight w: +w at the first op's sample, -w at the
// second's, nn's w 1), each the integer fixed(w * s[e]) at the scale of
// n_terms terms of at most the max of bmax (k, nb) each. `lanes` lanes (a
// power of two, up to 32) share a voxel, each taking every lanes-th
// incidence, and meet by shuffles. Every voxel is written: no zeroing.
__global__ void __launch_bounds__(NT) sym_sums_kernel(const int* __restrict__ cptr,
                                                      const int* __restrict__ cinc,
                                                      const float* __restrict__ cw,
                                                      const float* __restrict__ s,
                                                      const unsigned* __restrict__ bmax, int nb,
                                                      double n_terms, float* __restrict__ out,
                                                      int vol, int lanes) {
  const int q = blockIdx.y;
  const double sc = block_scale(bmax + q * nb, nb, n_terms);
  const int t = blockIdx.x * NT + threadIdx.x;
  const int v = t / lanes, sub = t & (lanes - 1);
  const size_t o = (size_t)q * vol + v;
  unsigned long long acc = 0;
  if (v < vol) {
    const int end = cptr[o + 1];
    for (int i = cptr[o] + sub; i < end; i += lanes)
      acc += fixed(__fmul_rn(__ldg(cw + i), __ldg(s + __ldg(cinc + i))), sc);
  }
  for (int w = lanes / 2; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (v < vol && sub == 0) out[o] = __double2float_rn(__ll2double_rn((long long)acc) / sc);
}

__global__ void empty_kernel() {}

// the cards a process may hold; the per-card caches below are indexed by
// cudaGetDevice (a launch runs with its tensors' card current)
constexpr int MAX_CARDS = 64;

int current_card() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev < 0 || dev >= MAX_CARDS ? 0 : dev;
}

int sm_count() {
  static int n[MAX_CARDS];
  const int dev = current_card();
  if (n[dev] == 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    n[dev] = v > 0 ? v : 132;
  }
  return n[dev];
}

// K2's shared memory: `fixed` bytes always (the xr table) and vol_bytes
// more when they fit in smem_limit (staged set: the private volume's
// branch), the kernel's limit raised to match on the current card.
size_t gather_smem(const void* fn, size_t fixed, size_t vol_bytes, int smem_limit, bool& staged) {
  staged = (long)vol_bytes <= (long)smem_limit;
  const size_t need = fixed + (staged ? vol_bytes : 0);
  // the limits already raised, by card and kernel (K2's two), so that a
  // call costs the host no attribute call; threads driving several cards
  // share the table under a lock
  static std::mutex lock;
  static const void* fns[MAX_CARDS][4];
  static size_t raised[MAX_CARDS][4];
  static int n[MAX_CARDS];
  const int dev = current_card();
  std::lock_guard<std::mutex> guard(lock);
  int i = 0;
  while (i < n[dev] && fns[dev][i] != fn) ++i;
  if (i == n[dev] && n[dev] < 4) fns[dev][n[dev]++] = fn;
  if (i < 4 && raised[dev][i] >= need) return need;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
  if (i < 4) raised[dev][i] = need;
  return need;
}

Tables tables(const float* R, const float* dR, const float* cs, const float* sn, const float* dz,
              const float* cv, const float* x0, const float* y0, const float* z0, int k, int C,
              int l2, int d2, int d3, int l3) {
  return Tables{R, dR, cs, sn, dz, cv, x0, y0, z0, k, C, l2, d2, d3, l3, nullptr, nullptr, 0, 0,
                nullptr};
}

// K1 / K2 tables on the list (rptr, ridx; null: every ray tested), rpb
// entries a block, n_max the longest candidate's entries, and the list's
// sample table (sidx; null: computed).
Tables gather_tables(const float* R, const float* cs, const float* sn, const float* dz,
                     const float* cv, const float* x0, const float* y0, const float* z0,
                     const int* rptr, const int* ridx, const int* sidx, int k, int C, int l2,
                     int d2, int d3, int l3, int rpb, int n_max) {
  Tables tb = tables(R, nullptr, cs, sn, dz, cv, x0, y0, z0, k, C, l2, d2, d3, l3);
  tb.rptr = rptr;
  tb.ridx = ridx;
  tb.rpb = rpb;
  tb.n_max = n_max;
  tb.sidx = rptr ? sidx : nullptr;
  return tb;
}

// K1's kernel; its shared memory holds the xr table alone.
template <bool LINEAR>
void launch_project(const Tables& tb, int per, const float* x, const uint8_t* ok, float* pred,
                    uint8_t* rowv, const float* rows, float* comp, unsigned* bmax,
                    cudaStream_t st) {
  project_kernel<LINEAR><<<dim3((unsigned)per, (unsigned)tb.k), GT, 12 * (size_t)tb.d2, st>>>(
      tb, x, ok, pred, rowv, rows, comp, bmax);
}

// K2's sums (from r, or from comp on a list) into part, then the reduce
// into out, at the scale of the max of bmax (k, nbmax).
template <bool LINEAR>
void launch_backproject(const Tables& tb, int per, const float* r, const float* comp,
                        const uint8_t* ok_g, const unsigned* bmax, int nbmax,
                        unsigned long long* part, float* out, int smem_limit, int steps,
                        cudaStream_t st) {
  const int vol = tb.l3 * tb.d3 * tb.d3;
  // a sample's weights sum to 1: at most max |value| a sample
  const double n_terms = (double)tb.C * tb.l2 * tb.d2 * tb.d2;
  if (steps & 2) {
    bool staged;
    const size_t sm = gather_smem((const void*)backproject_kernel<LINEAR>, 12 * (size_t)tb.d2,
                                  (size_t)vol * 9, smem_limit, staged);
    backproject_kernel<LINEAR><<<dim3((unsigned)per, (unsigned)tb.k), GT, sm, st>>>(
        tb, r, comp, ok_g, bmax, nbmax, n_terms, part, staged);
  }
  if (steps & 4)
    reduce_kernel<<<dim3((unsigned)((vol + RV - 1) / RV), (unsigned)tb.k), GT, 0, st>>>(
        tb, part, per, bmax, nbmax, n_terms, out, vol);
}

}  // namespace

extern "C" {

// K1. ok (vol bytes): the validity bytes (aux > 0.5). x, pred, rowv may be
// null. rptr (k + 1) / ridx: the list of live rays, or null (every ray
// tested); n_max its longest candidate's entries, rpb the entries a block,
// sidx its sample table or null. per blocks a candidate. steps: 1 zero
// pred (with the list: the kernel writes the listed rays alone), 2 the
// kernel.
int hgp_project(const float* x, const uint8_t* ok, const float* R, const float* cs,
                const float* sn, const float* dz, const float* cv, const float* x0,
                const float* y0, const float* z0, const int* rptr, const int* ridx,
                const int* sidx, float* pred, uint8_t* rowv, int k, int C, int l2, int d2, int d3,
                int l3, int linear, int n_max, int per, int rpb, int steps, cudaStream_t st) {
  const Tables tb = gather_tables(R, cs, sn, dz, cv, x0, y0, z0, rptr, ridx, sidx, k, C, l2, d2,
                                  d3, l3, rpb, n_max);
  if ((steps & 1) && rptr && pred) cudaMemsetAsync(pred, 0, sizeof(float) * k * C * l2 * d2, st);
  if (steps & 2) {
    if (linear)
      launch_project<true>(tb, per, x, ok, pred, rowv, nullptr, nullptr, nullptr, st);
    else
      launch_project<false>(tb, per, x, ok, pred, rowv, nullptr, nullptr, nullptr, st);
  }
  return (int)cudaGetLastError();
}

// K2: out (k, vol) = PT(r), r (k, C, l2, d2). The list, sidx and per /
// rpb as K1's; nbmax the max pass's blocks a candidate. Scratch: bmax (k,
// nbmax) uint32, part (k, per, vol) int64. steps: 1 the max pass over r, 2
// the sums, 4 the reduce.
int hgp_backproject(const float* r, const uint8_t* ok, const float* R, const float* cs,
                    const float* sn, const float* dz, const float* cv, const float* x0,
                    const float* y0, const float* z0, const int* rptr, const int* ridx,
                    const int* sidx, unsigned* bmax, unsigned long long* part, float* out, int k,
                    int C, int l2, int d2, int d3, int l3, int linear, int n_max, int per,
                    int rpb, int nbmax, int smem_limit, int steps, cudaStream_t st) {
  const Tables tb = gather_tables(R, cs, sn, dz, cv, x0, y0, z0, rptr, ridx, sidx, k, C, l2, d2,
                                  d3, l3, rpb, n_max);
  if (steps & 1)
    max_kernel<<<dim3((unsigned)nbmax, (unsigned)k), NT, 0, st>>>(r, (long)C * l2 * d2, bmax);
  if (linear)
    launch_backproject<true>(tb, per, r, nullptr, ok, bmax, nbmax, part, out, smem_limit, steps,
                             st);
  else
    launch_backproject<false>(tb, per, r, nullptr, ok, bmax, nbmax, part, out, smem_limit, steps,
                              st);
  return (int)cudaGetLastError();
}

// gather_normal: out (k, vol) = PT(rows * P(x)) on the list of live rays,
// x (k, vol), rows (k, C, l2, d2). Scratch: comp (k, n_max) float32, bmax
// (k, per) uint32, part (k, per, vol) int64; smem_limit the sums' (K2's).
// steps: 1 the projection into comp with the blocks' maxima, 2 the sums, 4
// the reduce.
int hgp_normal(const float* x, const uint8_t* ok, const float* R, const float* cs,
               const float* sn, const float* dz, const float* cv, const float* x0,
               const float* y0, const float* z0, const int* rptr, const int* ridx,
               const int* sidx, const float* rows, float* comp, unsigned* bmax,
               unsigned long long* part, float* out, int k, int C, int l2, int d2, int d3,
               int l3, int linear, int n_max, int per, int rpb, int smem_limit, int steps,
               cudaStream_t st) {
  const Tables tb = gather_tables(R, cs, sn, dz, cv, x0, y0, z0, rptr, ridx, sidx, k, C, l2, d2,
                                  d3, l3, rpb, n_max);
  if (linear) {
    if (steps & 1) launch_project<true>(tb, per, x, ok, nullptr, nullptr, rows, comp, bmax, st);
    launch_backproject<true>(tb, per, nullptr, comp, ok, bmax, per, part, out, smem_limit, steps,
                             st);
  } else {
    if (steps & 1) launch_project<false>(tb, per, x, ok, nullptr, nullptr, rows, comp, bmax, st);
    launch_backproject<false>(tb, per, nullptr, comp, ok, bmax, per, part, out, smem_limit,
                              steps, st);
  }
  return (int)cudaGetLastError();
}

// The sample table of an nn list (rptr, ridx), per / rpb as K1's: sidx (k,
// n_max, d2) int32.
int hgp_sample_table(const uint8_t* ok, const float* R, const float* cs, const float* sn,
                     const float* dz, const float* cv, const float* x0, const float* y0,
                     const float* z0, const int* rptr, const int* ridx, int* sidx, int k, int C,
                     int l2, int d2, int d3, int l3, int n_max, int per, int rpb,
                     cudaStream_t st) {
  const Tables tb = gather_tables(R, cs, sn, dz, cv, x0, y0, z0, rptr, ridx, nullptr, k, C, l2,
                                  d2, d3, l3, rpb, n_max);
  sample_table_kernel<<<dim3((unsigned)per, (unsigned)k), GT, 12 * (size_t)d2, st>>>(tb, ok,
                                                                                    sidx);
  return (int)cudaGetLastError();
}

// K3 on the list of live rays (rptr, ridx; n_max its longest candidate's
// entries, rpb the entries a block, per blocks a candidate). ok (vol
// bytes): the cell validity (cellok > 0.5). part (k, per, 10) float64
// scratch; done (k,) must hold zeros at the first launch and is left so;
// out (k, 13) float64.
int hgp_pose_jacobian(const float* x, const uint8_t* ok, const float* R, const float* dR,
                      const float* cs, const float* sn, const float* dz, const float* cv,
                      const float* x0, const float* y0, const float* z0, const int* rptr,
                      const int* ridx, const float* b, double* part, unsigned* done, double* out,
                      int k, int C, int l2, int d2, int d3, int l3, int n_max, int per, int rpb,
                      cudaStream_t st) {
  Tables tb = gather_tables(R, cs, sn, dz, cv, x0, y0, z0, rptr, ridx, nullptr, k, C, l2, d2, d3,
                            l3, rpb, n_max);
  tb.dR = dR;
  pose_jacobian_kernel<<<dim3((unsigned)per, (unsigned)k), NT, 12 * (size_t)d2, st>>>(
      tb, x, ok, b, part, done, out);
  return (int)cudaGetLastError();
}

// K4's item list, once per symmetry tables: with flag (k, P, vol) bytes,
// the first pass (flag 1 at the items); else the second, for the n_items
// items of ids (int64, their flat (q, p, v) in order): itap (n_items, 2)
// and, linear, iw (n_items, 2, 8). ok_g and inmask (vol bytes): the
// sampler's validity and the voxels in the mask; keep (k, P, vol) bytes or
// null.
int hgp_sym_items(const uint8_t* ok_g, const float* cs, const float* sn, const float* dz,
                  const float* pv, const uint8_t* keep, const uint8_t* inmask, uint8_t* flag,
                  const long long* ids, int* itap, float* iw, int k, int P, int d3, int l3,
                  int linear, int n_items, cudaStream_t stream) {
  const SymTables st{cs, sn, dz, pv, keep, inmask, k, P, d3, l3};
  if (flag) {
    const long n = (long)P * l3 * d3 * d3;
    long per = (4L * sm_count() + k - 1) / k;
    if (per > (n + NT - 1) / NT) per = (n + NT - 1) / NT;
    const dim3 grid((unsigned)(per < 1 ? 1 : per), (unsigned)k);
    if (linear)
      sym_flags_kernel<true><<<grid, NT, 0, stream>>>(st, ok_g, flag);
    else
      sym_flags_kernel<false><<<grid, NT, 0, stream>>>(st, ok_g, flag);
  } else if (n_items > 0) {
    const unsigned blocks = (unsigned)((n_items + NT - 1) / NT);
    if (linear)
      sym_items_kernel<true><<<blocks, NT, 0, stream>>>(st, ok_g, ids, n_items, itap, iw);
    else
      sym_items_kernel<false><<<blocks, NT, 0, stream>>>(st, ok_g, ids, n_items, itap, iw);
  }
  return (int)cudaGetLastError();
}

// K4: out (k, vol) = ST(S(x)) on the item list (iptr (k + 1), itap, iw as
// hgp_sym_items wrote them) and its incidences by output voxel (cptr (k *
// vol + 1), cinc, cw). Scratch: s (n_items) float32, bmax (k, nb) uint32.
// nb the first kernel's blocks a candidate, lanes the second's lanes a
// voxel. steps: 1 the differences and the max pass (sym_diff_kernel), 2 the
// sums.
int hgp_sym_normal(const float* x, const int* iptr, const int* itap, const float* iw,
                   const int* cptr, const int* cinc, const float* cw, float* s, unsigned* bmax,
                   float* out, int k, int P, int d3, int l3, int linear, int nb, int lanes,
                   int steps, cudaStream_t stream) {
  const int vol = l3 * d3 * d3;
  if (steps & 1) {
    const dim3 grid((unsigned)nb, (unsigned)k);
    if (linear)
      sym_diff_kernel<true><<<grid, NT, 0, stream>>>(x, iptr, itap, iw, d3, vol, s, bmax);
    else
      sym_diff_kernel<false><<<grid, NT, 0, stream>>>(x, iptr, itap, iw, d3, vol, s, bmax);
  }
  // a pair's row is at most 2 max |x|, added back at two samples
  if (steps & 2)
    sym_sums_kernel<<<dim3((unsigned)(((long)vol * lanes + NT - 1) / NT), (unsigned)k), NT, 0,
                      stream>>>(cptr, cinc, cw, s, bmax, nb, 4.0 * P * vol, out, vol, lanes);
  return (int)cudaGetLastError();
}

// An empty kernel: the floor of one launch through this library's C path.
int hgp_empty(cudaStream_t st) {
  empty_kernel<<<1, 32, 0, st>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
