// Electrokinetic kernels for Hopper (sm_90a), f32/f64.
//
// Replace the Pallas TPU kernels of ludwig_tpu/ops/fused_electro.py:
//   sor_kernel        <- _sor_kernel (fused_electro.py:63): the whole
//                        red/black Chebyshev SOR solve of
//                        eps del2_7pt psi = -rhs, in one launch
//   np_gradmu_kernel  <- _np_kernel (fused_electro.py:207): the raw grad-mu
//                        force and the d3q7 Nernst-Planck update of every
//                        species, one pass
// Their plain PyTorch twins are ops/fused_electro.py _sor_solve_plain and
// _np_plain, whose term order the kernels follow operation by operation
// (nvcc -fmad=false).
//
// sor_kernel.  The TPU kernel keeps the whole field in VMEM and loops in
// the kernel; one SM cannot hold a field (8 MB at 128^3 f32), so this is
// one persistent cooperative launch whose half-sweeps are separated by
// grid-wide barriers.  Three routes (ops/_cuda.py sor_layout picks one):
//   in-place (every extent even): every neighbour of a site, across the
//     wraps too, has the other colour, so a half-sweep updating one colour
//     in place reads exactly the pre-sweep field.  A thread owns pairs of
//     z-adjacent sites (2m, 2m + 1), one of each colour, and updates the
//     one of the sweep's colour: no warp divergence, no copies.  psi and
//     rhs are split by colour once a solve (sor_split), so a half-sweep
//     moves only its colour's values and the other colour's neighbours.
//   on-chip (every extent even, psi and rhs fit the SMs' shared memory):
//     the in-place sweep on a brick (bx, by, Z) of colour-split psi, with
//     a one-site halo in x and y, and of rhs, that each block keeps in
//     shared memory for the whole solve.  After a half-sweep a block writes
//     its boundary planes of the swept colour to that colour's face
//     buffer, and after the barrier reads its halo of that colour from the
//     neighbours' faces: only faces cross L2 between half-sweeps.
//   two-buffer (an odd extent: two sites of one colour meet across the
//     wrap): a half-sweep reads one buffer and writes every site of the
//     other, its colour updated, the rest copied, so the residual comes
//     from the pre-sweep field, as in the JAX package.
// Residual sums are per-block partials reduced by every block in one
// fixed order, so all blocks take the same stop decision; they are formed
// only at check iterations (n % 5 == 0) and at the last allowed one,
// where the solve can stop or report.  sum rhs^2 (rnorm0) is formed in
// the first pass over rhs (the colour split, the brick's load or the
// first half-sweep), and with zero_mean the sum of psi in the black
// half-sweep of every such iteration, so the mean of the stop iteration
// is known without another sweep.  Bound: the function reads psi and rhs
// and writes psi (12 B/site in f32 once; an in-place sweep streaming the
// fields moves 16 B/site an iteration) against ~16 operations a site an
// iteration: memory, and in practice the grid barriers and the latency of
// each half-sweep.

// np_gradmu_kernel.  Bound: memory in principle, psi, rho_k, u and the
// uint8 mask read once, rho'_k and the force written once (45 B/site in
// f32 with two species).  Each face flux costs an exp and an IEEE
// division; the first kernel, one thread a site, computed each face in
// both of its sites (12 exp and 12 divisions a site with two species)
// and four integer divisions a site for its coordinates, and issued
// about as many integer as f32 instructions.  The TPU kernel computed
// each x face once on an x-slab and each y and z face once a window.  So
// here a block owns a BY x 32 y-z tile (a warp along z, a thread a
// column) and marches along its x segment: psi, the nk species' rho, u
// (with hydrodynamics) and the mask are staged plane by plane with a y-z
// halo of 1, the next plane in flight by cp.async (csrc/k1_march.cuh's
// helpers); each face is computed once, the +x face carried in a
// register to the next plane, the +y faces of the tile and of the halo
// row below it kept in shared memory, the +z faces passed to the next
// lane by warp shuffle (the halo column's for lane 0 in shared memory):
// (BX+1)/BX + (BY+1)/BY + 33/32 evaluations a site and species against
// 6.  The arithmetic and its order are the first kernel's, the face's low
// site first and div summed x, y, z, so rho' and the force are bitwise
// its results.  Per-block partial sums of the force go to a second
// one-block launch (reduce_partials_kernel) in a fixed order: fsum is
// deterministic for a layout.  No output double buffer: the DMA race of
// the TPU kernel (ADVICE.md:3) has no counterpart.  What holds the march
// on an H100 is its instruction stream: an exp and an IEEE division a
// face (PERF.md).  The tile, segment and threads come from ops/_cuda.py
// np_layout, which the launch checks; tests/test_torch_np_march.py holds
// a torch march of the same buffers bitwise the twin on the CPU,
// chip_smoke.py phases 16 and 18 hold and time the kernel on the card.
//
// Site indices are int32 (the wrappers refuse X*Y*Z, and in
// np_gradmu_kernel max(nk, 3) * X*Y*Z, beyond 2^31 - 1); the grid-stride
// loops count in 64 bits so that the last stride cannot overflow.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "k1_march.cuh"
#include "reduce.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = kReduceThreads;
constexpr int kMaxSpecies = 8;
constexpr int kErrNoCooperativeLaunch = -1;

// i in [-n, 2n): one conditional add or subtract
__device__ __forceinline__ int wrap1(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// -- SOR ---------------------------------------------------------------------

constexpr int kSorTwoBuffer = 0, kSorInPlace = 1, kSorOnChip = 2;
constexpr int kSorChipThreads = 512;  // threads a block, on-chip route

#define SOR_THREADS(ROUTE) ((ROUTE) == kSorOnChip ? kSorChipThreads : kThreads)

// two adjacent values (a pair of z-adjacent sites) as one 8- or 16-byte
// access
template <typename T>
struct SorVec2;
template <>
struct SorVec2<float> {
  using type = float2;
};
template <>
struct SorVec2<double> {
  using type = double2;
};

template <typename T>
struct SorParams {
  T eps, denom, rel_tol, abs_tol, stall_frac;
  int X, Y, Z, max_its, ntab, zero_mean, stall;
  int bx, by;  // the on-chip route's brick: x and y extents (z whole)
};

// The update of the site with value p: res = eps (x- + x+ + y- + y+ + z-
// + z+ - 6 p) + r, the neighbours summed in the twin's order; returns
// p + omega res / denom and sets res.
template <typename T>
__device__ __forceinline__ T sor_update(T p, T xm, T xp, T ym, T yp, T zm,
                                        T zp, T r, T omega,
                                        const SorParams<T>& sp, T& res) {
  T nb = xm + xp;
  nb = nb + ym + yp;
  nb = nb + zm + zp;
  res = sp.eps * (nb - T(6) * p) + r;
  return p + omega * res / sp.denom;
}

// Two-buffer half-sweep over this thread's sites s = first, first +
// stride, ...: sites of `colour` get the update from src, the others are
// copied.  Returns the thread's sum of res^2; r0 (when not null) adds
// rhs^2 of every site walked, sum the values written.  The coordinates
// advance by the stride's (dx, dy, dz) with carries, instead of four
// integer divisions a site.
template <typename T>
__device__ __forceinline__ T sor_half_copy(const T* src, T* dst,
                                           const T* __restrict__ rhs,
                                           int colour, T omega,
                                           const SorParams<T>& sp, int first,
                                           int stride, T* r0, T* sum) {
  const int X = sp.X, Y = sp.Y, Z = sp.Z, YZ = Y * Z, nsite = X * YZ;
  const int dz = stride % Z, dy = (stride / Z) % Y, dx = stride / YZ;
  int z = first % Z, y = (first / Z) % Y, x = first / YZ;
  T acc = T(0);
  for (int64_t s64 = first; s64 < nsite; s64 += stride) {
    const int s = static_cast<int>(s64);
    const T p = src[s];
    T v = p;
    if (((x + y + z) & 1) == colour) {
      T res;
      v = sor_update(p, src[x == 0 ? s + (X - 1) * YZ : s - YZ],
                     src[x == X - 1 ? s - (X - 1) * YZ : s + YZ],
                     src[y == 0 ? s + (Y - 1) * Z : s - Z],
                     src[y == Y - 1 ? s - (Y - 1) * Z : s + Z],
                     src[z == 0 ? s + (Z - 1) : s - 1],
                     src[z == Z - 1 ? s - (Z - 1) : s + 1], rhs[s], omega,
                     sp, res);
      acc += res * res;
    }
    dst[s] = v;
    if (r0) *r0 += rhs[s] * rhs[s];
    if (sum) *sum += v;
    z += dz;
    const int cz = z >= Z;
    z -= cz * Z;
    y += dy + cz;
    const int cy = y >= Y;
    y -= cy * Y;
    x += dx + cy;
  }
  return acc;
}

// Coordinates (x, y, m) of a pair index t = (x Y + y) Zh + m, advanced
// by a fixed step with carries instead of integer divisions.
struct SorWalk {
  int x, y, m, dx, dy, dm;
  __device__ void init(int t, int step, int Y, int Zh) {
    m = t % Zh, y = (t / Zh) % Y, x = t / (Y * Zh);
    dm = step % Zh, dy = (step / Zh) % Y, dx = step / (Y * Zh);
  }
  __device__ void next(int Y, int Zh) {
    m += dm;
    const int cm = m >= Zh;
    m -= cm * Zh;
    y += dy + cm;
    const int cy = y >= Y;
    y -= cy * Y;
    x += dx + cy;
  }
};

// The in-place route keeps psi and rhs colour-split: cs holds two
// (X, Y, Z/2) arrays, colour 0 then colour 1, whose value t = (x Y + y)
// Zh + m is the site (x, y, 2m + ((x + y + c) & 1)) of colour c.  Every
// neighbour of a colour-c site has the other colour and sits at the same
// t in x and y (offset by a plane or a row), and at t or t -+ 1 in z, so a
// half-sweep reads and writes each colour's values contiguously.
//
// Split psi and rhs into cs and rs over this thread's pairs t = first,
// first + stride, ... of z-adjacent sites (2m, 2m + 1), each pair read as
// one vector; returns the thread's sum of rhs^2.
template <typename T>
__device__ T sor_split(const T* __restrict__ psi, const T* __restrict__ rhs,
                       T* __restrict__ cs, T* __restrict__ rs,
                       const SorParams<T>& sp, int first, int stride) {
  using V = typename SorVec2<T>::type;
  const int Y = sp.Y, Zh = sp.Z >> 1, npair = sp.X * Y * Zh;
  const V* pv = reinterpret_cast<const V*>(psi);
  const V* rv = reinterpret_cast<const V*>(rhs);
  SorWalk w;
  w.init(first, stride, Y, Zh);
  T r0 = T(0);
#pragma unroll 4
  for (int t = first; t < npair; t += stride) {
    const int c0 = (w.x + w.y) & 1;  // the colour of site 2m
    const V p = pv[t], r = rv[t];
    cs[c0 * npair + t] = p.x;
    cs[(1 - c0) * npair + t] = p.y;
    rs[c0 * npair + t] = r.x;
    rs[(1 - c0) * npair + t] = r.y;
    r0 += r.x * r.x;
    r0 += r.y * r.y;
    w.next(Y, Zh);
  }
  return r0;
}

// the result p0 <- cs, less `mean`, over this thread's pairs
template <typename T>
__device__ void sor_unsplit(T* __restrict__ p0, const T* __restrict__ cs,
                            T mean, const SorParams<T>& sp, int first,
                            int stride) {
  using V = typename SorVec2<T>::type;
  const int Y = sp.Y, Zh = sp.Z >> 1, npair = sp.X * Y * Zh;
  V* pv = reinterpret_cast<V*>(p0);
  SorWalk w;
  w.init(first, stride, Y, Zh);
#pragma unroll 4
  for (int t = first; t < npair; t += stride) {
    const int c0 = (w.x + w.y) & 1;
    V v;
    v.x = cs[c0 * npair + t] - mean;
    v.y = cs[(1 - c0) * npair + t] - mean;
    pv[t] = v;
    w.next(Y, Zh);
  }
}

constexpr int kSorUnroll = 2;  // pairs a thread has in flight

// In-place half-sweep (every extent even) of `colour` on the split cs,
// rs over this thread's pairs: each pair's site of this colour is
// updated; its partner, of the other colour, is read only as a z
// neighbour.  kSorUnroll pairs are loaded before any is stored (no site a
// pair updates is read by another), so their loads overlap.  sum (when
// not null) adds both sites' values after the update, site 2m first.
template <typename T>
__device__ __forceinline__ T sor_half_inplace(T* cs, const T* __restrict__ rs,
                                              int colour, T omega,
                                              const SorParams<T>& sp,
                                              int first, int stride,
                                              T* sum) {
  const int X = sp.X, Y = sp.Y, Zh = sp.Z >> 1, YZh = Y * Zh;
  const int npair = X * YZh;
  // the two colours are disjoint halves of cs: no store to own is seen
  // by a load from oth, so the loads of later pairs may run ahead
  T* __restrict__ own = cs + colour * npair;
  const T* __restrict__ oth = cs + (1 - colour) * npair;
  const T* __restrict__ rc = rs + colour * npair;
  SorWalk w[kSorUnroll];
#pragma unroll
  for (int u = 0; u < kSorUnroll; ++u) {
    w[u].init(first + u * stride, kSorUnroll * stride, Y, Zh);
  }
  T acc = T(0);
#pragma unroll 1
  for (int t0 = first; t0 < npair; t0 += kSorUnroll * stride) {
    T p[kSorUnroll], xm[kSorUnroll], xp[kSorUnroll], ym[kSorUnroll],
        yp[kSorUnroll], zm[kSorUnroll], zp[kSorUnroll], r[kSorUnroll];
    int o[kSorUnroll];
#pragma unroll
    for (int u = 0; u < kSorUnroll; ++u) {
      const int t = t0 + u * stride;
      if (t >= npair) break;
      const int x = w[u].x, y = w[u].y, m = w[u].m;
      o[u] = (x + y + colour) & 1;  // the pair's site of this colour
      p[u] = own[t];
      xm[u] = oth[x == 0 ? t + (X - 1) * YZh : t - YZh];
      xp[u] = oth[x == X - 1 ? t - (X - 1) * YZh : t + YZh];
      ym[u] = oth[y == 0 ? t + (Y - 1) * Zh : t - Zh];
      yp[u] = oth[y == Y - 1 ? t - (Y - 1) * Zh : t + Zh];
      zm[u] = oth[o[u] ? t : (m == 0 ? t + (Zh - 1) : t - 1)];
      zp[u] = oth[o[u] ? (m == Zh - 1 ? t - (Zh - 1) : t + 1) : t];
      r[u] = rc[t];
    }
#pragma unroll
    for (int u = 0; u < kSorUnroll; ++u) {
      const int t = t0 + u * stride;
      if (t >= npair) break;
      T res;
      const T pn = sor_update(p[u], xm[u], xp[u], ym[u], yp[u], zm[u], zp[u],
                              r[u], omega, sp, res);
      own[t] = pn;
      acc += res * res;
      if (sum) {  // the partner is z + 1 (o = 0) or z - 1 (o = 1)
        *sum += o[u] ? zm[u] : pn;
        *sum += o[u] ? pn : zp[u];
      }
      w[u].next(Y, Zh);
    }
  }
  return acc;
}

// The on-chip route's brick in shared memory, colour-split as the
// in-place route's fields: psi as two (bx + 2, by + 2, Z/2) arrays with a
// one-site halo in x and y (the corner columns unused), value (lx, ly, m)
// of colour c being the site (x0 + lx, y0 + ly, 2m + ((x0 + lx + y0 + ly
// + c) & 1)); then rhs as two (bx, by, Z/2) arrays.  A half-sweep of
// colour c changes only colour c, so only its boundary planes cross L2.
template <typename T>
struct SorBrick {
  T* psi;
  T* rhs;
  int bx, by, Zh, x0, y0, ix, iy, nbx, nby;
  __device__ int at(int lx, int ly, int m) const {  // lx, ly from -1
    return ((lx + 1) * (by + 2) + ly + 1) * Zh + m;
  }
  __device__ int colour_len() const { return (bx + 2) * (by + 2) * Zh; }
  __device__ int face_len() const { return 2 * (by + bx) * Zh; }
  __device__ int parity(int lx, int ly) const {
    return (x0 + lx + y0 + ly) & 1;
  }
};

// Row r of the boundary planes, in order x = 0, x = bx - 1 (by rows of
// Z/2 each), y = 0, y = by - 1 (bx rows each): its (lx, ly).  Value i of
// the faces is row i / (Z/2), m = i % (Z/2).
template <typename T>
__device__ __forceinline__ void sor_face_row(const SorBrick<T>& b, int r,
                                             int& lx, int& ly) {
  if (r < 2 * b.by) {
    lx = r < b.by ? 0 : b.bx - 1;
    ly = r < b.by ? r : r - b.by;
  } else {
    const int k = r - 2 * b.by;
    ly = k < b.bx ? 0 : b.by - 1;
    lx = k < b.bx ? k : k - b.bx;
  }
}

// this block's boundary planes of colour c -> faces
template <typename T>
__device__ void sor_put_faces(const SorBrick<T>& b, int c,
                              T* __restrict__ faces) {
  const int len = b.face_len(), rows = 2 * (b.bx + b.by);
  const T* ps = b.psi + c * b.colour_len();
  T* mine = faces + static_cast<int64_t>(blockIdx.x) * len;
  SorWalk w;  // (row, m) of value i
  w.init(threadIdx.x, blockDim.x, rows, b.Zh);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    int lx, ly;
    sor_face_row(b, w.y, lx, ly);
    mine[i] = ps[b.at(lx, ly, w.m)];
    w.next(rows, b.Zh);
  }
}

// the halo of colour c <- the neighbours' faces: x = -1 from the x-minus
// block's x = bx - 1 plane, x = bx from the x-plus block's x = 0 plane,
// likewise in y; kHaloBatch values loaded before any is stored
constexpr int kHaloBatch = 4;

template <typename T>
__device__ void sor_get_halo(const SorBrick<T>& b, int c,
                             const T* __restrict__ faces) {
  const int len = b.face_len(), rows = 2 * (b.bx + b.by);
  const int fx = b.by * b.Zh, fy = b.bx * b.Zh;
  const int xm = b.iy * b.nbx + (b.ix == 0 ? b.nbx - 1 : b.ix - 1);
  const int xp = b.iy * b.nbx + (b.ix == b.nbx - 1 ? 0 : b.ix + 1);
  const int ym = (b.iy == 0 ? b.nby - 1 : b.iy - 1) * b.nbx + b.ix;
  const int yp = (b.iy == b.nby - 1 ? 0 : b.iy + 1) * b.nbx + b.ix;
  T* ps = b.psi + c * b.colour_len();
  const int stride = blockDim.x;
  SorWalk w[kHaloBatch];
#pragma unroll
  for (int u = 0; u < kHaloBatch; ++u) {
    w[u].init(threadIdx.x + u * stride, kHaloBatch * stride, rows, b.Zh);
  }
  for (int i0 = threadIdx.x; i0 < len; i0 += kHaloBatch * stride) {
    T v[kHaloBatch];
    int at[kHaloBatch];
#pragma unroll
    for (int u = 0; u < kHaloBatch; ++u) {
      const int i = i0 + u * stride;
      if (i >= len) break;
      int lx, ly, nb, j;
      sor_face_row(b, w[u].y, lx, ly);
      if (i < fx) {  // the halo beyond x = 0
        nb = xm, j = i + fx, lx = -1;
      } else if (i < 2 * fx) {
        nb = xp, j = i - fx, lx = b.bx;
      } else if (i < 2 * fx + fy) {
        nb = ym, j = i + fy, ly = -1;
      } else {
        nb = yp, j = i - fy, ly = b.by;
      }
      at[u] = b.at(lx, ly, w[u].m);
      v[u] = faces[static_cast<int64_t>(nb) * len + j];
      w[u].next(rows, b.Zh);
    }
#pragma unroll
    for (int u = 0; u < kHaloBatch; ++u) {
      if (i0 + u * stride >= len) break;
      ps[at[u]] = v[u];
    }
  }
}

// the brick and its halo from the global fields, split by colour, each
// pair of sites read as one vector; returns this thread's sum of rhs^2
template <typename T>
__device__ T sor_load_brick(const SorBrick<T>& b, const T* __restrict__ psi,
                            const T* __restrict__ rhs,
                            const SorParams<T>& sp) {
  using V = typename SorVec2<T>::type;
  const V* pv = reinterpret_cast<const V*>(psi);
  const V* rv = reinterpret_cast<const V*>(rhs);
  const int Zh = b.Zh, rows = (b.bx + 2) * (b.by + 2), cl = b.colour_len();
  T* __restrict__ ps = b.psi;
  T* __restrict__ rsh = b.rhs;
  SorWalk w;  // (row, m) of a column pair of the padded brick
  w.init(threadIdx.x, blockDim.x, rows, Zh);
#pragma unroll 4
  for (int i = threadIdx.x; i < cl; i += blockDim.x) {
    const int lx = w.y / (b.by + 2) - 1, ly = w.y % (b.by + 2) - 1;
    const int gx = wrap1(b.x0 + lx, sp.X), gy = wrap1(b.y0 + ly, sp.Y);
    const V p = pv[(gx * sp.Y + gy) * Zh + w.m];
    const int c0 = b.parity(lx, ly);  // the colour of site 2m
    ps[c0 * cl + i] = p.x;
    ps[(1 - c0) * cl + i] = p.y;
    w.next(rows, Zh);
  }
  T r0 = T(0);
  const int ri = b.bx * b.by * Zh;
  w.init(threadIdx.x, blockDim.x, b.by, Zh);
#pragma unroll 4
  for (int i = threadIdx.x; i < ri; i += blockDim.x) {
    const int lx = w.x, ly = w.y;
    const V r = rv[((b.x0 + lx) * sp.Y + b.y0 + ly) * Zh + w.m];
    const int c0 = b.parity(lx, ly);
    rsh[c0 * ri + i] = r.x;
    rsh[(1 - c0) * ri + i] = r.y;
    r0 += r.x * r.x;
    r0 += r.y * r.y;
    w.next(b.by, Zh);
  }
  return r0;
}

// the result p0 <- the brick's interior, less `mean`
template <typename T>
__device__ void sor_store_brick(const SorBrick<T>& b, T* __restrict__ p0,
                                T mean, const SorParams<T>& sp) {
  using V = typename SorVec2<T>::type;
  V* pv = reinterpret_cast<V*>(p0);
  const int Zh = b.Zh, cl = b.colour_len(), ri = b.bx * b.by * Zh;
  SorWalk w;
  w.init(threadIdx.x, blockDim.x, b.by, Zh);
#pragma unroll 4
  for (int i = threadIdx.x; i < ri; i += blockDim.x) {
    const int lx = w.x, ly = w.y, c0 = b.parity(lx, ly);
    const int k = b.at(lx, ly, w.m);
    V v;
    v.x = b.psi[c0 * cl + k] - mean;
    v.y = b.psi[(1 - c0) * cl + k] - mean;
    pv[((b.x0 + lx) * sp.Y + b.y0 + ly) * Zh + w.m] = v;
    w.next(b.by, Zh);
  }
}

// On-chip half-sweep of `colour` over the brick's pairs, as
// sor_half_inplace on the brick's split psi and rhs, the pair index t =
// (lx by + ly) Zh + m walked with carries; returns the thread's sum of
// res^2.
template <typename T>
__device__ __forceinline__ T sor_half_chip(const SorBrick<T>& b, int colour,
                                           T omega, const SorParams<T>& sp,
                                           T* sum) {
  const int Zh = b.Zh, PX = (b.by + 2) * Zh, cl = b.colour_len();
  const int npair = b.bx * b.by * Zh;
  T* __restrict__ own = b.psi + colour * cl;
  const T* __restrict__ oth = b.psi + (1 - colour) * cl;
  const T* __restrict__ rc = b.rhs + colour * npair;
  const int stride = blockDim.x;
  SorWalk w[kSorUnroll];
#pragma unroll
  for (int u = 0; u < kSorUnroll; ++u) {
    w[u].init(threadIdx.x + u * stride, kSorUnroll * stride, b.by, Zh);
  }
  T acc = T(0);
  for (int t0 = threadIdx.x; t0 < npair; t0 += kSorUnroll * stride) {
    T p[kSorUnroll], xm[kSorUnroll], xp[kSorUnroll], ym[kSorUnroll],
        yp[kSorUnroll], zm[kSorUnroll], zp[kSorUnroll], r[kSorUnroll];
    int c[kSorUnroll], o[kSorUnroll];
#pragma unroll
    for (int u = 0; u < kSorUnroll; ++u) {
      const int t = t0 + u * stride;
      if (t >= npair) break;
      const int lx = w[u].x, ly = w[u].y, m = w[u].m;
      o[u] = (b.parity(lx, ly) + colour) & 1;
      const int cc = b.at(lx, ly, m);
      c[u] = cc;
      p[u] = own[cc];
      xm[u] = oth[cc - PX];
      xp[u] = oth[cc + PX];
      ym[u] = oth[cc - Zh];
      yp[u] = oth[cc + Zh];
      zm[u] = oth[o[u] ? cc : (m == 0 ? cc + (Zh - 1) : cc - 1)];
      zp[u] = oth[o[u] ? (m == Zh - 1 ? cc - (Zh - 1) : cc + 1) : cc];
      r[u] = rc[t];
    }
#pragma unroll
    for (int u = 0; u < kSorUnroll; ++u) {
      if (t0 + u * stride >= npair) break;
      T res;
      const T pn = sor_update(p[u], xm[u], xp[u], ym[u], yp[u], zm[u], zp[u],
                              r[u], omega, sp, res);
      own[c[u]] = pn;
      acc += res * res;
      if (sum) {
        *sum += o[u] ? zm[u] : pn;
        *sum += o[u] ? pn : zp[u];
      }
      w[u].next(b.by, Zh);
    }
  }
  return acc;
}

// part: 7 x gridDim.x partials: red, black (even iterations), red, black
// (odd ones), the psi sums (even, odd), sum rhs^2.  Iteration n + 1
// writes the other set while slow blocks may still read iteration n's;
// n + 2 may reuse it, as every block has passed iteration n + 1's first
// barrier by then.  faces (on-chip route): one buffer per colour of
// gridDim.x x face_len values.  The on-chip and in-place routes read psi
// once; the two-buffer route starts from p0, a copy of it.  The result
// is in p0, istats = (n, which), rstats = (rnorm).
// The streaming routes run four blocks an SM (<= 64 registers a thread).
template <typename T, int ROUTE>
__global__ void __launch_bounds__(SOR_THREADS(ROUTE),
                                  ROUTE == kSorOnChip ? 1 : 4)
sor_kernel(const T* __restrict__ psi, T* p0, T* p1,
           const T* __restrict__ rhs, const T* __restrict__ om_tab, T* part,
           T* faces, int* istats, T* rstats, SorParams<T> sp) {
  constexpr int NT = SOR_THREADS(ROUTE);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  __shared__ T sh[NT / 32 + 1];
  const int G = gridDim.x;
  const int nsite = sp.X * sp.Y * sp.Z;
  const int stride = G * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  T* part_r0 = part + 6 * G;

  SorBrick<T> b{};
  T r0 = T(0);
  if constexpr (ROUTE == kSorOnChip) {
    b.bx = sp.bx;
    b.by = sp.by;
    b.Zh = sp.Z >> 1;
    b.nbx = sp.X / sp.bx;
    b.nby = sp.Y / sp.by;
    b.ix = blockIdx.x % b.nbx;
    b.iy = blockIdx.x / b.nbx;
    b.x0 = b.ix * b.bx;
    b.y0 = b.iy * b.by;
    b.psi = reinterpret_cast<T*>(smem_raw);
    b.rhs = b.psi + 2 * b.colour_len();
    r0 = sor_load_brick(b, psi, rhs, sp);
    __syncthreads();
  }
  T* faces_of[2] = {faces, faces + static_cast<int64_t>(G) * b.face_len()};
  // the in-place route's colour-split psi and rhs (p1: 2 nsite values)
  T* cs = p1;
  T* rs = p1 + nsite;
  if constexpr (ROUTE == kSorInPlace) {
    r0 = sor_split(psi, rhs, cs, rs, sp, first, stride);
    grid.sync();
  }

  auto half = [&](int colour, T omega, T* r0p, T* sum) -> T {
    if constexpr (ROUTE == kSorOnChip) {
      return sor_half_chip(b, colour, omega, sp, sum);
    } else if constexpr (ROUTE == kSorInPlace) {
      return sor_half_inplace(cs, rs, colour, omega, sp, first, stride, sum);
    } else {
      return colour == 0
                 ? sor_half_copy(p0, p1, rhs, 0, omega, sp, first, stride,
                                 r0p, sum)
                 : sor_half_copy(p1, p0, rhs, 1, omega, sp, first, stride,
                                 r0p, sum);
    }
  };

  // prev is set at n = 0 before any use, rn at the last iteration run
  T prev = T(0), rn = T(0), rnorm0 = T(0);
  int nstop = sp.max_its - 1, which = 1;
  for (int n = 0; n < sp.max_its; ++n) {
    const int nt = n < sp.ntab ? n : sp.ntab - 1;
    T* part_red = part + (n & 1) * 2 * G;
    T* part_blk = part_red + G;
    T* part_sum = part + (4 + (n & 1)) * G;
    const bool is_check = n % 5 == 0;
    const bool reduce = is_check || n == sp.max_its - 1;
    T a = half(0, om_tab[2 * nt],
               ROUTE == kSorTwoBuffer && n == 0 ? &r0 : nullptr, nullptr);
    if (reduce) {
      a = block_sum_all<T, NT>(a, sh);
      if (threadIdx.x == 0) part_red[blockIdx.x] = a;
    }
    if (n == 0) {
      r0 = block_sum_all<T, NT>(r0, sh);
      if (threadIdx.x == 0) part_r0[blockIdx.x] = r0;
    }
    if constexpr (ROUTE == kSorOnChip) {
      __syncthreads();
      sor_put_faces(b, 0, faces_of[0]);
    }
    grid.sync();
    if constexpr (ROUTE == kSorOnChip) {
      sor_get_halo(b, 0, faces_of[0]);
      __syncthreads();
    }
    T psum = T(0);
    T c = half(1, om_tab[2 * nt + 1], nullptr,
               reduce && sp.zero_mean ? &psum : nullptr);
    if (reduce) {
      c = block_sum_all<T, NT>(c, sh);
      if (threadIdx.x == 0) part_blk[blockIdx.x] = c;
      if (sp.zero_mean) {
        psum = block_sum_all<T, NT>(psum, sh);
        if (threadIdx.x == 0) part_sum[blockIdx.x] = psum;
      }
    }
    if constexpr (ROUTE == kSorOnChip) {
      __syncthreads();
      sor_put_faces(b, 1, faces_of[1]);
    }
    grid.sync();
    bool stop = false;
    if (reduce) {
      if (n == 0) rnorm0 = sqrt(sum_partials<T, NT>(part_r0, G, sh));
      // the same partials in the same order in every block: one decision
      const T s_red = sum_partials<T, NT>(part_red, G, sh);
      const T s_blk = sum_partials<T, NT>(part_blk, G, sh);
      const T rnorm1 = sqrt(s_red + s_blk);
      rn = rnorm1;
      which = rnorm1 < sp.abs_tol ? 0 : 1;
      if (is_check) {
        bool conv = rnorm1 < sp.abs_tol || rnorm1 < sp.rel_tol * rnorm0;
        if (sp.stall && n > 0) conv = conv || rnorm1 >= sp.stall_frac * prev;
        prev = rnorm1;
        if (conv) {
          nstop = n;
          stop = true;
        }
      }
    }
    if (stop) break;
    if constexpr (ROUTE == kSorOnChip) {
      if (n + 1 < sp.max_its) {
        sor_get_halo(b, 1, faces_of[1]);
        __syncthreads();
      }
    }
  }

  // the stop iteration formed the sum of psi: no barrier, each thread
  // shifts only its own sites
  T mean = T(0);
  if (sp.zero_mean) {
    mean = sum_partials<T, NT>(part + (4 + (nstop & 1)) * G, G, sh) /
           static_cast<T>(nsite);
  }
  if constexpr (ROUTE == kSorOnChip) {
    sor_store_brick(b, p0, mean, sp);
  } else if constexpr (ROUTE == kSorInPlace) {
    sor_unsplit(p0, cs, mean, sp, first, stride);
  } else if (sp.zero_mean) {
    for (int64_t s = first; s < nsite; s += stride) p0[s] = p0[s] - mean;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    istats[0] = nstop;
    istats[1] = which;
    rstats[0] = rn;
  }
}

template <typename T, int ROUTE>
static int sor_grid(int device, long long nsite, int smem, int* grid) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return kErrNoCooperativeLaunch;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(sor_kernel<T, ROUTE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sor_kernel<T, ROUTE>, SOR_THREADS(ROUTE), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the streaming routes: a block for each kThreads sites (pairs in place)
  const long long work = ROUTE == kSorInPlace ? nsite / 2 : nsite;
  const long long need = (work + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<int>(ROUTE == kSorOnChip || need > resident ? resident
                                                                   : need);
  return *grid > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

template <typename T, int ROUTE>
static int launch_sor(const void* psi, void* p0, void* p1, const void* rhs,
                      const void* om, void* part, void* faces, void* istats,
                      void* rstats, int grid, int smem, const double* par,
                      const int* ipar, cudaStream_t stream) {
  SorParams<T> sp;
  sp.eps = static_cast<T>(par[0]);
  sp.denom = static_cast<T>(par[1]);
  sp.rel_tol = static_cast<T>(par[2]);
  sp.abs_tol = static_cast<T>(par[3]);
  sp.stall_frac = static_cast<T>(par[4]);
  sp.X = ipar[0];
  sp.Y = ipar[1];
  sp.Z = ipar[2];
  sp.max_its = ipar[3];
  sp.ntab = ipar[4];
  sp.zero_mean = ipar[5];
  sp.stall = ipar[6];
  sp.bx = ipar[7];
  sp.by = ipar[8];
  if (ROUTE != kSorTwoBuffer && (sp.X % 2 || sp.Y % 2 || sp.Z % 2)) {
    return static_cast<int>(cudaErrorInvalidValue);  // colours would meet
  }
  if (ROUTE == kSorOnChip &&
      (sp.bx < 1 || sp.by < 1 || sp.X % sp.bx || sp.Y % sp.by ||
       grid != (sp.X / sp.bx) * (sp.Y / sp.by))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sor_kernel<T, ROUTE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const T* ain = static_cast<const T*>(psi);
  T* a0 = static_cast<T*>(p0);
  T* a1 = static_cast<T*>(p1);
  const T* a2 = static_cast<const T*>(rhs);
  const T* a3 = static_cast<const T*>(om);
  T* a4 = static_cast<T*>(part);
  T* a5 = static_cast<T*>(faces);
  int* a6 = static_cast<int*>(istats);
  T* a7 = static_cast<T*>(rstats);
  void* args[] = {&ain, &a0, &a1, &a2, &a3, &a4, &a5, &a6, &a7, &sp};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(sor_kernel<T, ROUTE>), dim3(grid),
      dim3(SOR_THREADS(ROUTE)), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

#define SOR_DISPATCH(F, ...)                                                \
  do {                                                                      \
    if (route < kSorTwoBuffer || route > kSorOnChip) {                      \
      return static_cast<int>(cudaErrorInvalidValue);                       \
    }                                                                       \
    if (is_f64) {                                                           \
      return route == kSorOnChip    ? F<double, kSorOnChip>(__VA_ARGS__)    \
             : route == kSorInPlace ? F<double, kSorInPlace>(__VA_ARGS__)   \
                                    : F<double, kSorTwoBuffer>(__VA_ARGS__); \
    }                                                                       \
    return route == kSorOnChip    ? F<float, kSorOnChip>(__VA_ARGS__)       \
           : route == kSorInPlace ? F<float, kSorInPlace>(__VA_ARGS__)      \
                                  : F<float, kSorTwoBuffer>(__VA_ARGS__);   \
  } while (0)

// -- Nernst-Planck + grad-mu: an x-march ----------------------------------

template <typename T>
struct NpParams {
  T kt_e, dt;
  T ez[kMaxSpecies], z[kMaxSpecies], c[kMaxSpecies];  // e z_k, z_k, -D_k/2
  int nk;
};

// Flux from site 0 to site 1 through their shared face (the Pallas
// kernel's expression): c (1 + 1/b) (n1 b - n0), b = exp(z (psi1 - psi0)),
// plus 0.5 (u0 + u1) 0.5 (n0 + n1) with hydrodynamics, times the face
// mask m0 m1.
template <typename T, int HYDRO>
__device__ __forceinline__ T face_flux(T psi0, T psi1, T n0, T n1, T u0,
                                       T u1, T m0, T m1, T z, T c) {
  const T b1 = exp(z * (psi1 - psi0));
  T flx = c * (T(1) + T(1) / b1) * (n1 * b1 - n0);
  if (HYDRO) {
    const T ua = T(0.5) * (u0 + u1);
    flx = flx + ua * T(0.5) * (n0 + n1);
  }
  return flx * (m0 * m1);
}

constexpr int kNpBZ = 32;          // the tile's z extent: one warp
constexpr int kNpW = kNpBZ + 2;    // a staged row: the tile's and the halo's
constexpr int kNpSlots = 3;        // staged planes x, x+1, x+2 (in flight)
constexpr int kNpStagePer = 2;     // staged sites a thread a plane, at most

struct NpGeom {
  int X, Y, Z;
  int BX, BY;     // x segment, tile rows (threads = BY x kNpBZ)
  int nty, ntz;   // tiles along y and z
};

// One block's shared buffers, in elements of T: kNpSlots staged planes of
// (BY+2) rows, each row NF fields side by side (psi, the fluid mask as T,
// with hydrodynamics u_x, u_y, u_z, then rho_0 .. rho_{nk-1}), each field
// kNpW sites along z; the +y faces of the halo row and of the tile's
// rows, (BY+1) rows of nk x kNpBZ; the +z faces of the halo column, BY x
// nk; then the int32 offsets of the staged rows and columns.  A field is
// a constant offset from a site's base, a row a run-time stride.
// ops/_cuda.py np_smem_bytes mirrors it.
struct NpLayout {
  int FR, NF, RS, PS, fy, fz, total;
  __host__ __device__ NpLayout(int nk, int hydro, int BY) {
    FR = hydro ? 5 : 2;
    NF = FR + nk;
    RS = NF * kNpW;
    PS = (BY + 2) * RS;
    fy = kNpSlots * PS;
    fz = fy + (BY + 1) * nk * kNpBZ;
    total = fz + BY * nk;
  }
  __host__ __device__ size_t bytes(size_t itemsize, int BY) const {
    return static_cast<size_t>(total) * itemsize +
           sizeof(int) * static_cast<size_t>(BY + 2 + kNpW);
  }
};

// A block owns a BY x kNpBZ tile of the y-z plane, a thread a column
// (warp = row, lane = z), and marches over its x segment.  Each face
// flux is computed once: the +x face of a column in a register, which
// the next plane takes as its -x face; the +y face of every site (and of
// the halo row below the tile) into shared memory, where the row above
// reads it; the +z face by warp shuffle to the next lane (lane 0 reads
// the halo column's face from shared memory).  The force and rho' keep
// the old thread-per-site kernel's term order: rho' and the force are
// bitwise the twin's where that kernel's were.  KMAX is the species the
// unrolled per-species registers hold (nk <= KMAX).  Sites of a tile
// beyond the lattice compute on wrapped sites and store nothing.  A
// thread's staged sites and its own site keep their offsets for the whole
// march, so a plane costs no index arithmetic beyond its base.  In f32
// the launch bound asks for two blocks of the most threads an SM, so at
// most 64 registers a thread: four 8x32 blocks an SM, where the
// compiler's own choice (84) left two.
template <typename T, int HYDRO, int KMAX>
__global__ void __launch_bounds__(k1::MaxThreads<T>::value,
                                  sizeof(T) == 4 ? 2 : 1)
np_gradmu_kernel(const T* __restrict__ psi, const T* __restrict__ rho,
                 const T* __restrict__ u, const uint8_t* __restrict__ fluid,
                 T* __restrict__ rho_out, T* __restrict__ force,
                 T* __restrict__ part, NpGeom g, NpParams<T> p) {
  constexpr int FM = kNpW, FU = 2 * kNpW;   // the mask, u_x; psi at 0
  const int BY = g.BY, nk = p.nk;
  const NpLayout L(nk, HYDRO, BY);
  const int RS = L.RS, FR = L.FR * kNpW, NKZ = nk * kNpBZ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  T* const fy = sm + L.fy;
  T* const fzh = sm + L.fz;
  int* const yoff = reinterpret_cast<int*>(sm + L.total);
  int* const zoff = yoff + BY + 2;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ly = tid >> 5, lz = tid & 31;
  const int b = blockIdx.x;
  const int tz = b % g.ntz, ty = (b / g.ntz) % g.nty;
  const int seg = b / (g.ntz * g.nty);
  const int y0 = ty * BY, z0 = tz * kNpBZ;
  const int xs = seg * g.BX;
  const int xe = min(xs + g.BX, g.X);
  const int plane = g.Y * g.Z, nsite = plane * g.X;
  const bool inside = y0 + ly < g.Y && z0 + lz < g.Z;

  for (int i = tid; i < BY + 2; i += nthr)
    yoff[i] = k1::wrap(y0 + i - 1, g.Y) * g.Z;
  for (int i = tid; i < kNpW; i += nthr) zoff[i] = k1::wrap(z0 + i - 1, g.Z);
  __syncthreads();

  // the staged sites of this thread: in-plane offset in the lattice and
  // element offset in a slot (-1: none)
  int goff[kNpStagePer], soff[kNpStagePer];
#pragma unroll
  for (int j = 0; j < kNpStagePer; ++j) {
    const int r = tid + j * nthr;
    const int ry = r / kNpW, rz = r - ry * kNpW;
    const bool ok = ry < BY + 2;
    goff[j] = ok ? yoff[ry] + zoff[rz] : 0;
    soff[j] = ok ? ry * RS + rz : -1;
  }
  // planes x in [xs, xe] -> slot (x - xs) % kNpSlots
  auto slot = [&](int x) -> T* { return sm + ((x - xs) % kNpSlots) * L.PS; };
  // stage plane x: the fields by cp.async, the mask into registers (the
  // caller stores them with put_mask once the slot's old mask is read)
  uint8_t mreg[kNpStagePer];
  auto stage = [&](int x) {
    T* const dst = slot(x);
    const int pb = k1::wrap(x, g.X) * plane;
#pragma unroll
    for (int j = 0; j < kNpStagePer; ++j) {
      if (soff[j] >= 0) {
        const int o = pb + goff[j];
        T* const d = dst + soff[j];
        k1::cp_async(d, psi + o);
        if (HYDRO) {
#pragma unroll
          for (int a = 0; a < 3; ++a)
            k1::cp_async(d + FU + a * kNpW, u + a * nsite + o);
        }
        for (int k = 0; k < nk; ++k)
          k1::cp_async(d + FR + k * kNpW, rho + k * nsite + o);
        mreg[j] = fluid[o];
      }
    }
    k1::cp_commit();
  };
  auto put_mask = [&](int x) {
    T* const dst = slot(x) + FM;
#pragma unroll
    for (int j = 0; j < kNpStagePer; ++j)
      if (soff[j] >= 0) dst[soff[j]] = static_cast<T>(mreg[j]);
  };

  // prologue: planes xs and xs+1 (xs + 1 <= xe); the -x faces of plane
  // xs and psi at xs-1, from the column's own sites of plane xs-1
  stage(xs);
  put_mask(xs);
  stage(xs + 1);
  put_mask(xs + 1);
  const int c = (ly + 1) * RS + lz + 1;    // the site in a slot
  const int own = yoff[ly + 1] + zoff[lz + 1];
  const int om = k1::wrap(xs - 1, g.X) * plane + own;
  T psi_prev = psi[om];
  T carry[KMAX];
  k1::cp_wait_all();
  __syncthreads();
  {
    const T* const s0 = slot(xs) + c;
    const T mm = static_cast<T>(fluid[om]);
    const T um = HYDRO ? u[om] : T(0);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < nk)
        carry[k] = face_flux<T, HYDRO>(
            psi_prev, s0[0], rho[k * nsite + om], s0[FR + k * kNpW], um,
            HYDRO ? s0[FU] : T(0), mm, s0[FM], p.z[k], p.c[k]);
    }
  }

  T fs[3] = {T(0), T(0), T(0)};
  for (int x = xs; x < xe; ++x) {
    // plane x+1 has landed; nobody reads plane x-1's slot or the faces
    k1::cp_wait_all();
    __syncthreads();
    const bool more = x + 2 <= xe;
    if (more) stage(x + 2);
    const T* const sc = slot(x) + c;       // the site, plane x
    const T* const sy = sc + RS;           // its +y neighbour
    const T* const sn = slot(x + 1) + c;   // its +x neighbour
    const int s = x * plane + own;
    const T ps = sc[0];

    // the raw grad-mu force rho_el E, E = -(psi+ - psi-) / 2 kt/e
    T re = T(0);
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k < nk) re = re + p.ez[k] * sc[FR + k * kNpW];
    const T e[3] = {T(-0.5) * (sn[0] - psi_prev) * p.kt_e,
                    T(-0.5) * (sy[0] - sc[-RS]) * p.kt_e,
                    T(-0.5) * (sc[1] - sc[-1]) * p.kt_e};
    if (inside) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const T f = re * e[a];
        force[a * nsite + s] = f;
        fs[a] = fs[a] + f;
      }
    }

    // each species' +x, +y and +z faces of the site, low site first
    const T ms = sc[FM];
    T* const fyt = fy + ly * NKZ + lz;      // row ly: the face below
    T dx[KMAX], upz[KMAX], dnz[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < nk) {
        const int fk = FR + k * kNpW;
        const T ns = sc[fk];
        const T upx = face_flux<T, HYDRO>(
            ps, sn[0], ns, sn[fk], HYDRO ? sc[FU] : T(0),
            HYDRO ? sn[FU] : T(0), ms, sn[FM], p.z[k], p.c[k]);
        dx[k] = upx - carry[k];
        carry[k] = upx;
        fyt[NKZ + k * kNpBZ] = face_flux<T, HYDRO>(
            ps, sy[0], ns, sy[fk], HYDRO ? sc[FU + kNpW] : T(0),
            HYDRO ? sy[FU + kNpW] : T(0), ms, sy[FM], p.z[k], p.c[k]);
        upz[k] = face_flux<T, HYDRO>(
            ps, sc[1], ns, sc[fk + 1], HYDRO ? sc[FU + 2 * kNpW] : T(0),
            HYDRO ? sc[FU + 2 * kNpW + 1] : T(0), ms, sc[FM + 1], p.z[k],
            p.c[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k < nk) dnz[k] = __shfl_up_sync(0xffffffffu, upz[k], 1);
    // the halo's faces: the +y faces of row -1 (threads 0..31), the +z
    // faces of column -1 (threads 32..32+BY-1)
    if (tid < kNpBZ + BY) {
      const bool ry = tid < kNpBZ;
      const T* const lo = slot(x) + (ry ? tid + 1 : (tid - kNpBZ + 1) * RS);
      const T* const hi = lo + (ry ? RS : 1);
      const int fu = FU + (ry ? kNpW : 2 * kNpW);
      T* const dst = ry ? fy + tid : fzh + (tid - kNpBZ) * nk;
      const int step = ry ? kNpBZ : 1;
      for (int k = 0; k < nk; ++k) {
        const int fk = FR + k * kNpW;
        dst[k * step] = face_flux<T, HYDRO>(
            lo[0], hi[0], lo[fk], hi[fk], HYDRO ? lo[fu] : T(0),
            HYDRO ? hi[fu] : T(0), lo[FM], hi[FM], p.z[k], p.c[k]);
      }
    }
    __syncthreads();

    // div = (up - dn) summed x, y, z; rho' = n - dt div at fluid sites
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < nk) {
        const T dnzk = lz == 0 ? fzh[ly * nk + k] : dnz[k];
        T div = dx[k];
        div = div + (fyt[NKZ + k * kNpBZ] - fyt[k * kNpBZ]);
        div = div + (upz[k] - dnzk);
        const T ns = sc[FR + k * kNpW];
        const T upd = ns - p.dt * div;
        if (inside) rho_out[k * nsite + s] = ms > T(0) ? upd : ns;
      }
    }
    psi_prev = ps;
    if (more) put_mask(x + 2);
  }
  // the block's partial sums of the force (fy is free as scratch)
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T v = block_sum_warps(fs[a], fy, nthr >> 5);
    if (tid == 0) part[a * gridDim.x + blockIdx.x] = v;
  }
}

template <typename T, int HYDRO, int KMAX>
static int launch_np_kmax(const NpGeom& g, int blocks, int threads,
                          int smem, const NpParams<T>& p, const void* psi,
                          const void* rho, const void* u, const void* fluid,
                          void* rho_out, void* force, void* part,
                          cudaStream_t stream) {
  auto kernel = np_gradmu_kernel<T, HYDRO, KMAX>;
  const cudaError_t e = k1::set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(psi), static_cast<const T*>(rho),
      static_cast<const T*>(u), static_cast<const uint8_t*>(fluid),
      static_cast<T*>(rho_out), static_cast<T*>(force),
      static_cast<T*>(part), g, p);
  return static_cast<int>(cudaGetLastError());
}

// the kernel instance for nk species: per-species registers for 2, or
// for kMaxSpecies
#define NP_DISPATCH(F, T, hydro, nk, ...)                                  \
  ((hydro) ? ((nk) <= 2 ? F<T, 1, 2>(__VA_ARGS__)                          \
                        : F<T, 1, kMaxSpecies>(__VA_ARGS__))               \
           : ((nk) <= 2 ? F<T, 0, 2>(__VA_ARGS__)                          \
                        : F<T, 0, kMaxSpecies>(__VA_ARGS__)))

// lay = BX, BY, threads, shared bytes, blocks (ops/_cuda.py np_layout):
// a layout the kernel does not take is refused, never launched; then the
// one-block sum of the blocks' partials, in one fixed order
template <typename T>
static int launch_np(int hydro, const void* psi, const void* rho,
                     const void* u, const void* fluid, void* rho_out,
                     void* force, void* part, void* fsum, int X, int Y,
                     int Z, int nk, const double* par, const int* lay,
                     cudaStream_t stream) {
  const int BX = lay[0], BY = lay[1], threads = lay[2], smem = lay[3],
            blocks = lay[4];
  const NpGeom g{X, Y, Z, BX, BY, (Y + BY - 1) / BY, (Z + kNpBZ - 1) / kNpBZ};
  if (nk < 1 || nk > kMaxSpecies || BX < 1 || BY < 1 ||
      threads != BY * kNpBZ || threads > k1::MaxThreads<T>::value ||
      (BY + 2) * kNpW > kNpStagePer * threads ||
      static_cast<size_t>(smem) !=
          NpLayout(nk, hydro, BY).bytes(sizeof(T), BY) ||
      static_cast<int64_t>(blocks) !=
          static_cast<int64_t>(g.nty) * g.ntz * ((X + BX - 1) / BX))
    return static_cast<int>(cudaErrorInvalidValue);
  NpParams<T> p;
  p.kt_e = static_cast<T>(par[0]);
  p.dt = static_cast<T>(par[1]);
  p.nk = nk;
  for (int k = 0; k < nk; ++k) {
    p.ez[k] = static_cast<T>(par[2 + k]);
    p.z[k] = static_cast<T>(par[2 + nk + k]);
    p.c[k] = static_cast<T>(par[2 + 2 * nk + k]);
  }
  const int rc = NP_DISPATCH(launch_np_kmax, T, hydro, nk, g, blocks,
                             threads, smem, p, psi, rho, u, fluid, rho_out,
                             force, part, stream);
  if (rc != 0) return rc;
  reduce_partials_kernel<T><<<1, kReduceThreads, 0, stream>>>(
      static_cast<const T*>(part), blocks, 3, T(1), static_cast<T*>(fsum));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HYDRO, int KMAX>
static int np_attrs(int device, int threads, int smem, int* out) {
  return k1::attrs(np_gradmu_kernel<T, HYDRO, KMAX>, device, threads, smem,
                   out);
}

extern "C" {

// out[0..4): the registers a thread of the instance for nk species,
// (threads > 0) the blocks an SM the card keeps resident with `smem`
// bytes each, the card's multiprocessors and shared-memory opt-in
int lb_np_attrs(int is_f64, int hydro, int nk, int device, int threads,
                int smem, int* out) {
  if (nk < 1 || nk > kMaxSpecies)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_f64 ? NP_DISPATCH(np_attrs, double, hydro, nk, device, threads,
                              smem, out)
                : NP_DISPATCH(np_attrs, float, hydro, nk, device, threads,
                              smem, out);
}

int lb_electro_device_info(int device, int* sms, int* smem_optin) {
  cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                         device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(smem_optin,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return static_cast<int>(e);
}

// route: 0 two-buffer, 1 in-place, 2 on-chip (smem: its dynamic shared
// memory); grid: the cooperative launch's blocks (on-chip: what the card
// keeps resident, which must cover the bricks)
int lb_sor_grid(int is_f64, int route, int device, long long nsite,
                int smem, int* grid) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  SOR_DISPATCH(sor_grid, device, nsite, smem, grid);
}

int lb_sor_solve(int is_f64, int route, const void* psi, void* p0, void* p1,
                 const void* rhs, const void* om_tab, void* part, void* faces,
                 void* istats, void* rstats, int grid, int smem,
                 const double* par, const int* ipar, void* stream,
                 int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SOR_DISPATCH(launch_sor, psi, p0, p1, rhs, om_tab, part, faces, istats,
               rstats, grid, smem, par, ipar, s);
}

// par = [kt/e, dt, e z_k..., z_k..., -D_k/2...]; lay = BX, BY, threads,
// shared bytes, blocks (ops/_cuda.py np_layout); part holds 3 x blocks
int lb_np_gradmu(int is_f64, int hydro, const void* psi, const void* rho,
                 const void* u, const void* fluid, void* rho_out, void* force,
                 void* part, void* fsum, int X, int Y, int Z, int nk,
                 const double* par, const int* lay, void* stream,
                 int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_np<double>(hydro, psi, rho, u, fluid, rho_out,
                                    force, part, fsum, X, Y, Z, nk, par, lay,
                                    s)
                : launch_np<float>(hydro, psi, rho, u, fluid, rho_out, force,
                                   part, fsum, X, Y, Z, nk, par, lay, s);
}

}  // extern "C"
