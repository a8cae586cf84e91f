// Fused collide + stream kernels for Hopper (sm_90a), D3Q15/19/27 and
// D2Q9, f32/f64.
//
// Replaces the Pallas TPU kernels of ludwig_tpu/ops/fused.py:
//   fused_step_kernel        <- _fused_kernel  (ops/fused.py:429), one step;
//                               with NOISE, the same kernel with
//                               FusedNoise (its second pallas_call,
//                               ops/fused.py:604): isothermal
//                               fluctuations in the collision
//   fusedn_step_kernel       <- _fusedn_kernel (ops/fused.py:902), n
//                               steps/pass
//   fused_force_step_kernel  <- _fused_force_kernel (ops/fused.py:1069)
//                               without its solid variant: one step with a
//                               per-site force, writing u
//   fused_force_step_solid_kernel <- the same kernel's `with_solid`
//                               variant: half-way bounce-back on an
//                               in-lattice solid mask, and the momentum
//                               the links hand to the walls
//
// All compute f'_q(x) = C(f)_q(x - c_q): a local moment-space collision C
// (M10/BGK/TRT through per-ghost rates, a body force, even/odd
// factorised transforms, increment or absolute back transform) followed
// by a periodic pull stream, on the unpadded state (nvel, X, Y, Z) with z
// fastest.  The collision is lb_generated.h, straight-line code generated
// at build time from the port's Python twin and lattice.py tables
// (ops/_cuda.py), so the kernels and the twins share one expression tree.
//
// Bound on this card: memory.  One step must read and write every value
// once: 2 * nvel * sizeof(T) bytes per site (152 B for D3Q19 in f32)
// against ~1.6 flop/B of collision arithmetic, far below the H100's
// ~20 flop/B balance point in f32.
//
// fused_step_kernel: one thread per site, z fastest.  The thread reads its
// site's nvel values (coalesced across the warp), collides in registers
// and pushes C(f)_q to (x + c_q) mod L in a second buffer - one read and
// one write per value, no collision recomputed.  Push of C is the same
// stored state as the TPU kernel's pull of C (pull-then-collide per site
// would compute C(S(f)), a different state).
//
// fused_step_kernel<NOISE>: the fluctuating collision (ref:
// collision.c:53).  Each thread hashes its own site's global (x, y, z)
// with the step counter and the seed into 6 + nghost counter-based
// deviates of the reference's 8-value table (the JAX
// package's int32 murmur3 hash, here on uint32_t words: the same bits)
// and hands them to lb_collide_noise_*, generated from the twin's
// _noise_sg / _relax_modes.  The TPU kernel re-draws the noise for its
// window's halo and mirrors the z lane padding; in push form every site
// collides once, in its own thread, so neither exists here.  Bound: the
// same 152 B/site as fused_step_kernel; the hash adds ~8 + 14 per
// deviate integer operations and no bytes.
//
// fusedn_step_kernel: temporal blocking, 2.5-D, marching along x.  A
// block owns a y-z tile (BY, BZ) and an x segment of BX planes, and
// marches over the segment's planes plus n at each end, one pipeline
// stage per time level: at march step k, level L collides local plane
// j = k - L of its window (the tile widened by n - L sites in y and z)
// and pushes C_q to plane j + c_qx of level L + 1's window, which is one
// site narrower per side; the last level writes fout.  Level L + 1 then
// finds plane j - 1 complete: its c_x = -1 values came this step, its
// c_x = 0 values one step ago, its c_x = +1 values two steps ago.  So
// each level's input lives in a ring with 2 + c_x slots per velocity
// (lb_ring_base, LB_RING), 2 nvel values a window site in all:
// two planes a level.  The rings sit in shared memory where one block's
// fit the opt-in limit, else in a per-block global scratch of the same
// O(planes) size (the launcher says which route: nstep_layout in
// ops/fused.py).  x has no halo apart from the n planes at each end of
// the segment; y and z carry n.  HBM traffic per step falls from
// 2 nvel values a site to ~[(BY + 2n)(BZ + 2n) / (BY BZ) + 1] nvel / n,
// at the price of recomputing the y-z halo's collisions: on this card
// the march is bound by the instructions of its collisions, not by
// bytes.  Each value is the same collide of the same inputs as in n
// single-step launches, so
// the results are bitwise equal to them.

// fused_force_step_kernel: fused_step_kernel's push design with a
// per-site Guo force (the K2 pass of the binary fluid, and of the LC,
// droplet and electrokinetic steps in the JAX package).  The thread also
// reads force[a] at its site and writes the collision-time velocity
// u = (m_1 + F/2) / rho, before streaming.  Increment form only, as in
// the TPU kernel.  Bound: memory, (nvel + 3) values read and written per
// site, 176 B for D3Q19 in f32, against ~3 flop/B of arithmetic.
//
// fused_force_step_solid_kernel: the same push with a uint8 solid mask
// (the electrokinetic LB step's Gouy-Chapman walls).  The semantics are
// those of collide(fluid_mask) + stream_bounce_back: a solid site keeps
// its pre-collision values, unstreamed; a link whose pull source is solid
// receives the receiver's own post-collision antipode value.  In push
// form a fluid site's post-collision value C_q heads for x + c_q; if that
// site is solid it comes back into the antipode -q at x instead (the same
// value the pull form takes), and the wall receives -c_q C_q of momentum
// per link (gw = -2 sum, as the TPU kernel accumulates it).  Every output
// value is written once: by its fluid source, by its fluid receiver after
// a bounce, or by the solid site itself.  u is written at every site, as
// in the TPU kernel (solid sites' u is that of their own, discarded,
// collision).  The wall momentum is summed per block and the partials
// reduced in a fixed order by a one-block launch: no float atomics.
// Bound: memory, (nvel + 3) values read and written per site plus the
// mask byte, 177 B/site for D3Q19 in f32.
//
// Offsets are 64-bit: nvel*X*Y*Z passes 2^31 at 512^3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lb_generated.h"
#include "reduce.cuh"

constexpr int kThreads = kReduceThreads;

template <typename T>
struct LBParams {
  T rt, rtb;            // shear and bulk relaxation rates
  T fx, fy, fz;         // global body force
  T g[LB_NGHOST];       // per-ghost factor on m_g (general variants)
  // fluctuations (fused_step_kernel<NOISE> only): amplitudes v_eta *
  // sqrt(2), v_eta, v_bulk and per ghost, folded in double on the host;
  // the seed & 0x7fffffff and the step counter of the hash
  T nz_eta2, nz_eta, nz_bulk;
  T nz_g[LB_NGHOST];
  uint32_t nz_seed;
  int nz_t;
};

template <typename T>
static LBParams<T> make_params(const double* par) {
  LBParams<T> p;
  p.rt = static_cast<T>(par[0]);
  p.rtb = static_cast<T>(par[1]);
  p.fx = static_cast<T>(par[2]);
  p.fy = static_cast<T>(par[3]);
  p.fz = static_cast<T>(par[4]);
  for (int i = 0; i < LB_NGHOST; ++i) p.g[i] = static_cast<T>(par[5 + i]);
  return p;
}

// the fluctuation parameters on top of make_params' (npar: the
// amplitudes v_eta * sqrt(2), v_eta, v_bulk, then one per ghost)
template <typename T>
static LBParams<T> make_noise_params(const double* par, const double* npar,
                                     uint32_t seed, int t) {
  LBParams<T> p = make_params<T>(par);
  p.nz_eta2 = static_cast<T>(npar[0]);
  p.nz_eta = static_cast<T>(npar[1]);
  p.nz_bulk = static_cast<T>(npar[2]);
  for (int i = 0; i < LB_NGHOST; ++i) p.nz_g[i] = static_cast<T>(npar[3 + i]);
  p.nz_seed = seed;
  p.nz_t = t;
  return p;
}

constexpr int kNoiseDeviates = 6 + LB_NGHOST;

// murmur3 finalizer (ludwig_tpu/ops/fused.py _hash_u32)
__device__ __forceinline__ uint32_t lb_hash_u32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// 3 bits -> {-A, -B, 0 x4, +B, +A}, A = sqrt(2 + sqrt 2), B = sqrt(2 -
// sqrt 2), each the double rounded to T (_deviate_from_bits)
template <typename T>
__device__ __forceinline__ T lb_deviate(uint32_t bits) {
  const T a = static_cast<T>(1.8477590650225735);
  const T b = static_cast<T>(0.7653668647301795);
  const uint32_t idx = bits & 7u;
  return idx == 0u ? -a
                   : (idx == 1u ? -b
                                : (idx == 6u ? b : (idx == 7u ? a : T(0))));
}

// the site's 6 + nghost deviates (_window_deviates): the int32 products
// and xors of the JAX hash are these uint32_t ones bit for bit
template <typename T>
__device__ __forceinline__ void lb_site_deviates(int x, int y, int z,
                                                 const LBParams<T>& p,
                                                 T* r) {
  uint32_t base = static_cast<uint32_t>(x) * 73856093u ^
                  static_cast<uint32_t>(y) * 19349663u ^
                  static_cast<uint32_t>(z) * 83492791u;
  base ^= static_cast<uint32_t>(p.nz_t) * 0x9e3779b9u;
  base ^= p.nz_seed;
#pragma unroll
  for (int m = 0; m < kNoiseDeviates; ++m)
    r[m] = lb_deviate<T>(lb_hash_u32(base ^ static_cast<uint32_t>(m * 40503)));
}

// the collision of the site values f; with NOISE, plus the fluctuations
// of the site deviates r (unused without)
template <typename T, int DELTA, int PROJ, bool NOISE = false, typename Emit>
__device__ __forceinline__ void lb_collide(const T* f, const T* r,
                                           const LBParams<T>& p, Emit& emit) {
  if constexpr (NOISE) {
    if constexpr (DELTA && PROJ) {
      lb_collide_noise_d1_p1<T>(f, r, p, emit);
    } else if constexpr (DELTA) {
      lb_collide_noise_d1_p0<T>(f, r, p, emit);
    } else if constexpr (PROJ) {
      lb_collide_noise_d0_p1<T>(f, r, p, emit);
    } else {
      lb_collide_noise_d0_p0<T>(f, r, p, emit);
    }
  } else if constexpr (DELTA && PROJ) {
    lb_collide_d1_p1<T>(f, p, emit);
  } else if constexpr (DELTA) {
    lb_collide_d1_p0<T>(f, p, emit);
  } else if constexpr (PROJ) {
    lb_collide_d0_p1<T>(f, p, emit);
  } else {
    lb_collide_d0_p0<T>(f, p, emit);
  }
}

// i in [-n, 2n): one conditional add or subtract
__device__ __forceinline__ int wrap1(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// any i
__device__ __forceinline__ int wrapn(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

template <typename T, int DELTA, int PROJ, bool NOISE>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const T* __restrict__ fin, T* __restrict__ fout, int X,
                  int Y, int Z, LBParams<T> p) {
  const int64_t nsite = static_cast<int64_t>(X) * Y * Z;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (s >= nsite) return;
  const int z = static_cast<int>(s % Z);
  const int64_t r = s / Z;
  const int y = static_cast<int>(r % Y);
  const int x = static_cast<int>(r / Y);
  T f[LB_NVEL];
#pragma unroll
  for (int q = 0; q < LB_NVEL; ++q) f[q] = fin[q * nsite + s];
  T dev[NOISE ? kNoiseDeviates : 1];
  if constexpr (NOISE) lb_site_deviates<T>(x, y, z, p, dev);
  auto emit = [&](int q, int cx, int cy, int cz, T v) {
    const int64_t d =
        (static_cast<int64_t>(wrap1(x + cx, X)) * Y + wrap1(y + cy, Y)) * Z +
        wrap1(z + cz, Z);
    fout[q * nsite + d] = v;
  };
  lb_collide<T, DELTA, PROJ, NOISE>(f, dev, p, emit);
}

// The force kernels take the three-dimensional velocity sets only, as
// the TPU kernel does (its u has three components): a D2Q9 header sets
// LB_NO_FORCE and has no lb_collide_force_*.
#ifndef LB_NO_FORCE
template <typename T, int PROJ>
__global__ void __launch_bounds__(kThreads)
fused_force_step_kernel(const T* __restrict__ fin,
                        const T* __restrict__ force, T* __restrict__ fout,
                        T* __restrict__ uout, int X, int Y, int Z,
                        LBParams<T> p) {
  const int64_t nsite = static_cast<int64_t>(X) * Y * Z;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (s >= nsite) return;
  const int z = static_cast<int>(s % Z);
  const int64_t r = s / Z;
  const int y = static_cast<int>(r % Y);
  const int x = static_cast<int>(r / Y);
  T f[LB_NVEL];
#pragma unroll
  for (int q = 0; q < LB_NVEL; ++q) f[q] = fin[q * nsite + s];
  // total force: the global body force is added only where it is
  // non-zero, as the twin does (ops/fused.py _collide)
  const T fg[3] = {p.fx, p.fy, p.fz};
  T fs[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T v = force[a * nsite + s];
    fs[a] = fg[a] != T(0) ? v + fg[a] : v;
  }
  auto emit = [&](int q, int cx, int cy, int cz, T v) {
    const int64_t d =
        (static_cast<int64_t>(wrap1(x + cx, X)) * Y + wrap1(y + cy, Y)) * Z +
        wrap1(z + cz, Z);
    fout[q * nsite + d] = v;
  };
  T u[3];
  if constexpr (PROJ) {
    lb_collide_force_p1<T>(f, fs, p, emit, u);
  } else {
    lb_collide_force_p0<T>(f, fs, p, emit, u);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) uout[a * nsite + s] = u[a];
}

template <typename T, int PROJ>
__global__ void __launch_bounds__(kThreads)
fused_force_step_solid_kernel(const T* __restrict__ fin,
                              const T* __restrict__ force,
                              const uint8_t* __restrict__ solid,
                              T* __restrict__ fout, T* __restrict__ uout,
                              T* __restrict__ part, int X, int Y, int Z,
                              LBParams<T> p) {
  __shared__ T sh[kThreads / 32 + 1];
  const int64_t nsite = static_cast<int64_t>(X) * Y * Z;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  T w[3] = {T(0), T(0), T(0)};   // momentum given to the walls, per axis
  if (s < nsite) {
    const int z = static_cast<int>(s % Z);
    const int64_t r = s / Z;
    const int y = static_cast<int>(r % Y);
    const int x = static_cast<int>(r / Y);
    T f[LB_NVEL];
#pragma unroll
    for (int q = 0; q < LB_NVEL; ++q) f[q] = fin[q * nsite + s];
    const T fg[3] = {p.fx, p.fy, p.fz};
    T fs[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T v = force[a * nsite + s];
      fs[a] = fg[a] != T(0) ? v + fg[a] : v;
    }
    const bool sol = solid[s] != 0;
    auto emit = [&](int q, int cx, int cy, int cz, T v) {
      if (sol) return;   // a solid site keeps its pre-collision values
      const int64_t d =
          (static_cast<int64_t>(wrap1(x + cx, X)) * Y + wrap1(y + cy, Y)) * Z +
          wrap1(z + cz, Z);
      if (!solid[d]) {
        fout[q * nsite + d] = v;
        return;
      }
      // bounced: back into the antipode here; the wall takes -c_q v
      fout[lb_anti(q) * nsite + s] = v;
      if (cx) w[0] = cx > 0 ? w[0] - v : w[0] + v;
      if (cy) w[1] = cy > 0 ? w[1] - v : w[1] + v;
      if (cz) w[2] = cz > 0 ? w[2] - v : w[2] + v;
    };
    T u[3];
    if constexpr (PROJ) {
      lb_collide_force_p1<T>(f, fs, p, emit, u);
    } else {
      lb_collide_force_p0<T>(f, fs, p, emit, u);
    }
    if (sol) {
#pragma unroll
      for (int q = 0; q < LB_NVEL; ++q) fout[q * nsite + s] = f[q];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) uout[a * nsite + s] = u[a];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T b = block_sum_all(w[a], sh);
    if (threadIdx.x == 0) part[a * gridDim.x + blockIdx.x] = b;
  }
}

#endif  // LB_NO_FORCE

// threads a block of the n-step kernel at most: f32 within 128
// registers, f64 (~144 registers for the collision) within 255
#define NSTEP_MAX_THREADS(T) (sizeof(T) == 4 ? 512 : 256)

// One level of the march: collide local plane j of the level's window
// (halo h in y and z) and push each value to the next level's ring, or,
// on the last level, to fout.  Level 0 (src null) reads fin, the others
// their ring src.  Per site, the destination offset of c = 0 and a mask
// of the (c_x,) c_y, c_z in {-1, 0, 1} that stay inside the next window
// (the tile) are formed once; an emit then adds its velocity's constant
// offsets and tests one bit.  The site (ly, lz) advances by the block's
// stride with a carry.
template <typename T, int DELTA, int PROJ, bool LAST>
__device__ __forceinline__ void nstep_level(
    const T* __restrict__ fin, const T* src, T* dst, T* __restrict__ fout,
    int j, int h, int n, int X, int Y, int Z, int BX, int BY, int BZ,
    int x0, int y0, int z0, int64_t nsite, const LBParams<T>& p) {
  const int WY = BY + 2 * h, WZ = BZ + 2 * h, S = WY * WZ;
  const int DY = WY - 2, DZ = WZ - 2, DS = DY * DZ;  // the next window
  const int64_t YZ = static_cast<int64_t>(Y) * Z;
  // ring slots: of plane j for the reads (c_x = 0, +1), of plane j + c_x
  // for the writes (c_x = -1 always slot 0)
  const int rd0 = (j & 1) * S, rdp = (j % 3) * S;
  const int wr0 = (j & 1) * DS, wrp = ((j + 1) % 3) * DS;
  const int64_t gx = wrapn(x0 - n + j, X);
  // the last level: bit c_x + 1 set where c_x lands in the segment; the
  // global plane of c_x = 0
  unsigned xmask = 7u;
  int64_t obase = 0;
  if constexpr (LAST) {
    xmask = 0u;
#pragma unroll
    for (int c = -1; c <= 1; ++c) {
      const int jx = j + c;
      if (jx >= n && jx < n + BX && x0 + jx - n < X) xmask |= 1u << (c + 1);
    }
    obase = static_cast<int64_t>(x0 + j - n) * YZ;
  }
  const int sy = blockDim.x / WZ, sz = blockDim.x % WZ;
  int ly = threadIdx.x / WZ, lz = threadIdx.x % WZ;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    T f[LB_NVEL];
    if (src == nullptr) {
      const T* fp = fin + (gx * Y + wrapn(y0 - h + ly, Y)) * Z +
                    wrapn(z0 - h + lz, Z);
#pragma unroll
      for (int q = 0; q < LB_NVEL; ++q) f[q] = fp[q * nsite];
    } else {
#pragma unroll
      for (int q = 0; q < LB_NVEL; ++q) {
        const int cx = lb_cx(q);
        f[q] = src[lb_ring_base(q) * S + (cx < 0 ? 0 : (cx == 0 ? rd0 : rdp)) +
                   i];
      }
    }
    // c = 0's destination in the next window (or the tile); bit
    // 9 (c_x + 1) + 3 (c_y + 1) + c_z + 1 of vmask set where c stays in
    const int ay = ly - 1, az = lz - 1;
    unsigned ymask = 0u, zmask = 0u;
#pragma unroll
    for (int c = -1; c <= 1; ++c) {
      bool yin = ay + c >= 0 && ay + c < DY;
      bool zin = az + c >= 0 && az + c < DZ;
      if constexpr (LAST) {  // ragged edge tiles
        yin = yin && y0 + ay + c < Y;
        zin = zin && z0 + az + c < Z;
      }
      ymask |= yin ? 1u << (c + 1) : 0u;
      zmask |= zin ? 1u << (c + 1) : 0u;
    }
    unsigned vmask = 0u;
#pragma unroll
    for (int cx = 0; cx < 3; ++cx) {
#pragma unroll
      for (int cy = 0; cy < 3; ++cy) {
        const bool in = (xmask >> cx) & (ymask >> cy) & 1u;
        vmask |= in ? zmask << (9 * cx + 3 * cy) : 0u;
      }
    }
    if constexpr (LAST) {
      T* op = fout + obase + static_cast<int64_t>(y0 + ay) * Z + (z0 + az);
      auto emit = [&](int q, int cx, int cy, int cz, T v) {
        if ((vmask >> (9 * (cx + 1) + 3 * (cy + 1) + cz + 1)) & 1u)
          op[q * nsite + cx * YZ + cy * Z + cz] = v;
      };
      lb_collide<T, DELTA, PROJ>(f, nullptr, p, emit);
    } else {
      const int ob = ay * DZ + az;
      auto emit = [&](int q, int cx, int cy, int cz, T v) {
        if ((vmask >> (9 * (cx + 1) + 3 * (cy + 1) + cz + 1)) & 1u)
          dst[ob + lb_ring_base(q) * DS +
              (cx < 0 ? 0 : (cx == 0 ? wr0 : wrp)) + cy * DZ + cz] = v;
      };
      lb_collide<T, DELTA, PROJ>(f, nullptr, p, emit);
    }
    lz += sz;
    const int carry = lz >= WZ;
    lz -= carry * WZ;
    ly += sy + carry;
  }
}

// GLOBAL_RING false: the rings (per_block values a block) in shared
// memory, addressed as such; true: in scratch.
template <typename T, int DELTA, int PROJ, bool GLOBAL_RING>
__global__ void __launch_bounds__(NSTEP_MAX_THREADS(T))
fusedn_step_kernel(const T* __restrict__ fin, T* __restrict__ fout, int X,
                   int Y, int Z, int nsteps, int BX, int BY, int BZ,
                   T* scratch, int64_t per_block, LBParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring;
  if constexpr (GLOBAL_RING) {
    ring = scratch + static_cast<int64_t>(blockIdx.x) * per_block;
  } else {
    ring = reinterpret_cast<T*>(smem_raw);
  }
  const int n = nsteps;
  const int64_t nsite = static_cast<int64_t>(X) * Y * Z;
  const int ntx = (X + BX - 1) / BX, nty = (Y + BY - 1) / BY,
            ntz = (Z + BZ - 1) / BZ;
  const int64_t ntiles = static_cast<int64_t>(ntx) * nty * ntz;

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tz = static_cast<int>(tile % ntz);
    const int64_t tr = tile / ntz;
    const int ty = static_cast<int>(tr % nty);
    const int tx = static_cast<int>(tr / nty);
    const int x0 = tx * BX, y0 = ty * BY, z0 = tz * BZ;
    for (int k = 0; k < BX + 2 * n; ++k) {
      // level L starts at step 2 L, when its first plane (j = L) is whole
      int in_off = 0;  // level L's input ring
      for (int L = 0; L < n && 2 * L <= k; ++L) {
        const int h = n - L;
        const int S = (BY + 2 * h) * (BZ + 2 * h);
        const int out_off = L == 0 ? 0 : in_off + LB_RING * S;
        const T* src = L == 0 ? nullptr : ring + in_off;
        if (L == n - 1) {
          nstep_level<T, DELTA, PROJ, true>(fin, src, nullptr, fout, k - L,
                                            h, n, X, Y, Z, BX, BY, BZ, x0,
                                            y0, z0, nsite, p);
        } else {
          nstep_level<T, DELTA, PROJ, false>(fin, src, ring + out_off,
                                             nullptr, k - L, h, n, X, Y, Z,
                                             BX, BY, BZ, x0, y0, z0, nsite,
                                             p);
        }
        __syncthreads();
        in_off = out_off;
      }
    }
  }
}

// npar null: the noiseless kernel; else its fluctuation amplitudes, with
// the hash's seed and step counter
template <typename T, int DELTA, int PROJ>
static int launch_step(const void* fin, void* fout, int X, int Y, int Z,
                       const double* par, const double* npar, uint32_t seed,
                       int t, cudaStream_t stream) {
  const int64_t nsite = static_cast<int64_t>(X) * Y * Z;
  const unsigned blocks =
      static_cast<unsigned>((nsite + kThreads - 1) / kThreads);
  const T* in = static_cast<const T*>(fin);
  T* out = static_cast<T*>(fout);
  if (npar == nullptr) {
    fused_step_kernel<T, DELTA, PROJ, false><<<blocks, kThreads, 0, stream>>>(
        in, out, X, Y, Z, make_params<T>(par));
  } else {
    fused_step_kernel<T, DELTA, PROJ, true><<<blocks, kThreads, 0, stream>>>(
        in, out, X, Y, Z, make_noise_params<T>(par, npar, seed, t));
  }
  return static_cast<int>(cudaGetLastError());
}

#ifndef LB_NO_FORCE
template <typename T, int PROJ>
static int launch_force_step(const void* fin, const void* force, void* fout,
                             void* uout, int X, int Y, int Z,
                             const double* par, cudaStream_t stream) {
  const int64_t nsite = static_cast<int64_t>(X) * Y * Z;
  const int64_t blocks = (nsite + kThreads - 1) / kThreads;
  fused_force_step_kernel<T, PROJ><<<static_cast<unsigned>(blocks),
                                     kThreads, 0, stream>>>(
      static_cast<const T*>(fin), static_cast<const T*>(force),
      static_cast<T*>(fout), static_cast<T*>(uout), X, Y, Z,
      make_params<T>(par));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PROJ>
static int launch_force_step_solid(const void* fin, const void* force,
                                   const void* solid, void* fout, void* uout,
                                   void* part, void* gw, int X, int Y, int Z,
                                   const double* par, cudaStream_t stream) {
  const int64_t nsite = static_cast<int64_t>(X) * Y * Z;
  const int blocks = static_cast<int>((nsite + kThreads - 1) / kThreads);
  fused_force_step_solid_kernel<T, PROJ><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(fin), static_cast<const T*>(force),
      static_cast<const uint8_t*>(solid), static_cast<T*>(fout),
      static_cast<T*>(uout), static_cast<T*>(part), X, Y, Z,
      make_params<T>(par));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials_kernel<T><<<1, kReduceThreads, 0, stream>>>(
      static_cast<const T*>(part), blocks, 3, T(-2), static_cast<T*>(gw));
  return static_cast<int>(cudaGetLastError());
}
#endif  // LB_NO_FORCE

template <typename T, int DELTA, int PROJ>
static int launch_stepn(const void* fin, void* fout, int X, int Y, int Z,
                        int nsteps, int BX, int BY, int BZ, void* scratch,
                        long long per_block, int grid, int threads, int smem,
                        const double* par, cudaStream_t stream) {
  if (threads < 32 || threads % 32 ||
      threads > static_cast<int>(NSTEP_MAX_THREADS(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* in = static_cast<const T*>(fin);
  T* out = static_cast<T*>(fout);
  if (scratch != nullptr) {
    fusedn_step_kernel<T, DELTA, PROJ, true><<<grid, threads, 0, stream>>>(
        in, out, X, Y, Z, nsteps, BX, BY, BZ, static_cast<T*>(scratch),
        per_block, make_params<T>(par));
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = fusedn_step_kernel<T, DELTA, PROJ, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, stream>>>(in, out, X, Y, Z, nsteps, BX, BY,
                                          BZ, nullptr, per_block,
                                          make_params<T>(par));
  return static_cast<int>(cudaGetLastError());
}

#define LB_DISPATCH(F, ...)                                              \
  do {                                                                   \
    if (is_f64) {                                                        \
      if (delta) {                                                       \
        return proj ? F<double, 1, 1>(__VA_ARGS__)                       \
                    : F<double, 1, 0>(__VA_ARGS__);                      \
      }                                                                  \
      return proj ? F<double, 0, 1>(__VA_ARGS__)                         \
                  : F<double, 0, 0>(__VA_ARGS__);                        \
    }                                                                    \
    if (delta) {                                                         \
      return proj ? F<float, 1, 1>(__VA_ARGS__) : F<float, 1, 0>(__VA_ARGS__); \
    }                                                                    \
    return proj ? F<float, 0, 1>(__VA_ARGS__) : F<float, 0, 0>(__VA_ARGS__);   \
  } while (0)

extern "C" {

int lb_nvel(void) { return LB_NVEL; }

int lb_device_info(int device, int* sms, int* smem_optin) {
  cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                         device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(smem_optin,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return static_cast<int>(e);
}

int lb_fused_step(int is_f64, int delta, int proj, const void* fin,
                  void* fout, int X, int Y, int Z, const double* par,
                  const double* npar, uint32_t seed, int t, void* stream,
                  int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LB_DISPATCH(launch_step, fin, fout, X, Y, Z, par, npar, seed, t, s);
}

int lb_fusedn_step(int is_f64, int delta, int proj, const void* fin,
                   void* fout, int X, int Y, int Z, int nsteps, int BX,
                   int BY, int BZ, void* scratch, long long per_block,
                   int grid, int threads, int smem, const double* par,
                   void* stream, int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LB_DISPATCH(launch_stepn, fin, fout, X, Y, Z, nsteps, BX, BY, BZ, scratch,
              per_block, grid, threads, smem, par, s);
}

int lb_fused_force_step(int is_f64, int proj, const void* fin,
                        const void* force, void* fout, void* uout, int X,
                        int Y, int Z, const double* par, void* stream,
                        int device) {
#ifdef LB_NO_FORCE
  return static_cast<int>(cudaErrorNotSupported);
#else
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return proj ? launch_force_step<double, 1>(fin, force, fout, uout, X, Y,
                                               Z, par, s)
                : launch_force_step<double, 0>(fin, force, fout, uout, X, Y,
                                               Z, par, s);
  }
  return proj ? launch_force_step<float, 1>(fin, force, fout, uout, X, Y, Z,
                                            par, s)
              : launch_force_step<float, 0>(fin, force, fout, uout, X, Y, Z,
                                            par, s);
#endif
}

int lb_force_step_blocks(long long nsite) {
  return static_cast<int>((nsite + kThreads - 1) / kThreads);
}

int lb_fused_force_step_solid(int is_f64, int proj, const void* fin,
                              const void* force, const void* solid,
                              void* fout, void* uout, void* part, void* gw,
                              int X, int Y, int Z, const double* par,
                              void* stream, int device) {
#ifdef LB_NO_FORCE
  return static_cast<int>(cudaErrorNotSupported);
#else
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return proj ? launch_force_step_solid<double, 1>(
                      fin, force, solid, fout, uout, part, gw, X, Y, Z, par, s)
                : launch_force_step_solid<double, 0>(
                      fin, force, solid, fout, uout, part, gw, X, Y, Z, par,
                      s);
  }
  return proj ? launch_force_step_solid<float, 1>(fin, force, solid, fout,
                                                  uout, part, gw, X, Y, Z,
                                                  par, s)
              : launch_force_step_solid<float, 0>(fin, force, solid, fout,
                                                  uout, part, gw, X, Y, Z,
                                                  par, s);
#endif
}

}  // extern "C"
