// Fused collide + stream kernels for Hopper (sm_90a), D3Q15/19/27, f32/f64.
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
// fusedn_step_kernel: temporal blocking.  A block owns an output tile
// (BX, BY, BZ) and walks n steps over windows that start n sites wider on
// every side and shrink by one per step; step s collides its whole window
// and keeps only values that land in the next window.  The intermediate
// windows live in shared memory when a block's pair of them fits the
// opt-in limit, otherwise in a per-block global scratch (L2-resident for
// the recently touched part).  It aims at (1 + halo) / n of the
// single-step HBM traffic per step, at the price of recomputing the halo
// collisions; each value is the same collide of the same inputs as in n
// single-step launches, so the results are equal to them.
//
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

template <typename T, int DELTA, int PROJ>
__global__ void __launch_bounds__(kThreads)
fusedn_step_kernel(const T* __restrict__ fin, T* __restrict__ fout, int X,
                   int Y, int Z, int nsteps, int BX, int BY, int BZ,
                   T* scratch, int64_t per_block, LBParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufA = scratch ? scratch + static_cast<int64_t>(blockIdx.x) * per_block
                    : reinterpret_cast<T*>(smem_raw);
  const int64_t volA =
      nsteps >= 2 ? static_cast<int64_t>(BX + 2 * (nsteps - 1)) *
                        (BY + 2 * (nsteps - 1)) * (BZ + 2 * (nsteps - 1))
                  : 0;
  T* bufB = bufA + LB_NVEL * volA;
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
    const T* src = nullptr;  // step 0 reads the global state
    T* dst = bufA;
    for (int st = 0; st < nsteps; ++st) {
      const int hs = nsteps - st;  // halo of the source window
      const int sx = BX + 2 * hs, sy = BY + 2 * hs, sz = BZ + 2 * hs;
      const int dx = sx - 2, dy = sy - 2, dz = sz - 2;
      const int64_t svol = static_cast<int64_t>(sx) * sy * sz;
      const int64_t dvol = static_cast<int64_t>(dx) * dy * dz;
      const bool last = st == nsteps - 1;
      for (int64_t i = threadIdx.x; i < svol; i += blockDim.x) {
        const int lz = static_cast<int>(i % sz);
        const int64_t li = i / sz;
        const int ly = static_cast<int>(li % sy);
        const int lx = static_cast<int>(li / sy);
        T f[LB_NVEL];
        if (src == nullptr) {
          const int64_t g =
              (static_cast<int64_t>(wrapn(x0 - hs + lx, X)) * Y +
               wrapn(y0 - hs + ly, Y)) * Z +
              wrapn(z0 - hs + lz, Z);
#pragma unroll
          for (int q = 0; q < LB_NVEL; ++q) f[q] = fin[q * nsite + g];
        } else {
#pragma unroll
          for (int q = 0; q < LB_NVEL; ++q) f[q] = src[q * svol + i];
        }
        auto emit = [&](int q, int cx, int cy, int cz, T v) {
          // destination in the next window (one site narrower per side)
          const int ax = lx + cx - 1, ay = ly + cy - 1, az = lz + cz - 1;
          if (ax < 0 || ax >= dx || ay < 0 || ay >= dy || az < 0 ||
              az >= dz)
            return;
          if (last) {
            const int gx = x0 + ax, gy = y0 + ay, gz = z0 + az;
            if (gx < X && gy < Y && gz < Z)  // ragged edge tiles
              fout[q * nsite +
                   (static_cast<int64_t>(gx) * Y + gy) * Z + gz] = v;
          } else {
            dst[q * dvol + (static_cast<int64_t>(ax) * dy + ay) * dz + az] =
                v;
          }
        };
        lb_collide<T, DELTA, PROJ>(f, nullptr, p, emit);
      }
      __syncthreads();
      src = dst;
      dst = dst == bufA ? bufB : bufA;
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

template <typename T, int DELTA, int PROJ>
static int launch_stepn(const void* fin, void* fout, int X, int Y, int Z,
                        int nsteps, int BX, int BY, int BZ, void* scratch,
                        long long per_block, int grid, int smem,
                        const double* par, cudaStream_t stream) {
  auto kernel = fusedn_step_kernel<T, DELTA, PROJ>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(fin), static_cast<T*>(fout), X, Y, Z, nsteps, BX,
      BY, BZ, static_cast<T*>(scratch), per_block, make_params<T>(par));
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
                   int grid, int smem, const double* par, void* stream,
                   int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LB_DISPATCH(launch_stepn, fin, fout, X, Y, Z, nsteps, BX, BY, BZ, scratch,
              per_block, grid, smem, par, s);
}

int lb_fused_force_step(int is_f64, int proj, const void* fin,
                        const void* force, void* fout, void* uout, int X,
                        int Y, int Z, const double* par, void* stream,
                        int device) {
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
}

int lb_force_step_blocks(long long nsite) {
  return static_cast<int>((nsite + kThreads - 1) / kThreads);
}

int lb_fused_force_step_solid(int is_f64, int proj, const void* fin,
                              const void* force, const void* solid,
                              void* fout, void* uout, void* part, void* gw,
                              int X, int Y, int Z, const double* par,
                              void* stream, int device) {
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
}

}  // extern "C"
