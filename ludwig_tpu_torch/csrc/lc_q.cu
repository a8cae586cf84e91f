// Liquid-crystal Q-tensor kernel for Hopper (sm_90a), f32/f64.
//
// Replaces the Pallas TPU kernel _lc_kernel of
// ludwig_tpu/ops/fused_lc.py:63 (K1 of the fused blue-phase step):
// q5, u -> q5', force.  Per site, with a periodic halo of radius 2:
//   - level 1, at the site and its 6 neighbours: the 7-point gradient and
//     Laplacian of the five Q components, the Landau-de Gennes molecular
//     field h and the stress pth (9 components, not symmetric; the active
//     stress is always added: with both zetas zero it is an exact zero);
//   - force_a = -sum_ax 0.5 (pth[a][ax](+e_ax) - pth[a][ax](-e_ax));
//   - the Beris-Edwards update: W_ab from central differences of u with
//     the trace removed, the corotation S(W, Q), order-1 upwind face
//     fluxes of each Q component (strictly u_face > 0),
//     q5' = q5 + Gamma h + S - div flux.
// The per-site arithmetic is lc_generated.h, straight-line code generated
// at build time from the twin's Python (ops/fused_lc.py _level1 /
// _lc_site, which call fe/blue_phase.py; traced by ops/_cuda.py), so
// kernel and twin evaluate one expression tree.  Its constants are a
// table p.c[], products of the parameters folded on the host in double.
//
// Bound on this card: bytes, narrowly.  The function reads q5 and u and
// writes q5' and the force, 16 values a site (64 B in f32), against about
// 1 140 distinct operations a site with level-1 values computed once and
// the free energy in its factored form (ops/_cuda.site_ops): ~18 flop/B,
// just under the H100's ~20 flop/B balance point in f32.  The generated
// code keeps the JAX package's term order instead: about 1 180 distinct
// operations for one level-1 evaluation and 360 for the site update, none
// of them fused (-fmad=false), so arithmetic is what it waits for, not
// memory.  The TPU kernel computed level 1 on a (BX+2, BY+2, Z)
// slab in VMEM.  Here one block owns a (BX, BY, BZ) tile: phase A
// evaluates level 1 once for every site of the tile and its halo of 1,
// strided over the block's threads, and keeps the stress in shared
// memory (and h5 of the tile's own sites); after one barrier, phase B
// forms each site's force from the shared stress and updates Q from q5
// and u read through the caches.  Level 1 is so recomputed only on the
// halo ((BX+2)(BY+2)(BZ+2) / (BX BY BZ): 1.66x for 8x8x32), not at every
// neighbour of every site (7x).  The stress tile needs the opt-in above
// 48 KB of shared memory; f64 takes a smaller tile to fit.
//
// Offsets are 64-bit; coordinates wrap with a true modulo, so an axis
// shorter than the tile or the stencil still wraps periodically, and a
// tile that overhangs the lattice computes its overhang on wrapped sites
// and stores nothing for it.

#include <cuda_runtime.h>
#include <stdint.h>

// select(x, p, q) of the generated code: p where x > 0 (strictly)
template <typename T>
__device__ __forceinline__ T sel(T x, T p, T q) {
  return x > T(0) ? p : q;
}

#include "lc_generated.h"

// one block's tile and thread count
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int BX = 8, BY = 8, BZ = 32, THREADS = 512;
};
template <>
struct Tile<double> {
  static constexpr int BX = 4, BY = 4, BZ = 32, THREADS = 256;
};

template <typename T>
struct Shape {
  using TL = Tile<T>;
  static constexpr int WX = TL::BX + 2, WY = TL::BY + 2, WZ = TL::BZ + 2;
  static constexpr int NW = WX * WY * WZ;              // level-1 sites
  static constexpr int NT = TL::BX * TL::BY * TL::BZ;  // tile sites
  static constexpr size_t SMEM = sizeof(T) * (9 * NW + 5 * NT);
};

__device__ __forceinline__ int64_t wrapn(int64_t i, int64_t n) {
  const int64_t r = i % n;
  return r < 0 ? r + n : r;
}

// element offsets of the coordinates c-1, c, c+1 (c in [0, n)) times stride
__device__ __forceinline__ void offsets3(int64_t c, int64_t n, int64_t stride,
                                         int64_t* o) {
  o[0] = (c == 0 ? n - 1 : c - 1) * stride;
  o[1] = c * stride;
  o[2] = (c + 1 == n ? 0 : c + 1) * stride;
}

template <typename T>
__global__ void __launch_bounds__(Tile<T>::THREADS)
lc_q_force_kernel(const T* __restrict__ q, const T* __restrict__ u,
                  T* __restrict__ q_out, T* __restrict__ force, int X, int Y,
                  int Z, LcParams<T> p) {
  using TL = Tile<T>;
  using SH = Shape<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_pth = reinterpret_cast<T*>(smem_raw);   // [9][NW]
  T* s_h = s_pth + 9 * SH::NW;                 // [5][NT]

  const int64_t nsite = static_cast<int64_t>(X) * Y * Z;
  const int64_t x0 = static_cast<int64_t>(blockIdx.z) * TL::BX;
  const int64_t y0 = static_cast<int64_t>(blockIdx.y) * TL::BY;
  const int64_t z0 = static_cast<int64_t>(blockIdx.x) * TL::BZ;

  // phase A: level 1 on the tile and its halo of 1
  for (int i = threadIdx.x; i < SH::NW; i += TL::THREADS) {
    const int lz = i % SH::WZ;
    const int ly = (i / SH::WZ) % SH::WY;
    const int lx = i / (SH::WZ * SH::WY);
    int64_t xo[3], yo[3], zo[3];
    offsets3(wrapn(x0 + lx - 1, X), X, static_cast<int64_t>(Y) * Z, xo);
    offsets3(wrapn(y0 + ly - 1, Y), Y, Z, yo);
    offsets3(wrapn(z0 + lz - 1, Z), Z, 1, zo);
    auto Q = [&](int n, int dx, int dy, int dz) -> T {
      return q[n * nsite + xo[dx + 1] + yo[dy + 1] + zo[dz + 1]];
    };
    T pth[9], h5[5];
    lc_level1<T>(Q, p, pth, h5);
#pragma unroll
    for (int k = 0; k < 9; ++k) s_pth[k * SH::NW + i] = pth[k];
    if (lx >= 1 && lx <= TL::BX && ly >= 1 && ly <= TL::BY && lz >= 1 &&
        lz <= TL::BZ) {
      const int t = ((lx - 1) * TL::BY + (ly - 1)) * TL::BZ + (lz - 1);
#pragma unroll
      for (int n = 0; n < 5; ++n) s_h[n * SH::NT + t] = h5[n];
    }
  }
  __syncthreads();

  // phase B: force from the shared stress, Beris-Edwards update of Q
  for (int t = threadIdx.x; t < SH::NT; t += TL::THREADS) {
    const int lz = t % TL::BZ;
    const int ly = (t / TL::BZ) % TL::BY;
    const int lx = t / (TL::BZ * TL::BY);
    const int64_t x = x0 + lx, y = y0 + ly, z = z0 + lz;
    if (x >= X || y >= Y || z >= Z) continue;
    int64_t xo[3], yo[3], zo[3];
    offsets3(x, X, static_cast<int64_t>(Y) * Z, xo);
    offsets3(y, Y, Z, yo);
    offsets3(z, Z, 1, zo);
    auto Q = [&](int n, int dx, int dy, int dz) -> T {
      return q[n * nsite + xo[dx + 1] + yo[dy + 1] + zo[dz + 1]];
    };
    auto U = [&](int a, int dx, int dy, int dz) -> T {
      return u[a * nsite + xo[dx + 1] + yo[dy + 1] + zo[dz + 1]];
    };
    auto S = [&](int a, int b, int dx, int dy, int dz) -> T {
      return s_pth[(3 * a + b) * SH::NW +
                   ((lx + 1 + dx) * SH::WY + (ly + 1 + dy)) * SH::WZ +
                   (lz + 1 + dz)];
    };
    auto H = [&](int n) -> T { return s_h[n * SH::NT + t]; };
    T out[8];
    lc_site<T>(Q, U, S, H, p, out);
    const int64_t s = xo[1] + yo[1] + zo[1];
#pragma unroll
    for (int n = 0; n < 5; ++n) q_out[n * nsite + s] = out[n];
#pragma unroll
    for (int a = 0; a < 3; ++a) force[a * nsite + s] = out[5 + a];
  }
}

template <typename T>
static int launch(const void* q, const void* u, void* q_out, void* force,
                  int X, int Y, int Z, const double* par,
                  cudaStream_t stream) {
  using TL = Tile<T>;
  LcParams<T> p;
  for (int k = 0; k < LC_NCONST; ++k) p.c[k] = static_cast<T>(par[k]);
  const cudaError_t e = cudaFuncSetAttribute(
      lc_q_force_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Shape<T>::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Z + TL::BZ - 1) / TL::BZ, (Y + TL::BY - 1) / TL::BY,
                  (X + TL::BX - 1) / TL::BX);
  lc_q_force_kernel<T><<<grid, TL::THREADS, Shape<T>::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(u),
      static_cast<T*>(q_out), static_cast<T*>(force), X, Y, Z, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// the length of the constant table the library was generated with
int lb_lc_nconst() { return LC_NCONST; }

// par = the constant table p.c[] in double (ops/_cuda.py lc_const_values)
int lb_lc_q_force(int is_f64, const void* q, const void* u, void* q_out,
                  void* force, int X, int Y, int Z, const double* par,
                  void* stream, int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(q, u, q_out, force, X, Y, Z, par, s)
                : launch<float>(q, u, q_out, force, X, Y, Z, par, s);
}

}  // extern "C"
