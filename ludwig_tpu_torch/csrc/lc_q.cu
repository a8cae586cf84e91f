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
// memory.  The TPU kernel computed level 1 on a (BX+2, BY+2, Z) slab in
// VMEM.  Here a block marches along x over a y-z tile (csrc/k1_march.cuh):
// q5 and u are staged plane by plane in shared memory, the next plane in
// flight while one computes; level 1 is evaluated once per site of the
// cross-shaped window the site updates read (the tile and its four y-z
// faces), keeping only what crosses sites (pth[:,0] over three planes,
// pth[:,1] and pth[:,2] on the plane's faces, h on the tile); the site
// update reads shared memory alone.  About 1.2-1.5 level-1 evaluations a
// site, against 1.66 for the earlier box of 8x8x32 with a halo of 1.
// The tile, segment and thread count come from ops/_cuda.py k1_layout.

#include <cuda_runtime.h>
#include <stdint.h>

// select(x, p, q) of the generated code: p where x > 0 (strictly)
template <typename T>
__device__ __forceinline__ T sel(T x, T p, T q) {
  return x > T(0) ? p : q;
}

#include "k1_march.cuh"
#include "lc_generated.h"

constexpr int LC_NS = 5, LC_NH = 5;   // staged q5; h in 5-component form

template <typename T>
__global__ void __launch_bounds__(k1::MaxThreads<T>::value)
lc_q_force_kernel(const T* __restrict__ q, const T* __restrict__ u,
                  T* __restrict__ q_out, T* __restrict__ force, k1::Geom g,
                  LcParams<T> p) {
  const int64_t nsite = static_cast<int64_t>(g.X) * g.Y * g.Z;
  const T* src[LC_NS];
#pragma unroll
  for (int n = 0; n < LC_NS; ++n) src[n] = q + n * nsite;
  auto level1 = [&](const auto& F, T* mu, T* pth, T* h) {
    (void)mu;
    auto Q = [&](int n, int dx, int dy, int dz) -> T {
      return F(n, dx, dy, dz);
    };
    lc_level1<T>(Q, p, pth, h);
  };
  auto site = [&](const auto& F, const auto& U, const auto& S,
                  const auto& MU, const auto& HK, int64_t s) {
    (void)MU;
    auto Q = [&](int n, int dx, int dy, int dz) -> T {
      return F(n, dx, dy, dz);
    };
    T out[8];
    lc_site<T>(Q, U, S, HK, p, out);
#pragma unroll
    for (int n = 0; n < 5; ++n) q_out[n * nsite + s] = out[n];
#pragma unroll
    for (int a = 0; a < 3; ++a) force[a * nsite + s] = out[5 + a];
  };
  k1::march<T, LC_NS, LC_NH, false>(g, src, u, level1, site);
}

// lay = BX, BY, threads, shared bytes (ops/_cuda.py k1_layout)
template <typename T>
static int launch(const void* q, const void* u, void* q_out, void* force,
                  int X, int Y, int Z, const double* par, const int* lay,
                  cudaStream_t stream) {
  LcParams<T> p;
  for (int k = 0; k < LC_NCONST; ++k) p.c[k] = static_cast<T>(par[k]);
  return k1::launch<T, LC_NS, LC_NH, false>(
      lc_q_force_kernel<T>, X, Y, Z, lay, p, stream,
      static_cast<const T*>(q), static_cast<const T*>(u),
      static_cast<T*>(q_out), static_cast<T*>(force));
}

extern "C" {

// the length of the constant table the library was generated with
int lb_lc_nconst() { return LC_NCONST; }

// out[0..4): the kernel's registers a thread, (threads > 0) the blocks an
// SM the card keeps resident with `smem` bytes each, the card's
// multiprocessors and shared-memory opt-in
int lb_lc_attrs(int is_f64, int device, int threads, int smem, int* out) {
  return is_f64
             ? k1::attrs(lc_q_force_kernel<double>, device, threads, smem, out)
             : k1::attrs(lc_q_force_kernel<float>, device, threads, smem, out);
}

// par = the constant table p.c[] in double (ops/_cuda.py lc_const_values);
// lay = BX, BY, threads, shared bytes (ops/_cuda.py k1_layout)
int lb_lc_q_force(int is_f64, const void* q, const void* u, void* q_out,
                  void* force, int X, int Y, int Z, const double* par,
                  const int* lay, void* stream, int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(q, u, q_out, force, X, Y, Z, par, lay, s)
                : launch<float>(q, u, q_out, force, X, Y, Z, par, lay, s);
}

}  // extern "C"
