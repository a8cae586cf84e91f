// Liquid-crystal droplet (coupled phi + Q) kernel for Hopper (sm_90a),
// f32/f64.
//
// Replaces the Pallas TPU kernel _droplet_kernel of
// ludwig_tpu/ops/fused_droplet.py:39 (K1 of the fused droplet step):
// phi, q5, u -> phi', q5', raw force.  Per site, with a periodic halo of
// radius 2:
//   - level 1, at the site and its 6 neighbours: the 7-point gradient and
//     Laplacian of phi and of the five Q components, d_a d_b phi (cross
//     differences on the 12 edge neighbours), gamma(phi) = gamma0 +
//     delta (1 + phi), the chemical potential mu, the molecular field h
//     (with gamma(phi) and the anchoring W term) and the qh stress pth (9
//     components; the active stress is always added: with both zetas zero
//     it is an exact zero);
//   - the raw force F_a = -phi d_a mu - h_bc d_a Q_bc - sum_b 0.5
//     (pth_ab(+e_b) - pth_ab(-e_b)); the caller subtracts its mean;
//   - the flux-form Cahn-Hilliard update of phi: order-1 upwind (strictly
//     u_face > 0) or order-2 centred advective face fluxes, each with the
//     diffusive flux mobility (mu difference);
//   - then Beris-Edwards: the molecular field again, with gamma(phi') and
//     the pre-update gradients, the corotation S(W, Q) and the advective
//     face fluxes of the same order, q5' = q5 + ((Gamma h5 + s5) - div).
// The per-site arithmetic is droplet_generated.h, straight-line code
// generated at build time from the twin's Python (ops/fused_droplet.py
// _fields / _level1 / _droplet_site, which call fe/lc_droplet.py; traced
// by ops/_cuda.py), so kernel and twin evaluate one expression tree.  Its
// constants are a table p.c[], products of the parameters folded on the
// host in double; gamma(phi) is per-site arithmetic.
//
// Bound on this card: bytes.  The function reads phi, q5 and u and writes
// phi', q5' and the force, 18 values a site (72 B in f32), against about
// 1 270-1 310 distinct operations a site with level 1 computed once and
// the site's fields kept (ops/_cuda.site_ops, the kernel text's own term
// order): ~18 flop/B, under the H100's ~20 flop/B balance point in f32.
// The kernel does more: it recomputes the site's gradients in the site
// update and runs without FMA (-fmad=false).  The TPU kernel computed
// level 1 on a (BX+2, BY+2, Z) slab in VMEM.  Here a block marches along x
// over a y-z tile, as csrc/lc_q.cu does (csrc/k1_march.cuh): phi, q5 and
// u are staged plane by plane in shared memory, the next plane in flight
// while one computes; level 1 is evaluated once per site of the
// cross-shaped window the site updates read, keeping what crosses sites
// (pth[:,0] and mu over three planes, pth[:,1], pth[:,2] and mu on the
// plane's faces, the tile's nine h values); the site update reads shared
// memory alone.  The edge neighbours of d_a d_b phi lie inside the staged
// halo of 2.  The tile, segment and thread count come from ops/_cuda.py
// k1_layout.

#include <cuda_runtime.h>
#include <stdint.h>

// select(x, p, q) of the generated code: p where x > 0 (strictly)
template <typename T>
__device__ __forceinline__ T sel(T x, T p, T q) {
  return x > T(0) ? p : q;
}

#include "droplet_generated.h"
#include "k1_march.cuh"

constexpr int DROP_NS = 6, DROP_NH = 9;   // staged phi and q5; h[3][3]

template <typename T, int ORDER>
__global__ void __launch_bounds__(k1::MaxThreads<T>::value)
droplet_kernel(const T* __restrict__ phi, const T* __restrict__ q,
               const T* __restrict__ u, T* __restrict__ phi_out,
               T* __restrict__ q_out, T* __restrict__ force, k1::Geom g,
               DropletParams<T> p) {
  const int64_t nsite = static_cast<int64_t>(g.X) * g.Y * g.Z;
  const T* src[DROP_NS];
  src[0] = phi;
#pragma unroll
  for (int n = 0; n < 5; ++n) src[1 + n] = q + n * nsite;
  auto level1 = [&](const auto& F, T* mu, T* pth, T* h) {
    auto P = [&](int dx, int dy, int dz) -> T { return F(0, dx, dy, dz); };
    auto Q = [&](int n, int dx, int dy, int dz) -> T {
      return F(1 + n, dx, dy, dz);
    };
    droplet_level1<T>(P, Q, p, mu, pth, h);
  };
  auto site = [&](const auto& F, const auto& U, const auto& S,
                  const auto& MU, const auto& HK, int64_t s) {
    auto P = [&](int dx, int dy, int dz) -> T { return F(0, dx, dy, dz); };
    auto Q = [&](int n, int dx, int dy, int dz) -> T {
      return F(1 + n, dx, dy, dz);
    };
    auto H = [&](int b, int c) -> T { return HK(3 * b + c); };
    T out[9];
    if constexpr (ORDER == 1) {
      droplet_site_o1<T>(P, Q, U, MU, S, H, p, out);
    } else {
      droplet_site_o2<T>(P, Q, U, MU, S, H, p, out);
    }
    phi_out[s] = out[0];
#pragma unroll
    for (int n = 0; n < 5; ++n) q_out[n * nsite + s] = out[1 + n];
#pragma unroll
    for (int a = 0; a < 3; ++a) force[a * nsite + s] = out[6 + a];
  };
  k1::march<T, DROP_NS, DROP_NH, true>(g, src, u, level1, site);
}

// lay = BX, BY, threads, shared bytes (ops/_cuda.py k1_layout)
template <typename T, int ORDER>
static int launch(const void* phi, const void* q, const void* u,
                  void* phi_out, void* q_out, void* force, int X, int Y,
                  int Z, const double* par, const int* lay,
                  cudaStream_t stream) {
  DropletParams<T> p;
  for (int k = 0; k < DROPLET_NCONST; ++k) p.c[k] = static_cast<T>(par[k]);
  return k1::launch<T, DROP_NS, DROP_NH, true>(
      droplet_kernel<T, ORDER>, X, Y, Z, lay, p, stream,
      static_cast<const T*>(phi), static_cast<const T*>(q),
      static_cast<const T*>(u), static_cast<T*>(phi_out),
      static_cast<T*>(q_out), static_cast<T*>(force));
}

extern "C" {

// the length of the constant table the library was generated with
int lb_droplet_nconst() { return DROPLET_NCONST; }

// out[0..4): the kernel's registers a thread, (threads > 0) the blocks an
// SM the card keeps resident with `smem` bytes each, the card's
// multiprocessors and shared-memory opt-in; order
// = the advection order, 1 or 2
int lb_droplet_attrs(int is_f64, int order, int device, int threads,
                     int smem, int* out) {
  if (order == 1)
    return is_f64 ? k1::attrs(droplet_kernel<double, 1>, device, threads,
                              smem, out)
                  : k1::attrs(droplet_kernel<float, 1>, device, threads,
                              smem, out);
  if (order == 2)
    return is_f64 ? k1::attrs(droplet_kernel<double, 2>, device, threads,
                              smem, out)
                  : k1::attrs(droplet_kernel<float, 2>, device, threads,
                              smem, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// par = the constant table p.c[] in double (ops/_cuda.py
// droplet_const_values); order = the advection order, 1 or 2; lay = BX,
// BY, threads, shared bytes (ops/_cuda.py k1_layout)
int lb_droplet_phi_q_force(int is_f64, int order, const void* phi,
                           const void* q, const void* u, void* phi_out,
                           void* q_out, void* force, int X, int Y, int Z,
                           const double* par, const int* lay, void* stream,
                           int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (order == 1)
    return is_f64 ? launch<double, 1>(phi, q, u, phi_out, q_out, force, X,
                                      Y, Z, par, lay, s)
                  : launch<float, 1>(phi, q, u, phi_out, q_out, force, X, Y,
                                     Z, par, lay, s);
  if (order == 2)
    return is_f64 ? launch<double, 2>(phi, q, u, phi_out, q_out, force, X,
                                      Y, Z, par, lay, s)
                  : launch<float, 2>(phi, q, u, phi_out, q_out, force, X, Y,
                                     Z, par, lay, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
