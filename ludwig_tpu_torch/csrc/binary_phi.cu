// Binary-fluid order-parameter kernel for Hopper (sm_90a), f32/f64.
//
// Replaces the Pallas TPU kernel _binary_kernel of
// ludwig_tpu/ops/fused_binary.py:49 (K1 of the fused binary step):
// phi, u -> phi', force.  Per site, with a periodic halo of radius 2:
//   - level 1, at the site and its 6 neighbours: the 7-point gradient and
//     Laplacian of phi, mu = A phi + B phi^3 - kappa del^2 phi and the
//     symmetric stress pth[a][b] = p0 delta_ab + kappa g_a g_b;
//   - force = -div P by central differences of the neighbours' stress;
//   - the flux-form Cahn-Hilliard update: per axis the east face flux at
//     i and at i - e (face velocity 0.5 (u_i + u_{i+e}); order-1 upwind,
//     strictly u_face > 0, or order-2 centred advection; minus
//     M (mu_{i+e} - mu_i)), phi' = phi - sum (flux_i - flux_{i-e}).
// The per-site arithmetic is binary_generated.h, straight-line code
// generated at build time from the twin's Python (ops/fused_binary.py
// _level1_march / _binary_site, traced by ops/_cuda.py), so kernel and
// twin evaluate one expression tree.
//
// Bound on this card: memory.  The function reads phi and u and writes
// phi' and the force, 8 values a site (32 B in f32), against about 130
// operations a site with level 1 evaluated once (ops/_cuda.site_ops),
// ~4 flop/B, below the H100's ~20 flop/B balance point in f32.  The TPU
// kernel kept a block with its radius-2 halo in VMEM and evaluated level
// 1 once on a (BX+2, BY+2) region.  Here a block marches along x over a
// y-z tile (csrc/k1_march.cuh, as the LC and droplet K1 kernels do): phi
// is staged plane by plane with a y-z halo of 2 and u with a halo of 1,
// the next plane in flight by cp.async while one computes; level 1 is
// evaluated once per site of the cross-shaped window the site updates
// read (about 1.3 evaluations a site), keeping pth[:,0] and mu over three
// planes and pth[:,1], pth[:,2] and mu on the plane's faces; the site
// update reads shared memory alone.  With one staged field and no
// molecular field a block's buffers are small (52,656 B at 8x32 f32), so
// several blocks share an SM to keep loads in flight.  What holds the
// march on an H100 is its instruction stream, not bytes: the index and
// address arithmetic of its shared-memory loads is as large as the
// arithmetic (PERF.md).  The tile, segment and thread count come from
// ops/_cuda.py k1_layout; tests/test_torch_k1_layout.py holds a torch
// march of the same buffers bitwise the twin on the CPU, chip_smoke.py
// phases 7 and 9 hold and time the kernel on the card.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
struct BinParams {
  T a, b, kappa, mob;   // free energy A, B, kappa; mobility M
  T ha, b34, hk;        // 0.5 A, 0.75 B, 0.5 kappa, folded on the host
};

// select(x, p, q) of the generated code: p where x > 0 (strictly)
template <typename T>
__device__ __forceinline__ T sel(T x, T p, T q) {
  return x > T(0) ? p : q;
}

#include "binary_generated.h"
#include "k1_march.cuh"

constexpr int BIN_NS = 1, BIN_NH = 0;   // staged phi; no molecular field

template <typename T, int ORDER>
__global__ void __launch_bounds__(k1::MaxThreads<T>::value)
binary_phi_force_kernel(const T* __restrict__ phi, const T* __restrict__ u,
                        T* __restrict__ phi_out, T* __restrict__ force,
                        k1::Geom g, BinParams<T> p) {
  const int64_t nsite = static_cast<int64_t>(g.X) * g.Y * g.Z;
  const T* src[BIN_NS] = {phi};
  auto level1 = [&](const auto& F, T* mu, T* pth, T* /* h */) {
    auto P = [&](int dx, int dy, int dz) -> T { return F(0, dx, dy, dz); };
    binary_level1<T>(P, p, mu, pth);
  };
  auto site = [&](const auto& F, const auto& U, const auto& S,
                  const auto& MU, const auto& /* HK */, int64_t s) {
    auto P = [&](int dx, int dy, int dz) -> T { return F(0, dx, dy, dz); };
    T out[4];
    if constexpr (ORDER == 1) {
      binary_site_o1<T>(P, U, S, MU, p, out);
    } else {
      binary_site_o2<T>(P, U, S, MU, p, out);
    }
    phi_out[s] = out[0];
#pragma unroll
    for (int a = 0; a < 3; ++a) force[a * nsite + s] = out[1 + a];
  };
  k1::march<T, BIN_NS, BIN_NH, true>(g, src, u, level1, site);
}

template <typename T>
static BinParams<T> make_params(const double* par) {
  BinParams<T> p;
  p.a = static_cast<T>(par[0]);
  p.b = static_cast<T>(par[1]);
  p.kappa = static_cast<T>(par[2]);
  p.mob = static_cast<T>(par[3]);
  p.ha = static_cast<T>(par[4]);
  p.b34 = static_cast<T>(par[5]);
  p.hk = static_cast<T>(par[6]);
  return p;
}

// lay = BX, BY, threads, shared bytes (ops/_cuda.py k1_layout)
template <typename T, int ORDER>
static int launch(const void* phi, const void* u, void* phi_out,
                  void* force, int X, int Y, int Z, const double* par,
                  const int* lay, cudaStream_t stream) {
  return k1::launch<T, BIN_NS, BIN_NH, true>(
      binary_phi_force_kernel<T, ORDER>, X, Y, Z, lay, make_params<T>(par),
      stream, static_cast<const T*>(phi), static_cast<const T*>(u),
      static_cast<T*>(phi_out), static_cast<T*>(force));
}

extern "C" {

// out[0..4): the kernel's registers a thread, (threads > 0) the blocks an
// SM the card keeps resident with `smem` bytes each, the card's
// multiprocessors and shared-memory opt-in; order = the advection order,
// 1 or 2
int lb_binary_attrs(int is_f64, int order, int device, int threads,
                    int smem, int* out) {
  if (order == 1)
    return is_f64 ? k1::attrs(binary_phi_force_kernel<double, 1>, device,
                              threads, smem, out)
                  : k1::attrs(binary_phi_force_kernel<float, 1>, device,
                              threads, smem, out);
  if (order == 2)
    return is_f64 ? k1::attrs(binary_phi_force_kernel<double, 2>, device,
                              threads, smem, out)
                  : k1::attrs(binary_phi_force_kernel<float, 2>, device,
                              threads, smem, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// par = [A, B, kappa, M, 0.5 A, 0.75 B, 0.5 kappa]; order = the advection
// order, 1 or 2; lay = BX, BY, threads, shared bytes (ops/_cuda.py
// k1_layout)
int lb_binary_phi_force(int is_f64, int order, const void* phi,
                        const void* u, void* phi_out, void* force, int X,
                        int Y, int Z, const double* par, const int* lay,
                        void* stream, int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (order == 1)
    return is_f64 ? launch<double, 1>(phi, u, phi_out, force, X, Y, Z, par,
                                      lay, s)
                  : launch<float, 1>(phi, u, phi_out, force, X, Y, Z, par,
                                     lay, s);
  if (order == 2)
    return is_f64 ? launch<double, 2>(phi, u, phi_out, force, X, Y, Z, par,
                                      lay, s)
                  : launch<float, 2>(phi, u, phi_out, force, X, Y, Z, par,
                                     lay, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
