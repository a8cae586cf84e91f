// Binary-fluid order-parameter kernel for Hopper (sm_90a), f32/f64.
//
// Replaces the Pallas TPU kernel _binary_kernel of
// ludwig_tpu/ops/fused_binary.py:49 (K1 of the fused binary step):
// phi, u -> phi', force.  Per site, with a periodic halo of radius 2:
//   - at the site and its 6 neighbours, the 7-point gradient and
//     Laplacian of phi, mu = A phi + B phi^3 - kappa del^2 phi and the
//     isotropic part p0 of the symmetric stress;
//   - force = -div P by central differences of the neighbours' stress;
//   - the flux-form Cahn-Hilliard update: per axis the east face flux at
//     i and at i - e (face velocity 0.5 (u_i + u_{i+e}); order-1 upwind,
//     strictly u_face > 0, or order-2 centred advection; minus
//     M (mu_{i+e} - mu_i)), phi' = phi - sum (flux_i - flux_{i-e}).
// The per-site arithmetic is binary_generated.h, straight-line code
// generated at build time from the twin's Python (ops/fused_binary.py
// _level1 / _binary_site, traced by ops/_cuda.py), so kernel and twin
// evaluate one expression tree.
//
// Bound on this card: memory.  The function reads phi and u and writes
// phi' and the force, 8 values per site (32 B in f32), against ~5 flop/B
// of arithmetic with level-1 values computed once per site (159 flop in
// order 2) - below the H100's ~20 flop/B balance point in f32.  The TPU
// kernel kept a block with its radius-2 halo in VMEM.  This first kernel
// is one thread per
// site (z fastest, so neighbouring threads read neighbouring addresses):
// the thread loads the 25 phi values of its radius-2 stencil and 9 u
// values through the caches, and recomputes the level-1 values of its 6
// neighbours instead of sharing them (375 flop a site, 2.4x the bound's
// count).  The halo reloads hit L1/L2; a shared-memory tile with a
// radius-2 halo is the next step.
//
// Offsets are 64-bit; coordinates wrap with a true modulo, so an axis
// shorter than the stencil (extent < 3) still wraps periodically.

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

constexpr int kThreads = 256;

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

__device__ __forceinline__ int64_t wrapn(int64_t i, int64_t n) {
  const int64_t r = i % n;
  return r < 0 ? r + n : r;
}

template <typename T, int ORDER>
__global__ void __launch_bounds__(kThreads)
binary_phi_force_kernel(const T* __restrict__ phi, const T* __restrict__ u,
                        T* __restrict__ phi_out, T* __restrict__ force,
                        int X, int Y, int Z, BinParams<T> p) {
  const int64_t nsite = static_cast<int64_t>(X) * Y * Z;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (s >= nsite) return;
  const int64_t z = s % Z;
  const int64_t r = s / Z;
  const int64_t y = r % Y;
  const int64_t x = r / Y;
  // element offsets of the wrapped coordinates x-2..x+2 (and y, z)
  int64_t xo[5], yo[5], zo[5];
#pragma unroll
  for (int d = -2; d <= 2; ++d) {
    xo[d + 2] = wrapn(x + d, X) * Y * Z;
    yo[d + 2] = wrapn(y + d, Y) * Z;
    zo[d + 2] = wrapn(z + d, Z);
  }
  auto P = [&](int dx, int dy, int dz) -> T {
    return phi[xo[dx + 2] + yo[dy + 2] + zo[dz + 2]];
  };
  auto U = [&](int a, int dx, int dy, int dz) -> T {
    return u[a * nsite + xo[dx + 2] + yo[dy + 2] + zo[dz + 2]];
  };
  T out[4];
  if constexpr (ORDER == 1) {
    binary_site_o1<T>(P, U, p, out);
  } else {
    binary_site_o2<T>(P, U, p, out);
  }
  phi_out[s] = out[0];
#pragma unroll
  for (int a = 0; a < 3; ++a) force[a * nsite + s] = out[1 + a];
}

template <typename T, int ORDER>
static int launch(const void* phi, const void* u, void* phi_out,
                  void* force, int X, int Y, int Z, const double* par,
                  cudaStream_t stream) {
  const int64_t nsite = static_cast<int64_t>(X) * Y * Z;
  const int64_t blocks = (nsite + kThreads - 1) / kThreads;
  binary_phi_force_kernel<T, ORDER><<<static_cast<unsigned>(blocks),
                                      kThreads, 0, stream>>>(
      static_cast<const T*>(phi), static_cast<const T*>(u),
      static_cast<T*>(phi_out), static_cast<T*>(force), X, Y, Z,
      make_params<T>(par));
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// par = [A, B, kappa, M, 0.5 A, 0.75 B, 0.5 kappa]; order 1 or 2 (the
// wrapper checks it)
int lb_binary_phi_force(int is_f64, int order, const void* phi,
                        const void* u, void* phi_out, void* force, int X,
                        int Y, int Z, const double* par, void* stream,
                        int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return order == 1
               ? launch<double, 1>(phi, u, phi_out, force, X, Y, Z, par, s)
               : launch<double, 2>(phi, u, phi_out, force, X, Y, Z, par, s);
  }
  return order == 1
             ? launch<float, 1>(phi, u, phi_out, force, X, Y, Z, par, s)
             : launch<float, 2>(phi, u, phi_out, force, X, Y, Z, par, s);
}

}  // extern "C"
