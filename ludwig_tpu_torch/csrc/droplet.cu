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
// The kernel does more: it recomputes the site's gradients in phase B and
// runs without FMA (-fmad=false).  The TPU kernel computed level 1 on a
// (BX+2, BY+2, Z) slab in VMEM.  Here one block owns a (BX, BY, BZ) tile,
// as csrc/lc_q.cu does: phase A evaluates level 1 once for every site of
// the tile and its halo of 1, strided over the block's threads, and keeps
// what the neighbours read (mu, the nine stress components) in shared
// memory, with the tile's own nine h values; after one barrier, phase B
// forms each site's force, phi' and q5' from the shared values and from
// phi, q5 and u read through the caches.  Level 1 is so recomputed only
// on the halo ((BX+2)(BY+2)(BZ+2) / (BX BY BZ): 1.66x for 8x8x32), not at
// every neighbour of every site (7x).  The f32 tile takes 205 KB of the
// 227 KB opt-in; f64 takes a smaller tile to fit.
//
// Offsets are 64-bit; coordinates wrap with a true modulo, so an axis
// shorter than the tile or the stencil still wraps periodically (the edge
// neighbours of d_a d_b phi wrap on each axis alone), and a tile that
// overhangs the lattice computes its overhang on wrapped sites and stores
// nothing for it.

#include <cuda_runtime.h>
#include <stdint.h>

// select(x, p, q) of the generated code: p where x > 0 (strictly)
template <typename T>
__device__ __forceinline__ T sel(T x, T p, T q) {
  return x > T(0) ? p : q;
}

#include "droplet_generated.h"

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
  // mu and pth[9] on the level-1 sites, h[9] on the tile's
  static constexpr size_t SMEM = sizeof(T) * (10 * NW + 9 * NT);
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

template <typename T, int ORDER>
__global__ void __launch_bounds__(Tile<T>::THREADS)
droplet_kernel(const T* __restrict__ phi, const T* __restrict__ q,
               const T* __restrict__ u, T* __restrict__ phi_out,
               T* __restrict__ q_out, T* __restrict__ force, int X, int Y,
               int Z, DropletParams<T> p) {
  using TL = Tile<T>;
  using SH = Shape<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_mu = reinterpret_cast<T*>(smem_raw);    // [NW]
  T* s_pth = s_mu + SH::NW;                    // [9][NW]
  T* s_h = s_pth + 9 * SH::NW;                 // [9][NT]

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
    auto P = [&](int dx, int dy, int dz) -> T {
      return phi[xo[dx + 1] + yo[dy + 1] + zo[dz + 1]];
    };
    auto Q = [&](int n, int dx, int dy, int dz) -> T {
      return q[n * nsite + xo[dx + 1] + yo[dy + 1] + zo[dz + 1]];
    };
    T mu[1], pth[9], h[9];
    droplet_level1<T>(P, Q, p, mu, pth, h);
    s_mu[i] = mu[0];
#pragma unroll
    for (int k = 0; k < 9; ++k) s_pth[k * SH::NW + i] = pth[k];
    if (lx >= 1 && lx <= TL::BX && ly >= 1 && ly <= TL::BY && lz >= 1 &&
        lz <= TL::BZ) {
      const int t = ((lx - 1) * TL::BY + (ly - 1)) * TL::BZ + (lz - 1);
#pragma unroll
      for (int k = 0; k < 9; ++k) s_h[k * SH::NT + t] = h[k];
    }
  }
  __syncthreads();

  // phase B: force, Cahn-Hilliard and Beris-Edwards updates
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
    auto P = [&](int dx, int dy, int dz) -> T {
      return phi[xo[dx + 1] + yo[dy + 1] + zo[dz + 1]];
    };
    auto Q = [&](int n, int dx, int dy, int dz) -> T {
      return q[n * nsite + xo[dx + 1] + yo[dy + 1] + zo[dz + 1]];
    };
    auto U = [&](int a, int dx, int dy, int dz) -> T {
      return u[a * nsite + xo[dx + 1] + yo[dy + 1] + zo[dz + 1]];
    };
    auto W = [&](int dx, int dy, int dz) -> int {
      return ((lx + 1 + dx) * SH::WY + (ly + 1 + dy)) * SH::WZ +
             (lz + 1 + dz);
    };
    auto MU = [&](int dx, int dy, int dz) -> T { return s_mu[W(dx, dy, dz)]; };
    auto S = [&](int a, int b, int dx, int dy, int dz) -> T {
      return s_pth[(3 * a + b) * SH::NW + W(dx, dy, dz)];
    };
    auto H = [&](int b, int c) -> T { return s_h[(3 * b + c) * SH::NT + t]; };
    T out[9];
    if constexpr (ORDER == 1) {
      droplet_site_o1<T>(P, Q, U, MU, S, H, p, out);
    } else {
      droplet_site_o2<T>(P, Q, U, MU, S, H, p, out);
    }
    const int64_t s = xo[1] + yo[1] + zo[1];
    phi_out[s] = out[0];
#pragma unroll
    for (int n = 0; n < 5; ++n) q_out[n * nsite + s] = out[1 + n];
#pragma unroll
    for (int a = 0; a < 3; ++a) force[a * nsite + s] = out[6 + a];
  }
}

template <typename T, int ORDER>
static int launch(const void* phi, const void* q, const void* u,
                  void* phi_out, void* q_out, void* force, int X, int Y,
                  int Z, const double* par, cudaStream_t stream) {
  using TL = Tile<T>;
  DropletParams<T> p;
  for (int k = 0; k < DROPLET_NCONST; ++k) p.c[k] = static_cast<T>(par[k]);
  const cudaError_t e = cudaFuncSetAttribute(
      droplet_kernel<T, ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Shape<T>::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Z + TL::BZ - 1) / TL::BZ, (Y + TL::BY - 1) / TL::BY,
                  (X + TL::BX - 1) / TL::BX);
  droplet_kernel<T, ORDER><<<grid, TL::THREADS, Shape<T>::SMEM, stream>>>(
      static_cast<const T*>(phi), static_cast<const T*>(q),
      static_cast<const T*>(u), static_cast<T*>(phi_out),
      static_cast<T*>(q_out), static_cast<T*>(force), X, Y, Z, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_order(int order, const void* phi, const void* q,
                        const void* u, void* phi_out, void* q_out,
                        void* force, int X, int Y, int Z, const double* par,
                        cudaStream_t stream) {
  if (order == 1)
    return launch<T, 1>(phi, q, u, phi_out, q_out, force, X, Y, Z, par,
                        stream);
  if (order == 2)
    return launch<T, 2>(phi, q, u, phi_out, q_out, force, X, Y, Z, par,
                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" {

// the length of the constant table the library was generated with
int lb_droplet_nconst() { return DROPLET_NCONST; }

// par = the constant table p.c[] in double (ops/_cuda.py
// droplet_const_values); order = the advection order, 1 or 2
int lb_droplet_phi_q_force(int is_f64, int order, const void* phi,
                           const void* q, const void* u, void* phi_out,
                           void* q_out, void* force, int X, int Y, int Z,
                           const double* par, void* stream, int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_order<double>(order, phi, q, u, phi_out, q_out,
                                       force, X, Y, Z, par, s)
                : launch_order<float>(order, phi, q, u, phi_out, q_out,
                                      force, X, Y, Z, par, s);
}

}  // extern "C"
