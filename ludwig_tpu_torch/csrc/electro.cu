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
// one persistent cooperative launch (grid = resident blocks, found by the
// occupancy query) that walks the lattice grid-stride and separates
// half-sweeps by grid-wide barriers.  A half-sweep reads psi from one
// buffer and writes every site of the other (its colour updated, the rest
// copied): with an odd periodic extent two sites of one colour are
// neighbours across the wrap, and the residual must come from the
// pre-sweep field, as in the JAX package.  Residual sums are per-block
// partials reduced by every block in one fixed order, so all blocks take
// the same stop decision; they are formed only at check iterations
// (n % 5 == 0) and at the last allowed one, where the solve can stop or
// report.  At 128^3 f32 psi, its second buffer and rhs (24 MB) sit in the
// H100's 50 MB L2, so the sweeps run from L2.  Bound: per iteration the
// function reads psi and rhs and writes psi in each half-sweep (24 B/site
// in f32) against ~16 operations a site; memory.
//
// np_gradmu_kernel.  One thread per site.  The thread forms its site's
// force from rho_el and the centred psi difference, and for each species
// the flux through each of its six faces; the flux through a face is the
// same expression in the two threads that share it, so they compute the
// same bits, and nothing is written twice.  The per-block partial sums of
// the force go to a second one-block launch (reduce_partials_kernel) in a
// fixed order: fsum is deterministic.  No output double buffer: the DMA
// race of the TPU kernel (ADVICE.md:3) has no counterpart.  Bound: memory,
// psi, rho_k, u and the uint8 mask read once, rho'_k and the force
// written once (45 B/site in f32 with two species).
//
// Site indices are int32 (the wrappers refuse X*Y*Z, and in
// np_gradmu_kernel max(nk, 3) * X*Y*Z, beyond 2^31 - 1); the grid-stride
// loops count in 64 bits so that the last stride cannot overflow.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// One half-sweep over this thread's sites s = first, first + stride, ...:
// sites of `colour` get p + omega res / denom with res = eps (x- + x+ +
// y- + y+ + z- + z+ - 6 p) + rhs, the others are copied; returns the
// thread's sum of res^2.  The coordinates advance by the stride's
// (dx, dy, dz) with carries, instead of four integer divisions a site.
template <typename T>
__device__ __forceinline__ T sor_half(const T* src, T* dst,
                                      const T* __restrict__ rhs, int colour,
                                      T omega, int X, int Y, int Z, T eps,
                                      T denom, int first, int stride,
                                      int nsite) {
  const int YZ = Y * Z;
  const int dz = stride % Z, dy = (stride / Z) % Y, dx = stride / YZ;
  int z = first % Z, y = (first / Z) % Y, x = first / YZ;
  T acc = T(0);
  for (int64_t s64 = first; s64 < nsite; s64 += stride) {
    const int s = static_cast<int>(s64);
    const T p = src[s];
    if (((x + y + z) & 1) != colour) {
      dst[s] = p;
    } else {
      const T xm = src[x == 0 ? s + (X - 1) * YZ : s - YZ];
      const T xp = src[x == X - 1 ? s - (X - 1) * YZ : s + YZ];
      const T ym = src[y == 0 ? s + (Y - 1) * Z : s - Z];
      const T yp = src[y == Y - 1 ? s - (Y - 1) * Z : s + Z];
      const T zm = src[z == 0 ? s + (Z - 1) : s - 1];
      const T zp = src[z == Z - 1 ? s - (Z - 1) : s + 1];
      T nb = xm + xp;
      nb = nb + ym + yp;
      nb = nb + zm + zp;
      const T res = eps * (nb - T(6) * p) + rhs[s];
      dst[s] = p + omega * res / denom;
      acc += res * res;
    }
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

template <typename T>
struct SorParams {
  T eps, denom, rel_tol, abs_tol, stall_frac;
  int X, Y, Z, max_its, ntab, zero_mean, stall;
};

// part: 5 x gridDim.x partials: red and black for even iterations, red
// and black for odd ones, misc.  Iteration n + 1 writes the other pair
// while slow blocks may still read iteration n's; n + 2 may reuse it, as
// every block has passed iteration n + 1's first barrier by then.  The
// result is in p0, istats = (n, which), rstats = (rnorm).
template <typename T>
__global__ void __launch_bounds__(kThreads)
sor_kernel(T* p0, T* p1, const T* __restrict__ rhs,
           const T* __restrict__ om_tab, T* part, int* istats, T* rstats,
           SorParams<T> sp) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T sh[kThreads / 32 + 1];
  const int G = gridDim.x;
  T* part_misc = part + 4 * G;
  const int nsite = sp.X * sp.Y * sp.Z;
  const int stride = G * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;

  // rnorm0 = sqrt(sum rhs^2)
  T acc = T(0);
  for (int64_t s = first; s < nsite; s += stride) acc += rhs[s] * rhs[s];
  acc = block_sum_all(acc, sh);
  if (threadIdx.x == 0) part_misc[blockIdx.x] = acc;
  grid.sync();
  const T rnorm0 = sqrt(sum_partials(part_misc, G, sh));

  // prev is set at n = 0 before any use, rn at the last iteration run
  T prev = T(0), rn = T(0);
  int nstop = sp.max_its - 1, which = 1;
  for (int n = 0; n < sp.max_its; ++n) {
    const int nt = n < sp.ntab ? n : sp.ntab - 1;
    T* part_red = part + (n & 1) * 2 * G;
    T* part_blk = part_red + G;
    const bool is_check = n % 5 == 0;
    const bool reduce = is_check || n == sp.max_its - 1;
    T a = sor_half(p0, p1, rhs, 0, om_tab[2 * nt], sp.X, sp.Y, sp.Z, sp.eps,
                   sp.denom, first, stride, nsite);
    if (reduce) {
      a = block_sum_all(a, sh);
      if (threadIdx.x == 0) part_red[blockIdx.x] = a;
    }
    grid.sync();
    T b = sor_half(p1, p0, rhs, 1, om_tab[2 * nt + 1], sp.X, sp.Y, sp.Z,
                   sp.eps, sp.denom, first, stride, nsite);
    if (reduce) {
      b = block_sum_all(b, sh);
      if (threadIdx.x == 0) part_blk[blockIdx.x] = b;
    }
    grid.sync();
    if (!reduce) continue;
    // the same partials in the same order in every block: one decision
    const T s_red = sum_partials(part_red, G, sh);
    const T s_blk = sum_partials(part_blk, G, sh);
    const T rnorm1 = sqrt(s_red + s_blk);
    rn = rnorm1;
    which = rnorm1 < sp.abs_tol ? 0 : 1;
    if (is_check) {
      bool conv = rnorm1 < sp.abs_tol || rnorm1 < sp.rel_tol * rnorm0;
      if (sp.stall && n > 0) conv = conv || rnorm1 >= sp.stall_frac * prev;
      prev = rnorm1;
      if (conv) {
        nstop = n;
        break;
      }
    }
  }

  if (sp.zero_mean) {
    T m = T(0);
    for (int64_t s = first; s < nsite; s += stride) m += p0[s];
    m = block_sum_all(m, sh);
    if (threadIdx.x == 0) part_misc[blockIdx.x] = m;
    grid.sync();
    const T mean = sum_partials(part_misc, G, sh) / static_cast<T>(nsite);
    for (int64_t s = first; s < nsite; s += stride) p0[s] = p0[s] - mean;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    istats[0] = nstop;
    istats[1] = which;
    rstats[0] = rn;
  }
}

template <typename T>
static int sor_grid(int device, long long nsite, int* grid) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return kErrNoCooperativeLaunch;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sor_kernel<T>,
                                                    kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (nsite + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<int>(need < resident ? need : resident);
  return *grid > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

template <typename T>
static int launch_sor(void* p0, void* p1, const void* rhs, const void* om,
                      void* part, void* istats, void* rstats, int grid,
                      const double* par, const int* ipar,
                      cudaStream_t stream) {
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
  T* a0 = static_cast<T*>(p0);
  T* a1 = static_cast<T*>(p1);
  const T* a2 = static_cast<const T*>(rhs);
  const T* a3 = static_cast<const T*>(om);
  T* a4 = static_cast<T*>(part);
  int* a5 = static_cast<int*>(istats);
  T* a6 = static_cast<T*>(rstats);
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &a6, &sp};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(sor_kernel<T>), dim3(grid), dim3(kThreads),
      args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// -- Nernst-Planck + grad-mu ---------------------------------------------------

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

template <typename T, int HYDRO>
__global__ void __launch_bounds__(kThreads)
np_gradmu_kernel(const T* __restrict__ psi, const T* __restrict__ rho,
                 const T* __restrict__ u, const uint8_t* __restrict__ fluid,
                 T* __restrict__ rho_out, T* __restrict__ force,
                 T* __restrict__ part, int X, int Y, int Z, NpParams<T> p) {
  __shared__ T sh[kThreads / 32 + 1];
  const int nsite = X * Y * Z;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  T fs[3] = {T(0), T(0), T(0)};
  if (s < nsite) {
    const int z = s % Z;
    const int r = s / Z;
    const int y = r % Y;
    const int x = r / Y;
    const int YZ = Y * Z;
    // neighbour sites along each axis: minus and plus
    const int nm[3] = {s + (wrap1(x - 1, X) - x) * YZ,
                       s + (wrap1(y - 1, Y) - y) * Z, s + wrap1(z - 1, Z) - z};
    const int np[3] = {s + (wrap1(x + 1, X) - x) * YZ,
                       s + (wrap1(y + 1, Y) - y) * Z, s + wrap1(z + 1, Z) - z};
    const T ps = psi[s];

    T re = T(0);
    for (int k = 0; k < p.nk; ++k) re = re + p.ez[k] * rho[k * nsite + s];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T e_a = T(-0.5) * (psi[np[a]] - psi[nm[a]]) * p.kt_e;
      fs[a] = re * e_a;
      force[a * nsite + s] = fs[a];
    }

    const T ms = static_cast<T>(fluid[s]);
    for (int k = 0; k < p.nk; ++k) {
      const T* rk = rho + k * nsite;
      const T ns = rk[s];
      T div = T(0);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const T* ua = u + a * nsite;   // read only with HYDRO
        const T us = HYDRO ? ua[s] : T(0);
        const T up = face_flux<T, HYDRO>(
            ps, psi[np[a]], ns, rk[np[a]], us, HYDRO ? ua[np[a]] : T(0), ms,
            static_cast<T>(fluid[np[a]]), p.z[k], p.c[k]);
        const T dn = face_flux<T, HYDRO>(
            psi[nm[a]], ps, rk[nm[a]], ns, HYDRO ? ua[nm[a]] : T(0), us,
            static_cast<T>(fluid[nm[a]]), ms, p.z[k], p.c[k]);
        const T d = up - dn;
        div = a == 0 ? d : div + d;
      }
      const T upd = ns - p.dt * div;
      rho_out[k * nsite + s] = ms > T(0) ? upd : ns;
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T b = block_sum_all(fs[a], sh);
    if (threadIdx.x == 0) part[a * gridDim.x + blockIdx.x] = b;
  }
}

template <typename T>
static int launch_np(int hydro, const void* psi, const void* rho,
                     const void* u, const void* fluid, void* rho_out,
                     void* force, void* part, void* fsum, int X, int Y,
                     int Z, int nk, const double* par, cudaStream_t stream) {
  if (nk < 1 || nk > kMaxSpecies) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  NpParams<T> p;
  p.kt_e = static_cast<T>(par[0]);
  p.dt = static_cast<T>(par[1]);
  p.nk = nk;
  for (int k = 0; k < nk; ++k) {
    p.ez[k] = static_cast<T>(par[2 + k]);
    p.z[k] = static_cast<T>(par[2 + nk + k]);
    p.c[k] = static_cast<T>(par[2 + 2 * nk + k]);
  }
  const long long nsite = static_cast<long long>(X) * Y * Z;
  const int blocks = static_cast<int>((nsite + kThreads - 1) / kThreads);
  if (hydro) {
    np_gradmu_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(psi), static_cast<const T*>(rho),
        static_cast<const T*>(u), static_cast<const uint8_t*>(fluid),
        static_cast<T*>(rho_out), static_cast<T*>(force),
        static_cast<T*>(part), X, Y, Z, p);
  } else {
    np_gradmu_kernel<T, 0><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(psi), static_cast<const T*>(rho),
        static_cast<const T*>(u), static_cast<const uint8_t*>(fluid),
        static_cast<T*>(rho_out), static_cast<T*>(force),
        static_cast<T*>(part), X, Y, Z, p);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials_kernel<T><<<1, kReduceThreads, 0, stream>>>(
      static_cast<const T*>(part), blocks, 3, T(1), static_cast<T*>(fsum));
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int lb_np_blocks(long long nsite) {
  return static_cast<int>((nsite + kThreads - 1) / kThreads);
}

int lb_sor_grid(int is_f64, int device, long long nsite, int* grid) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return is_f64 ? sor_grid<double>(device, nsite, grid)
                : sor_grid<float>(device, nsite, grid);
}

int lb_sor_solve(int is_f64, void* p0, void* p1, const void* rhs,
                 const void* om_tab, void* part, void* istats, void* rstats,
                 int grid, const double* par, const int* ipar, void* stream,
                 int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_sor<double>(p0, p1, rhs, om_tab, part, istats,
                                     rstats, grid, par, ipar, s)
                : launch_sor<float>(p0, p1, rhs, om_tab, part, istats,
                                    rstats, grid, par, ipar, s);
}

int lb_np_gradmu(int is_f64, int hydro, const void* psi, const void* rho,
                 const void* u, const void* fluid, void* rho_out, void* force,
                 void* part, void* fsum, int X, int Y, int Z, int nk,
                 const double* par, void* stream, int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_np<double>(hydro, psi, rho, u, fluid, rho_out,
                                    force, part, fsum, X, Y, Z, nk, par, s)
                : launch_np<float>(hydro, psi, rho, u, fluid, rho_out, force,
                                   part, fsum, X, Y, Z, nk, par, s);
}

}  // extern "C"
