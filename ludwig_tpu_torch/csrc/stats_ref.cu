// Reference-ordered statistics scans for Hopper (sm_90a), f32/f64.
//
// Replaces the lax.scan reductions of ludwig_tpu/stats.py that the JAX
// package's reference statistics (ludwig.py _make_stats_fn) print from:
//   stats_scan_kernel, mode SEQ   <- seq_sum            (stats.py:59)
//                      mode RHO   <- rho_stats_ref      (stats.py:155)
//                      mode KLEIN / KAHAN / PLAIN
//                                 <- field_stats_ref    (stats.py:84)
//   momentum_scan_kernel          <- momentum_total_ref (stats.py:239)
//   chain_sums_kernel             <- the per-particle, per-image link sums
//                                    of the colloids' reference order
//                                    (colloids.py:233 _ordered_image_reduce,
//                                    colloids_fast.py:581)
// None of them is a Pallas kernel: on the TPU they are XLA scans.
//
// A site-order Klein or Kahan sum is one chain of dependent additions;
// it cannot be re-associated without changing the printed digits.  So
// each independent chain is one thread: lane 0 of warp 0 for the 1-D
// scans, lane 0 of warps 0, 1 and 2 for the three momentum components,
// accumulating in the field's dtype exactly as the scan body does, term
// for term (built with -fmad=false: no contraction of v * v into the
// sum).  The other warps of the one block stream the next tile of the
// field into shared memory (double-buffered, coalesced) while the chain
// threads scan the current one; a momentum chain forms a site's nvel - 1
// products before it adds them, so it waits on its own additions, not on
// shared-memory latency (reading 8 values ahead made the 1-D scans
// slower, 2x, on an H100).
//
// Bound on this card: the dependent chain, not bytes or operations.  A
// chain retires one addition per add latency (~4 cycles f32): a 256^3
// momentum total is 3 chains of 16.7M x 18 Kahan updates of 4 dependent
// additions each, seconds, where its bytes (1.2 GB) take 0.4 ms.
//
// Masks: a uint8 per site (1 = fluid) or none.  SEQ adds where(keep, x,
// 0); RHO, PLAIN and KLEIN add w * x with w = keep as T (0 * x keeps the
// sign of x, as in the JAX scan); KAHAN and the momentum scan really skip
// a masked site (a Kahan add of 0 is not a no-op once the compensation
// is non-zero).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 8 warps: chain threads + loaders
constexpr int kTile = 2048;            // values a tile of the 1-D scans
constexpr int kSiteTile = 64;          // sites a tile of the momentum scan

enum Mode { SEQ = 0, RHO = 1, PLAIN = 2, KLEIN = 3, KAHAN = 4 };

template <typename T>
__device__ __forceinline__ T absval(T v) {
  return v < T(0) ? -v : v;
}

// the threads of warps first_warp.. copy count values from src to dst
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          T* dst,
                                          const uint8_t* __restrict__ ksrc,
                                          uint8_t* kdst, int count,
                                          int first_warp) {
  const int lt = threadIdx.x - 32 * first_warp;
  const int nl = blockDim.x - 32 * first_warp;
  if (lt < 0) return;
  for (int i = lt; i < count; i += nl) {
    dst[i] = src[i];
    if (ksrc) kdst[i] = ksrc[i];
  }
}

// the running sums of one chain
template <typename T>
struct Chain {
  T s = T(0), cs = T(0), ccs = T(0), sq = T(0);
};

// one value of the scan `MODE`, as the JAX package's scan body adds it
template <typename T, int MODE>
__device__ __forceinline__ void scan_one(Chain<T>& a, T xv, bool masked,
                                         bool k) {
  if (MODE == SEQ) {
    a.s = a.s + (k ? xv : T(0));
    return;
  }
  const T v = masked ? (k ? T(1) : T(0)) * xv : xv;   // w * x
  if (MODE == RHO) {
    a.s = a.s + v;
    a.sq = a.sq + v * xv;
  } else if (MODE == PLAIN) {
    a.s = a.s + v;
    a.sq = a.sq + v * v;
  } else if (MODE == KLEIN) {
    const T t = a.s + v;
    const T cc1 = absval(a.s) >= absval(v) ? (a.s - t) + v : (v - t) + a.s;
    a.s = t;
    const T t2 = a.cs + cc1;
    const T cc2 =
        absval(a.cs) >= absval(cc1) ? (a.cs - t2) + cc1 : (cc1 - t2) + a.cs;
    a.cs = t2;
    a.ccs = a.ccs + cc2;
    a.sq = a.sq + v * v;
  } else {   // KAHAN, masked sites skipped
    const T y = v + a.cs;
    const T t = a.s + y;
    const T cs2 = y - (t - a.s);
    if (k) {
      a.s = t;
      a.cs = cs2;
    }
    a.sq = a.sq + v * v;
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
stats_scan_kernel(const T* __restrict__ x, const uint8_t* __restrict__ keep,
                  int64_t n, T* __restrict__ out) {
  __shared__ T buf[2][kTile];
  __shared__ uint8_t kbuf[2][kTile];
  Chain<T> a;
  const bool masked = keep != nullptr;
  const int64_t ntiles = (n + kTile - 1) / kTile;
  auto count = [&](int64_t it) {
    return static_cast<int>(n - it * kTile < kTile ? n - it * kTile : kTile);
  };
  if (ntiles > 0)
    load_tile(x, buf[0], keep, kbuf[0], count(0), 1);
  __syncthreads();
  for (int64_t it = 0; it < ntiles; ++it) {
    const int b = static_cast<int>(it & 1);
    if (it + 1 < ntiles) {
      const int64_t off = (it + 1) * kTile;
      load_tile(x + off, buf[b ^ 1], keep ? keep + off : nullptr,
                kbuf[b ^ 1], count(it + 1), 1);
    }
    if (threadIdx.x == 0) {
      const int c = count(it);
      for (int i = 0; i < c; ++i)
        scan_one<T, MODE>(a, buf[b][i], masked,
                          masked ? kbuf[b][i] != 0 : true);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = MODE == KLEIN ? (a.s + a.cs) + a.ccs : a.s;
    out[1] = a.sq;
  }
}

struct Velocities {
  int c[3 * 27];   // c[3 * p + a], p = 0..nvel-1
};

// total momentum: per site, p = 1..nvel-1 (NT = nvel - 1 terms), a Kahan
// update of f_p c_pa in each component's chain (zero c included), sites
// in order, masked sites skipped.  A site's NT products are formed
// before its chain runs over them.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
momentum_scan_kernel(const T* __restrict__ f, const uint8_t* __restrict__ keep,
                     int64_t nsite, Velocities cv, T* __restrict__ out) {
  __shared__ T buf[2][kSiteTile * NT];
  __shared__ uint8_t kbuf[2][kSiteTile];
  const int warp = threadIdx.x / 32;
  const bool chain = threadIdx.x % 32 == 0 && warp < 3;
  T c[NT];   // this chain's c_pa, p = 1..nvel-1
#pragma unroll
  for (int p = 0; p < NT; ++p)
    c[p] = static_cast<T>(cv.c[3 * (p + 1) + (warp < 3 ? warp : 0)]);
  T s = T(0), cs = T(0);
  const int64_t ntiles = (nsite + kSiteTile - 1) / kSiteTile;
  auto count = [&](int64_t it) {
    return static_cast<int>(nsite - it * kSiteTile < kSiteTile
                                ? nsite - it * kSiteTile : kSiteTile);
  };
  // loaders (warps 3..): value p of site i of the tile goes to i * NT +
  // p - 1, read along i (coalesced)
  auto load = [&](int64_t it, int b) {
    const int lt = threadIdx.x - 96;
    if (lt < 0) return;
    const int nl = blockDim.x - 96;
    const int cnt = count(it);
    const int64_t s0 = it * kSiteTile;
    for (int j = lt; j < cnt * NT; j += nl) {
      const int p = j / cnt + 1, i = j % cnt;
      buf[b][i * NT + p - 1] = f[static_cast<int64_t>(p) * nsite + s0 + i];
    }
    if (keep)
      for (int i = lt; i < cnt; i += nl) kbuf[b][i] = keep[s0 + i];
  };
  if (ntiles > 0) load(0, 0);
  __syncthreads();
  for (int64_t it = 0; it < ntiles; ++it) {
    const int b = static_cast<int>(it & 1);
    if (it + 1 < ntiles) load(it + 1, b ^ 1);
    if (chain) {
      const int cnt = count(it);
      for (int i = 0; i < cnt; ++i) {
        if (keep && kbuf[b][i] == 0) continue;
        T v[NT];
#pragma unroll
        for (int p = 0; p < NT; ++p) v[p] = buf[b][i * NT + p] * c[p];
#pragma unroll
        for (int p = 0; p < NT; ++p) {
          const T y = v[p] + cs;
          const T t = s + y;
          cs = y - (t - s);
          s = t;
        }
      }
    }
    __syncthreads();
  }
  if (chain) out[warp] = s;
}

template <typename T, int NT>
int launch_momentum(const void* f, const void* keep, long long nsite,
                    const Velocities& v, void* out, cudaStream_t stream) {
  momentum_scan_kernel<T, NT><<<1, kThreads, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const uint8_t*>(keep), nsite, v,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_momentum(int nvel, const void* f, const void* keep,
                      long long nsite, const Velocities& v, void* out,
                      cudaStream_t stream) {
  switch (nvel) {   // the velocity sets of lattice.py
    case 9:
      return launch_momentum<T, 8>(f, keep, nsite, v, out, stream);
    case 15:
      return launch_momentum<T, 14>(f, keep, nsite, v, out, stream);
    case 19:
      return launch_momentum<T, 18>(f, keep, nsite, v, out, stream);
    case 27:
      return launch_momentum<T, 26>(f, keep, nsite, v, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_scan(int mode, const void* x, const void* keep, long long n,
                void* out, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  T* op = static_cast<T*>(out);
  switch (mode) {
    case SEQ:
      stats_scan_kernel<T, SEQ><<<1, kThreads, 0, stream>>>(xp, kp, n, op);
      break;
    case RHO:
      stats_scan_kernel<T, RHO><<<1, kThreads, 0, stream>>>(xp, kp, n, op);
      break;
    case PLAIN:
      stats_scan_kernel<T, PLAIN><<<1, kThreads, 0, stream>>>(xp, kp, n, op);
      break;
    case KLEIN:
      stats_scan_kernel<T, KLEIN><<<1, kThreads, 0, stream>>>(xp, kp, n, op);
      break;
    case KAHAN:
      stats_scan_kernel<T, KAHAN><<<1, kThreads, 0, stream>>>(xp, kp, n, op);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// chain c of nchain: out[c] = seed[c] + v[0][c] + v[1][c] + ... in that
// order, v laid out (len, nchain) so that a warp reads 32 consecutive
// chains of one step; one thread a chain, in the values' dtype
template <typename T>
__global__ void chain_sums_kernel(const T* __restrict__ v,
                                  const T* __restrict__ seed,
                                  long long len, long long nchain,
                                  T* __restrict__ out) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= nchain) return;
  T s = seed[c];
  // the loads do not depend on the sum: unrolled, several are in flight
  // while the additions wait on each other
#pragma unroll 8
  for (long long i = 0; i < len; ++i) s = s + v[i * nchain + c];
  out[c] = s;
}

template <typename T>
int launch_chains(const void* v, const void* seed, long long len,
                  long long nchain, void* out, cudaStream_t stream) {
  const long long blocks = (nchain + kThreads - 1) / kThreads;
  chain_sums_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(static_cast<const T*>(v),
                                   static_cast<const T*>(seed), len, nchain,
                                   static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[c] = seed[c] + v[0][c] + ... + v[len - 1][c], added in that order,
// for the nchain chains of v (len, nchain)
int lb_chain_sums(int is_f64, const void* v, const void* seed, long long len,
                  long long nchain, void* out, void* stream, int device) {
  if (nchain <= 0) return 0;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_chains<double>(v, seed, len, nchain, out, s)
                : launch_chains<float>(v, seed, len, nchain, out, s);
}

// out[0] the total, out[1] the second sum (nothing for SEQ) of the scan
// `mode` over the n values of x (keep: a uint8 per value, or null)
int lb_stats_scan(int is_f64, int mode, const void* x, const void* keep,
                  long long n, void* out, void* stream, int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_scan<double>(mode, x, keep, n, out, s)
                : launch_scan<float>(mode, x, keep, n, out, s);
}

// out[0..3) the total momentum of f (nvel, nsite); cv: 3 * nvel ints;
// nvel 9, 15, 19 or 27
int lb_stats_momentum(int is_f64, int nvel, const void* f, const void* keep,
                      long long nsite, const int* cv, void* out, void* stream,
                      int device) {
  if (nvel < 2 || nvel > 27) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Velocities v = {};
  for (int i = 0; i < 3 * nvel; ++i) v.c[i] = cv[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? dispatch_momentum<double>(nvel, f, keep, nsite, v, out, s)
                : dispatch_momentum<float>(nvel, f, keep, nsite, v, out, s);
}

}  // extern "C"
