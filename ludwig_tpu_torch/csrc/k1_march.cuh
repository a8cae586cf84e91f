// The x-march shared by the three K1 kernels on Hopper (sm_90a): the
// binary fluid's (csrc/binary_phi.cu), the liquid crystal's
// (csrc/lc_q.cu) and the LC droplet's (csrc/droplet.cu).
//
// A block owns a BY x BZ column of the y-z plane (BZ = 32, a warp along
// z) and a segment of BX x-planes, and marches along x.  What a site
// update reads (the traces of ops/fused_binary.py _binary_site,
// ops/fused_lc.py _lc_site and ops/fused_droplet.py _droplet_site,
// ops/_cuda.py k1_reads): the staged fields (phi for the binary fluid,
// q5, phi and q5 for the droplet) and u within one site, the level-1
// stress pth[a][b] only at +-e_b, the level-1 mu at the six neighbours
// and the site itself (binary, droplet), and the site's own molecular
// field h (LC, droplet; the binary fluid has none, NH = 0).  So a block
// keeps in shared memory:
//   - the staged fields' planes x-1 .. x+3 with a y-z halo of 2 (five
//     slots; plane x+3 is in flight, by cp.async, while plane x computes);
//   - u's planes x-1 .. x+2 with a halo of 1 (x+2 in flight);
//   - a ring of pth[:,0] (3 components) on the tile, planes x-1 .. x+1,
//     and of mu on the tile and its y-z faces (droplet);
//   - for planes x and x+1: pth[:,1] on the tile and its two y faces,
//     pth[:,2] on the tile and its two z faces, and h on the tile (no
//     buffer where NH = 0).
// Every buffer is laid out row by row (y), the components of a row side
// by side, z fastest: with BZ fixed at compile time every neighbour a
// site reads is a constant offset from one base address a plane.
// Level 1 is evaluated once per site of the cross-shaped window of plane
// x+1 (tile plus faces; the corners are never read), and on the tile
// alone for the segment's two end planes, which only the x neighbours
// read: (BX + 2) / BX + 2 (BY + BZ) / (BY BZ) evaluations a site.  A step
// is: wait for the own copies, barrier; issue the next copies; level 1 on
// plane x+1; barrier; the site update of plane x from shared memory
// alone, written out along z.
//
// In-plane offsets are int32, worked out once per block for each row
// (y) and column (z) of the staged window with a true modulo, so an axis
// shorter than the halo or not a multiple of the tile wraps
// periodically; tile sites beyond the lattice compute on wrapped sites
// and store nothing.  The layout (tile, segment, threads, shared bytes)
// is chosen in Python (ops/_cuda.py k1_layout); Layout below is its
// count of the shared buffers, which k1_buffers mirrors.  The host side
// the kernels share (the launch bounds, the refusal of a layout the
// kernel does not take, the launch, the attribute query) lives here too:
// each .cu keeps its kernel body and its extern "C" shims.
//
// What bounds it differs by kernel: the LC and droplet marches are held
// by their instruction stream (thousands of generated operations a
// site); the binary march moves 32 B a site against about 150 generated
// operations and is held by its loads (device memory, and the staged
// halo's reloads from L2).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace k1 {

constexpr int BZ = 32;          // the tile's z extent: one warp
constexpr int STAGE_SLOTS = 5;  // staged planes x-1 .. x+3
constexpr int U_SLOTS = 4;      // u planes x-1 .. x+2
constexpr int RING = 3;         // pth[:,0] and mu: planes x-1 .. x+1
constexpr int BUFS = 2;         // pth[:,1], pth[:,2] and h: planes x, x+1
constexpr int W2 = BZ + 4;      // a row with the halo of 2
constexpr int W1 = BZ + 2;      // a row with the halo of 1

struct Geom {
  int X, Y, Z;
  int BX, BY;     // x segment, tile rows
  int nty, ntz;   // tiles along y and z
};

// One block's shared buffers, in elements of T (NS staged components,
// NH components of h, MU whether mu crosses sites), then two int tables.
// A slot or buffer holds its rows one after another, each row its
// components side by side.
struct Layout {
  int PW;         // a staged slot: (BY+4) rows of NS x W2
  int PU;         // a u slot: (BY+2) rows of 3 x W1
  int NI;         // the tile: BY x BZ
  int PYZ;        // pth[:,1] on (BY+2) rows of 3 x BZ, then pth[:,2] on
                  // BY rows of 3 x W1
  int PM;         // a mu slot: (BY+2) rows of W1
  int stg, su, p0, pyz, hh, mu, total;   // offsets of the buffers

  __host__ __device__ Layout(int NS, int NH, bool MU, int BY) {
    PW = (BY + 4) * NS * W2;
    PU = (BY + 2) * 3 * W1;
    NI = BY * BZ;
    PYZ = (BY + 2) * 3 * BZ + BY * 3 * W1;
    PM = (BY + 2) * W1;
    stg = 0;
    su = stg + STAGE_SLOTS * PW;
    p0 = su + U_SLOTS * PU;
    pyz = p0 + RING * 3 * NI;
    hh = pyz + BUFS * PYZ;
    mu = hh + BUFS * NH * NI;
    total = mu + (MU ? RING * PM : 0);
  }

  // the element buffers, then the row and column offset tables
  __host__ __device__ size_t bytes(size_t itemsize, int BY) const {
    return static_cast<size_t>(total) * itemsize +
           sizeof(int) * static_cast<size_t>(BY + 4 + W2);
  }
};

// the most threads a block: f32 512 (at most 128 registers a thread),
// f64 256, for its registers (the kernels' launch bounds)
template <typename T>
struct MaxThreads;
template <>
struct MaxThreads<float> {
  static constexpr int value = 512;
};
template <>
struct MaxThreads<double> {
  static constexpr int value = 256;
};

// a kernel's dynamic shared bytes, with the SM's carveout all shared
// memory so that the blocks k1_layout counts fit side by side
template <class K>
static cudaError_t set_smem(K kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(cudaSharedmemCarveoutMaxShared));
}

// The launch of a K1 kernel (NS staged components, NH of h, HAS_MU
// whether mu crosses sites) on lay = BX, BY, threads, shared bytes
// (ops/_cuda.py k1_layout, whose k1_smem_bytes mirrors Layout): a layout
// the kernel does not take is refused, never launched.  The kernel takes
// args..., then the geometry, then its constants p.
template <typename T, int NS, int NH, bool HAS_MU, class K, class P,
          class... A>
static int launch(K kernel, int X, int Y, int Z, const int* lay, const P& p,
                  cudaStream_t stream, A... args) {
  const int BX = lay[0], BY = lay[1], threads = lay[2], smem = lay[3];
  if (BX < 1 || BY < 1 || threads < 32 || threads % 32 ||
      threads > MaxThreads<T>::value ||
      static_cast<size_t>(smem) !=
          Layout(NS, NH, HAS_MU, BY).bytes(sizeof(T), BY) ||
      static_cast<int64_t>(Y) * Z > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{X, Y, Z, BX, BY, (Y + BY - 1) / BY, (Z + BZ - 1) / BZ};
  const int64_t blocks =
      static_cast<int64_t>(g.nty) * g.ntz * ((X + BX - 1) / BX);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(args..., g,
                                                                   p);
  return static_cast<int>(cudaGetLastError());
}

// out[0..4): the kernel's registers a thread, (threads > 0) the blocks an
// SM the card keeps resident with `smem` bytes each, the card's
// multiprocessors and shared-memory opt-in
template <class K>
static int attrs(K kernel, int device, int threads, int smem, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount,
                               device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &out[3], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = 0;
  if (threads > 0) {
    e = set_smem(kernel, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel,
                                                        threads, smem);
  }
  return static_cast<int>(e);
}

__host__ __device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The march of one block.  src[c] is staged component c (a whole field),
// u the velocity (3 components).  level1(F, mu, pth, h) evaluates level
// 1 from F(c, dx, dy, dz), staged component c at an offset; site(F, U,
// S, MU, HK, s) updates one site from the accessors and stores it at
// element offset s of a component (HK(k): component k of the site's h).
template <typename T, int NS, int NH, bool HAS_MU, class Level1, class Site>
__device__ __forceinline__ void march(const Geom& g, const T* const* src,
                                      const T* __restrict__ u,
                                      const Level1& level1, const Site& site) {
  constexpr int ROW2 = NS * W2, ROWU = 3 * W1;
  const int BY = g.BY;
  const Layout L(NS, NH, HAS_MU, BY);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  T* const stg = sm + L.stg;
  T* const su = sm + L.su;
  T* const sp0 = sm + L.p0;
  T* const spyz = sm + L.pyz;
  T* const shh = sm + L.hh;
  T* const smu = sm + L.mu;
  int* const yoff = reinterpret_cast<int*>(sm + L.total);
  int* const zoff = yoff + BY + 4;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b = blockIdx.x;
  const int tz = b % g.ntz, ty = (b / g.ntz) % g.nty;
  const int seg = b / (g.ntz * g.nty);
  const int y0 = ty * BY, z0 = tz * BZ;
  const int xs = seg * g.BX;
  const int xe = min(xs + g.BX, g.X);
  const int64_t plane = static_cast<int64_t>(g.Y) * g.Z;
  const int64_t nsite = plane * g.X;

  for (int i = tid; i < BY + 4; i += nthr) yoff[i] = wrap(y0 + i - 2, g.Y) * g.Z;
  for (int i = tid; i < W2; i += nthr) zoff[i] = wrap(z0 + i - 2, g.Z);
  __syncthreads();

  // staged planes: x in [xs-2, xe+1] -> slot (x - xs + 2) % STAGE_SLOTS
  auto staged = [&](int x) -> T* {
    return stg + ((x - xs + 2) % STAGE_SLOTS) * L.PW;
  };
  auto stage = [&](int x) {
    T* const dst = staged(x);
    const int64_t pb = wrap(x, g.X) * plane;
    for (int r = tid; r < (BY + 4) * W2; r += nthr) {
      const int ry = r / W2, rz = r - ry * W2;
      const int64_t o = pb + yoff[ry] + zoff[rz];
#pragma unroll
      for (int c = 0; c < NS; ++c)
        cp_async(dst + ry * ROW2 + c * W2 + rz, src[c] + o);
    }
  };
  // u planes: x in [xs-1, xe] -> slot (x - xs + 1) % U_SLOTS
  auto ustaged = [&](int x) -> T* {
    return su + ((x - xs + 1) % U_SLOTS) * L.PU;
  };
  auto stage_u = [&](int x) {
    T* const dst = ustaged(x);
    const int64_t pb = wrap(x, g.X) * plane;
    for (int r = tid; r < (BY + 2) * W1; r += nthr) {
      const int ry = r / W1, rz = r - ry * W1;
      const int64_t o = pb + yoff[ry + 1] + zoff[rz + 1];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        cp_async(dst + ry * ROWU + a * W1 + rz, u + a * nsite + o);
    }
  };
  // level-1 planes: L in [xs-1, xe] -> ring slot (L - xs + 1) % RING,
  // buffer (L - xs + 1) % BUFS
  auto ring = [&](int x) { return (x - xs + 1) % RING; };
  auto buf = [&](int x) { return (x - xs + 1) % BUFS; };

  // level 1 on plane x: the cross window, or (cross false) the tile only
  auto level1_plane = [&](int x, bool cross) {
    const T* const pm = staged(x - 1);
    const T* const pc = staged(x);
    const T* const pp = staged(x + 1);
    T* const r0 = sp0 + ring(x) * 3 * L.NI;
    T* const ry = spyz + buf(x) * L.PYZ;
    T* const rz = ry + (BY + 2) * 3 * BZ;
    T* const rh = shh + buf(x) * NH * L.NI;
    T* const rmu = smu + ring(x) * L.PM;
    const int n = cross ? L.NI + 2 * BZ + 2 * BY : L.NI;
    for (int i = tid; i < n; i += nthr) {
      int ly, lz, cls;
      if (i < L.NI) {
        ly = i / BZ;
        lz = i % BZ;
        cls = 0;
      } else if (i < L.NI + 2 * BZ) {
        const int j = i - L.NI;
        ly = j < BZ ? -1 : BY;
        lz = j % BZ;
        cls = 1;
      } else {
        const int j = i - L.NI - 2 * BZ;
        ly = j >> 1;
        lz = (j & 1) ? BZ : -1;
        cls = 2;
      }
      const int c = (ly + 2) * ROW2 + lz + 2;
      const T* const bm = pm + c;
      const T* const bc = pc + c;
      const T* const bp = pp + c;
      auto F = [&](int comp, int dx, int dy, int dz) -> T {
        const T* bs = dx < 0 ? bm : (dx > 0 ? bp : bc);
        return bs[dy * ROW2 + comp * W2 + dz];
      };
      T mu[1], pth[9], h[NH > 0 ? NH : 1];
      level1(F, mu, pth, h);
      if (cls == 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) r0[ly * 3 * BZ + a * BZ + lz] = pth[3 * a];
      }
      if (cross && cls != 2) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          ry[(ly + 1) * 3 * BZ + a * BZ + lz] = pth[3 * a + 1];
      }
      if (cross && cls != 1) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          rz[ly * 3 * W1 + a * W1 + lz + 1] = pth[3 * a + 2];
      }
      if constexpr (NH > 0) {
        if (cross && cls == 0) {
#pragma unroll
          for (int k = 0; k < NH; ++k) rh[ly * NH * BZ + k * BZ + lz] = h[k];
        }
      }
      if (HAS_MU) rmu[(ly + 1) * W1 + lz + 1] = mu[0];
    }
  };

  // the site update of plane x (in [xs, xe)), from shared memory alone
  auto site_plane = [&](int x) {
    const T* const qm = staged(x - 1);
    const T* const qc = staged(x);
    const T* const qp = staged(x + 1);
    const T* const um = ustaged(x - 1);
    const T* const uc = ustaged(x);
    const T* const up = ustaged(x + 1);
    const T* const r0m = sp0 + ring(x - 1) * 3 * L.NI;
    const T* const r0p = sp0 + ring(x + 1) * 3 * L.NI;
    const T* const ry = spyz + buf(x) * L.PYZ;
    const T* const rz = ry + (BY + 2) * 3 * BZ;
    const T* const rh = shh + buf(x) * NH * L.NI;
    const T* const mum = smu + ring(x - 1) * L.PM;
    const T* const muc = smu + ring(x) * L.PM;
    const T* const mup = smu + ring(x + 1) * L.PM;
    const int64_t pb = static_cast<int64_t>(x) * plane;
    for (int t = tid; t < L.NI; t += nthr) {
      const int ly = t / BZ, lz = t % BZ;
      if (y0 + ly >= g.Y || z0 + lz >= g.Z) continue;
      const int c2 = (ly + 2) * ROW2 + lz + 2;
      const int c1 = (ly + 1) * ROWU + lz + 1;
      const int cm = (ly + 1) * W1 + lz + 1;
      const int t3 = ly * 3 * BZ + lz;
      auto F = [&](int comp, int dx, int dy, int dz) -> T {
        const T* pl = dx < 0 ? qm : (dx > 0 ? qp : qc);
        return pl[c2 + dy * ROW2 + comp * W2 + dz];
      };
      auto U = [&](int a, int dx, int dy, int dz) -> T {
        const T* pl = dx < 0 ? um : (dx > 0 ? up : uc);
        return pl[c1 + dy * ROWU + a * W1 + dz];
      };
      // pth[a][b] at +-e_b: b = 0 from the x ring, 1 and 2 from the
      // plane's y and z extended tiles (k1_reads: nothing else is read)
      auto S = [&](int a, int bb, int dx, int dy, int dz) -> T {
        if (bb == 0) return (dx < 0 ? r0m : r0p)[t3 + a * BZ];
        if (bb == 1) return ry[t3 + (1 + dy) * 3 * BZ + a * BZ];
        return rz[ly * 3 * W1 + a * W1 + lz + 1 + dz];
      };
      auto MU = [&](int dx, int dy, int dz) -> T {
        const T* pl = dx < 0 ? mum : (dx > 0 ? mup : muc);
        return pl[cm + dy * W1 + dz];
      };
      auto HK = [&](int k) -> T { return rh[ly * NH * BZ + k * BZ + lz]; };
      site(F, U, S, MU, HK, pb + yoff[ly + 2] + zoff[lz + 2]);
    }
  };

  // prologue: staged planes xs-2 .. xs+2, u planes xs-1 .. xs+1; level 1
  // on plane xs-1 (tile) and xs (cross)
  for (int x = xs - 2; x <= xs + 2; ++x) stage(x);
  for (int x = xs - 1; x <= xs + 1; ++x) stage_u(x);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  level1_plane(xs - 1, false);
  level1_plane(xs, true);

  for (int x = xs; x < xe; ++x) {
    cp_wait_all();
    __syncthreads();
    // the slots of planes x-2 are free: plane x+3 is read by level 1 of
    // plane x+2, u's plane x+2 by the site update of plane x+1
    if (x + 2 <= xe) {
      stage(x + 3);
      stage_u(x + 2);
      cp_commit();
    }
    level1_plane(x + 1, x + 1 < xe);
    __syncthreads();
    site_plane(x);
  }
}

}  // namespace k1
