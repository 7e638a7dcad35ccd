// K6a / K6b: 2-D and 3-D tap stencils for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `stencil_2d` / `_stencil_kernel_2d` and
// `stencil_3d` / `_stencil_kernel_3d` in src/repro/kernels/stencil/kernel.py:
// out = the interior of a grid that carries a halo of `radius` on every
// side, each point `acc = acc + c * tap` over the taps in `spec.offsets`
// order, with an f32 accumulator, stored in the grid's type.
//
// Numerics, both kernels: the reference multiplies a tap by the weak-typed
// f32 `c` and then adds, each rounded; `__fmul_rn` / `__fadd_rn` keep nvcc
// from fusing them into an FMA, and every output's chain starts from +0
// and runs over its taps in spec order, so a kernel equals the plain
// PyTorch version bit for bit, for any tile.  Nothing is shared between
// the chains of two outputs (no partial sums reused along z, no separable
// passes): that would reorder a sum.  The grid is not padded: outputs past
// the interior are computed from whatever the staging left there and are
// not stored, so every stored point sees exactly its own taps.
//
// Bound: bytes.  A point reads one value and writes one (3.35 TB/s: 0.322
// ms at 512^3 f32); j3d27pt's 27 unfused products and sums, 54 f32
// instructions a point, take 0.22 ms at the card's 67 TFLOP/s, so its
// arithmetic is close behind.
//
// General kernel (`stencil_kernel`: K6a, and any 3-D spec that is not one
// of the march's patterns).  On the TPU each grid step streamed an
// overlapping (tile + 2r) VMEM window and ran the shifted-slice FMA chain
// on it.  Here one thread block owns one output tile: its 32 x 8 threads
// stage the (tile + 2r) halo window in f32 shared memory (a warp along x,
// so loads are coalesced), then step the same layout over the tile's x, y
// and z to compute its outputs.  A 2-D stencil is the 3-D case with one
// plane and no halo along z.  The taps travel as a kernel argument: each
// tap's offset inside the halo window and its f32 coefficient, in spec
// order, read at a run-time index for every tap of every point.
//
// K6b's march (`march_kernel`: j3d27pt, j3d7pt).  The general kernel spent
// ~8 instructions a tap on its run-time tap loop and a shared load per tap,
// and re-read a fifth of the grid for its z halo.  The march is compiled
// for the two radius-1 patterns the repository's 3-D specs use, taps in
// their spec order (`Box27`, `Star7`):
// - A block owns a (ty, tx) footprint and walks tz output planes along z.
//   Each input plane's (ty + 2, tx + 2) window is staged once, by
//   `cp.async`, into a ring of kRing plane buffers in shared memory in the
//   grid's type, one commit group a plane, two planes in flight behind the
//   one being read.  The library grid's rows are 2,056 bytes, no multiple
//   of 16, so neither TMA nor 16-byte copies take them as they are (16-byte
//   copies from the aligned address below each row's start, the row
//   shifted in the ring, were tried and were no faster): a copy moves an
//   element pair where the block's rows start on two elements, else one
//   element (bf16 then by plain loads and stores).  The z halo costs
//   2 / tz of the planes.
// - A thread owns kRunX = 4 consecutive x outputs of one row.  For each
//   new plane it reads its three rows' 6 values from the ring (8, in two
//   vector loads a row), widened to f32, into registers, which it keeps
//   while the plane moves from the +1 to the 0 to the -1 role: three
//   planes of three rows in registers, rotated by unrolling the march
//   three planes at a time, so a point costs 1.5 shared loads and no
//   register moves.
// - The taps are unrolled at compile time: each output's chain is applied
//   from registers in spec order, the coefficient an operand from the
//   kernel's parameter space.
// The block is (ceil(tx / 4), ty) threads, at most kMarchThreads, and the
// tile is the launch's, so any tile that fits is right (`tuning.py` has the
// card's default and why).  What bounds it (`tools/compare_stencil.py
// --ablate`): j3d7pt the memory path, whose reads run at about half the
// rate of a device copy; j3d27pt that and its 54 f32 instructions a point
// at 4 blocks an SM, which overlap only in part.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kMaxTaps = 32;
constexpr int kWarpX = 32;  // general kernel: threads along x
constexpr int kRowsY = 8;   // general kernel: threads along y
constexpr int kMaxSmem = 48 * 1024;

constexpr int kRunX = 4;            // march: consecutive x outputs a thread
constexpr int kRing = 4;            // march: plane buffers in the ring
constexpr int kMarchThreads = 256;  // march: most threads a block

struct Taps {
  int n;
  int delta[kMaxTaps];    // tap offset in the halo window, in elements
  float coeff[kMaxTaps];  // f32 coefficient
};

struct Geom {
  int Z, Y, X;     // interior (output) extents; Z = 1 for 2-D
  int rz, r;       // halo along z (0 for 2-D) and along y, x
  int tz, ty, tx;  // output tile
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// grid (ceil(X / tx), ceil(Y / ty), ceil(Z / tz)), block (32, 8),
// dynamic shared memory (tz + 2rz)(ty + 2r)(tx + 2r) floats.
template <typename T>
__global__ void __launch_bounds__(kWarpX * kRowsY)
    stencil_kernel(const T* __restrict__ in, T* __restrict__ out, Geom g,
                   Taps taps) {
  extern __shared__ float win[];
  const int sz = g.tz + 2 * g.rz, sy = g.ty + 2 * g.r, sx = g.tx + 2 * g.r;
  const int GY = g.Y + 2 * g.r, GX = g.X + 2 * g.r, GZ = g.Z + 2 * g.rz;
  const int z0 = blockIdx.z * g.tz, y0 = blockIdx.y * g.ty;
  const int x0 = blockIdx.x * g.tx;
  for (int z = 0; z < sz; ++z) {
    const int gz = z0 + z;
    for (int y = threadIdx.y; y < sy; y += kRowsY) {
      const int gy = y0 + y;
      const bool row_in = gz < GZ && gy < GY;
      const T* src = in + ((size_t)gz * GY + gy) * GX + x0;
      float* dst = win + (z * sy + y) * sx;
      for (int x = threadIdx.x; x < sx; x += kWarpX)
        dst[x] = row_in && x0 + x < GX ? to_f32(src[x]) : 0.f;
    }
  }
  __syncthreads();
  for (int z = 0; z < g.tz && z0 + z < g.Z; ++z) {
    for (int y = threadIdx.y; y < g.ty && y0 + y < g.Y; y += kRowsY) {
      T* dst = out + ((size_t)(z0 + z) * g.Y + y0 + y) * g.X + x0;
      const float* row = win + ((z + g.rz) * sy + y + g.r) * sx + g.r;
      for (int x = threadIdx.x; x < g.tx && x0 + x < g.X; x += kWarpX) {
        const float* c = row + x;
        float acc = 0.f;
        for (int k = 0; k < taps.n; ++k)
          acc = __fadd_rn(acc, __fmul_rn(taps.coeff[k], c[taps.delta[k]]));
        store(dst + x, acc);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6b's march.  The patterns, as core/stencils.py builds them: each row is
// one tap's (dz, dy, dx), in spec order.

// j3d27pt: _box(3, 1), itertools.product order (dz outermost, then dy, dx).
struct Box27 {
  static constexpr int n = 27;
  static constexpr int min_blocks = 4;  // <= 64 registers
  static constexpr int off[n][3] = {
      {-1, -1, -1}, {-1, -1, 0}, {-1, -1, 1}, {-1, 0, -1}, {-1, 0, 0},
      {-1, 0, 1},   {-1, 1, -1}, {-1, 1, 0},  {-1, 1, 1},  {0, -1, -1},
      {0, -1, 0},   {0, -1, 1},  {0, 0, -1},  {0, 0, 0},   {0, 0, 1},
      {0, 1, -1},   {0, 1, 0},   {0, 1, 1},   {1, -1, -1}, {1, -1, 0},
      {1, -1, 1},   {1, 0, -1},  {1, 0, 0},   {1, 0, 1},   {1, 1, -1},
      {1, 1, 0},    {1, 1, 1}};
  __host__ __device__ static constexpr int d(int k, int a) {
    return off[k][a];
  }
};

// j3d7pt: _star(3, 1): the centre, then -1 and +1 along z, y, x.
struct Star7 {
  static constexpr int n = 7;
  static constexpr int min_blocks = 5;  // <= 51 registers
  static constexpr int off[n][3] = {{0, 0, 0},  {-1, 0, 0}, {1, 0, 0},
                                    {0, -1, 0}, {0, 1, 0},  {0, 0, -1},
                                    {0, 0, 1}};
  __host__ __device__ static constexpr int d(int k, int a) {
    return off[k][a];
  }
};

struct MarchGeom {
  int Z, Y, X;     // interior (output) extents; the halo is 1 everywhere
  int tz, ty, tx;  // output tile: tz planes marched over a (ty, tx) footprint
  int nthx;        // threads along x: ceil(tx / kRunX)
  int sx;          // ring row stride in elements: kRunX * nthx + 4
};

struct Coeffs {
  float c[kMaxTaps];  // f32 coefficients, in spec order
};

// cp.async of `bytes` (4 or 8, a compile-time size) from global to shared
// memory; only `src_bytes` of them are read, the rest is filled with 0.
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(bytes), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 ring values at `p` (16 bytes aligned for f32, 8 for bf16) as f32.
__device__ __forceinline__ void ring8(const float* p, float* v) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}
__device__ __forceinline__ void ring8(const __nv_bfloat16* p, float* v) {
  const uint2 lo = *reinterpret_cast<const uint2*>(p);
  const uint2 hi = *reinterpret_cast<const uint2*>(p + 4);
  const unsigned w[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store_run(float* o, const float (&acc)[kRunX],
                                          int n) {
  if (n == kRunX && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2],
                                                acc[3]);
  } else {
    for (int i = 0; i < n; ++i) o[i] = acc[i];
  }
}
__device__ __forceinline__ void store_run(__nv_bfloat16* o,
                                          const float (&acc)[kRunX], int n) {
  if (n == kRunX && (reinterpret_cast<uintptr_t>(o) & 7) == 0) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0], acc[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(acc[2], acc[3]);
    uint2 v;
    v.x = *reinterpret_cast<unsigned*>(&lo);
    v.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(o) = v;
  } else {
    for (int i = 0; i < n; ++i) o[i] = __float2bfloat16_rn(acc[i]);
  }
}

// One thread's share of a block's march.  Planes are numbered from the
// block's first grid plane: output plane j reads planes j, j + 1, j + 2.
// Plane p lives in ring buffer p % kRing, in the grid's type; q[(ROT + dz +
// 1) % 3] holds this thread's three rows (6 values each, 8 loaded) of the
// plane at dz, as f32, while output plane j = ROT (mod 3) is computed.
template <class P, typename T>
struct March {
  const T* src0;  // the block's window corner in its first grid plane
  T* out;
  T* ring;
  MarchGeom g;
  size_t gplane;  // elements in a grid plane
  int GX, x0, y0, z0, nz, tyi, txi, splane, rows, cols, nrun;
  bool row_out, pairs;
  float q[3][3][8];

  // Plane p's window into its buffer, then one commit group (empty past
  // the block's last plane, so the group count stays uniform).  Where every
  // row of the block starts on two elements (`pairs`), by `cp.async` of
  // element pairs (a last odd column reads one and fills the other with
  // 0); else f32 by `cp.async` of single elements, bf16 element by element
  // through registers (a copy takes no fewer than 4 bytes).
  __device__ __forceinline__ void stage(int p) {
    if (p < nz + 2) {
      const T* src = src0 + p * gplane;
      T* dst = ring + (p & (kRing - 1)) * splane;
      if (pairs) {
        const int cols2 = (cols + 1) >> 1;
        for (int r = tyi; r < rows; r += g.ty)
          for (int c = txi; c < cols2; c += g.nthx)
            cp_async<2 * sizeof(T)>(
                dst + r * g.sx + 2 * c, src + (size_t)r * GX + 2 * c,
                (2 * c + 1 < cols ? 2 : 1) * (int)sizeof(T));
      } else {
        for (int r = tyi; r < rows; r += g.ty)
          for (int c = txi; c < cols; c += g.nthx) {
            if constexpr (std::is_same<T, float>::value)
              cp_async<4>(dst + r * g.sx + c, src + (size_t)r * GX + c, 4);
            else
              dst[r * g.sx + c] = src[(size_t)r * GX + c];
          }
      }
    }
    cp_async_commit();
  }
  // This thread's three rows of plane p, window columns 4 txi .. 4 txi + 7.
  __device__ __forceinline__ void load(float (&v)[3][8], int p) {
    const T* b = ring + (p & (kRing - 1)) * splane + tyi * g.sx + kRunX * txi;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) ring8(b + dy * g.sx, v[dy]);
  }
  template <int ROT, int K>
  __device__ __forceinline__ void tap(float (&acc)[kRunX],
                                      const Coeffs& cf) const {
    constexpr int s = (ROT + P::d(K, 0) + 1) % 3;
    constexpr int row = P::d(K, 1) + 1, col = P::d(K, 2) + 1;
#pragma unroll
    for (int i = 0; i < kRunX; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(cf.c[K], q[s][row][col + i]));
  }
  // Every output's chain, taps in spec order (the fold runs K = 0, 1, ...).
  template <int ROT, int... K>
  __device__ __forceinline__ void taps(float (&acc)[kRunX], const Coeffs& cf,
                                       std::integer_sequence<int, K...>) {
    (tap<ROT, K>(acc, cf), ...);
  }
  // Output plane j (= ROT mod 3): plane j + 2 has landed and is loaded;
  // plane j + kRing is staged into the buffer plane j left.
  template <int ROT>
  __device__ __forceinline__ void step(int j, const Coeffs& cf) {
    cp_async_wait<kRing - 3>();
    __syncthreads();  // plane j + 2 visible; planes <= j + 1 read by all
    stage(j + kRing);
    load(q[(ROT + 2) % 3], j + 2);
    float acc[kRunX] = {0.f, 0.f, 0.f, 0.f};
    taps<ROT>(acc, cf, std::make_integer_sequence<int, P::n>{});
    if (row_out && nrun > 0)
      store_run(out + ((size_t)(z0 + j) * g.Y + y0 + tyi) * g.X + x0 +
                    kRunX * txi,
                acc, nrun);
  }
};

// grid (ceil(X / tx), ceil(Y / ty), ceil(Z / tz)), block (ceil(tx / 4), ty),
// dynamic shared memory kRing (ty + 2) sx elements of T.  At most
// kMarchThreads threads, P::min_blocks blocks an SM (a cap on registers).
template <class P, typename T>
__global__ void __launch_bounds__(kMarchThreads, P::min_blocks)
    march_kernel(const T* __restrict__ in, T* __restrict__ out, MarchGeom g,
                 const __grid_constant__ Coeffs cf) {
  extern __shared__ __align__(16) unsigned char march_smem[];
  March<P, T> m;
  const int GY = g.Y + 2;
  m.GX = g.X + 2;
  m.g = g;
  m.gplane = (size_t)GY * m.GX;
  m.x0 = blockIdx.x * g.tx;
  m.y0 = blockIdx.y * g.ty;
  m.z0 = blockIdx.z * g.tz;
  m.nz = min(g.tz, g.Z - m.z0);
  m.tyi = threadIdx.y;
  m.txi = threadIdx.x;
  m.splane = (g.ty + 2) * g.sx;
  m.rows = min(g.ty + 2, GY - m.y0);
  m.cols = min(g.tx + 2, m.GX - m.x0);
  m.nrun = min(kRunX, min(g.tx, g.X - m.x0) - kRunX * m.txi);
  m.row_out = m.y0 + m.tyi < g.Y;
  m.src0 = in + m.z0 * m.gplane + (size_t)m.y0 * m.GX + m.x0;
  m.pairs = (m.GX & 1) == 0 &&
            (reinterpret_cast<uintptr_t>(m.src0) & (2 * sizeof(T) - 1)) == 0;
  m.out = out;
  m.ring = reinterpret_cast<T*>(march_smem);
#pragma unroll
  for (int p = 0; p < kRing; ++p) m.stage(p);
  cp_async_wait<kRing - 2>();
  __syncthreads();
  m.load(m.q[0], 0);
  m.load(m.q[1], 1);
  for (int j = 0; j < m.nz; j += 3) {
    m.template step<0>(j, cf);
    if (j + 1 >= m.nz) break;
    m.template step<1>(j + 1, cf);
    if (j + 2 >= m.nz) break;
    m.template step<2>(j + 2, cf);
  }
  cp_async_wait<0>();
}

template <class P>
int march_launch(const void* in, void* out, const MarchGeom& g,
                 const Coeffs& cf, int dtype, dim3 grid, dim3 block,
                 size_t smem, cudaStream_t s) {
  if (dtype == kF32)
    march_kernel<P, float><<<grid, block, smem, s>>>(
        static_cast<const float*>(in), static_cast<float*>(out), g, cf);
  else if (dtype == kBF16)
    march_kernel<P, __nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(in),
        static_cast<__nv_bfloat16*>(out), g, cf);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the general kernel (K6a; a 3-D spec that no march pattern
// matches) on `stream`; returns cudaGetLastError() after the launch (0 =
// launched).  `in` is the (Z + 2rz, Y + 2r, X + 2r) grid, `out` the
// (Z, Y, X) interior, both contiguous; a 2-D stencil passes Z = 1, rz = 0,
// tz = 1.  `delta` / `coeff`: n_taps host values, delta measured in the
// (tz + 2rz, ty + 2r, tx + 2r) halo window.  dtype: 0 = float32,
// 1 = bfloat16.
int stencil_launch(const void* in, void* out, int Z, int Y, int X, int rz,
                   int r, int tz, int ty, int tx, int n_taps,
                   const int* delta, const float* coeff, int dtype,
                   void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps || Z < 1 || Y < 1 || X < 1 || tz < 1 ||
      ty < 1 || tx < 1 || r < 0 || rz < 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (size_t)(tz + 2 * rz) * (ty + 2 * r) * (tx + 2 * r);
  const long long gy = (Y + ty - 1) / ty, gz = (Z + tz - 1) / tz;
  if (smem > (size_t)kMaxSmem || gy > 65535 || gz > 65535)
    return cudaErrorInvalidValue;
  Geom g{Z, Y, X, rz, r, tz, ty, tx};
  Taps taps;
  taps.n = n_taps;
  for (int k = 0; k < n_taps; ++k) {
    taps.delta[k] = delta[k];
    taps.coeff[k] = coeff[k];
  }
  dim3 grid((X + tx - 1) / tx, (unsigned)gy, (unsigned)gz);
  dim3 block(kWarpX, kRowsY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    stencil_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(in), static_cast<float*>(out), g, taps);
  else if (dtype == kBF16)
    stencil_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(in),
        static_cast<__nv_bfloat16*>(out), g, taps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// Launches K6b's march on `stream`: `in` the (Z + 2, Y + 2, X + 2) grid,
// `out` the (Z, Y, X) interior, both contiguous; pattern 1 = Box27
// (j3d27pt's taps), 2 = Star7 (j3d7pt's), `coeff` the pattern's n f32
// coefficients in spec order; (tz, ty, tx) the output tile of one block.
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).
int stencil3d_march_launch(const void* in, void* out, int Z, int Y, int X,
                           int tz, int ty, int tx, int pattern,
                           const float* coeff, int dtype, void* stream) {
  if (Z < 1 || Y < 1 || X < 1 || tz < 1 || ty < 1 || tx < 1)
    return cudaErrorInvalidValue;
  const int nthx = (tx + kRunX - 1) / kRunX;
  const MarchGeom g{Z, Y, X, tz, ty, tx, nthx, kRunX * nthx + 4};
  const size_t smem = (dtype == kBF16 ? 2 : 4) * (size_t)kRing * (ty + 2) *
                      g.sx;
  const long long gy = (Y + ty - 1) / ty, gz = (Z + tz - 1) / tz;
  if ((long long)nthx * ty > kMarchThreads || smem > (size_t)kMaxSmem ||
      gy > 65535 || gz > 65535)
    return cudaErrorInvalidValue;
  const int n = pattern == 1 ? Box27::n : pattern == 2 ? Star7::n : 0;
  if (n == 0) return cudaErrorInvalidValue;
  Coeffs cf;
  for (int k = 0; k < kMaxTaps; ++k) cf.c[k] = k < n ? coeff[k] : 0.f;
  dim3 grid((X + tx - 1) / tx, (unsigned)gy, (unsigned)gz);
  dim3 block(nthx, ty);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pattern == 1
             ? march_launch<Box27>(in, out, g, cf, dtype, grid, block, smem, s)
             : march_launch<Star7>(in, out, g, cf, dtype, grid, block, smem,
                                   s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
