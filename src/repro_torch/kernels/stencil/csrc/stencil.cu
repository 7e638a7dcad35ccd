// K6a / K6b: 2-D and 3-D tap stencils for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `stencil_2d` / `_stencil_kernel_2d` and
// `stencil_3d` / `_stencil_kernel_3d` in src/repro/kernels/stencil/kernel.py:
// out = the interior of a grid that carries a halo of `radius` on every
// side, each point `acc = acc + c * tap` over the taps in `spec.offsets`
// order, with an f32 accumulator, stored in the grid's type.
//
// On the TPU each grid step streamed an overlapping (tile + 2r) VMEM window
// and ran the shifted-slice FMA chain on it.  Here one thread block owns one
// output tile: its 32 x 8 threads stage the (tile + 2r) halo window in f32
// shared memory (a warp along x, so loads are coalesced), then step the
// same layout over the tile's x, y and z to compute its outputs, with no
// index division on the way.  A 2-D stencil is the 3-D case with one plane
// and no halo along z, so one kernel, templated only on the value type,
// serves both.  The taps travel as a kernel argument: each tap's offset
// inside the halo window (computed on the host for the launch's tile) and
// its f32 coefficient, in spec order.
//
// Numerics: the reference multiplies a tap by the weak-typed f32 `c` and
// then adds, each rounded; `__fmul_rn` / `__fadd_rn` keep nvcc from fusing
// them into an FMA, so the kernel equals the plain PyTorch version bit for
// bit, for any tile.  The grid is not padded: loads past the grid's edge
// read 0 into the window and outputs past the interior are not stored, so
// every output point sees exactly its own taps.
//
// Bound: bytes.  A point reads one value and writes one; 2 * taps flops per
// point (<= 54) is far below the ~20 flops per byte at which f32 CUDA-core
// arithmetic would be the limit.  The halo is re-read by neighbouring
// blocks, mostly from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kMaxTaps = 32;
constexpr int kWarpX = 32;  // threads along x
constexpr int kRowsY = 8;   // threads along y
constexpr int kMaxSmem = 48 * 1024;

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

}  // namespace

extern "C" {

// Launches K6 on `stream`; returns cudaGetLastError() after the launch (0 =
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

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
