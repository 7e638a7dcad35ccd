// R1: the MoE router's logits for Hopper (sm_90a), batch-invariant.
//
// No TPU kernel to replace: the reference computes the router product
// `x.astype(f32) @ router.astype(f32)` (src/repro/models/moe.py:232) as plain
// array code.  This kernel computes
//   logits[t, e] = sum_d f32(x[t, d]) f32(W[d, e])
// in one fixed order per (token, expert):
// - lane l of a warp takes d = l, l + 32, l + 64, ... and sums its products
//   in that order (__fmul_rn then __fadd_rn, no FMA contraction);
// - then a fixed xor-butterfly over the 32 lanes (xor 16, 8, 4, 2, 1).
// That order is a function of d alone: not of the number of tokens, of the
// expert chunk a block takes, or of the grid, so a token's logits are the
// same bits in a prefill or a decode step, in a batch bucket or alone.  A
// library product picks its kernel, and so its summation order, by the
// number of rows.
//
// x is read in its own dtype (bf16 or f32), so no f32 copy of the hidden
// state is made; W (d, E) is f32 or bf16, staged transposed to f32 rows in
// shared memory (odd row strides: conflict-free).  Two kernels, one order:
// - a few tokens (a decode step): a block stages 2 experts' whole W columns
//   at once (d E / 2 blocks of 8 warps), a warp takes one token and loads 16
//   of its steps before it uses any;
// - many tokens (a prefill): a block takes 16 tokens (2 a warp) and 16
//   experts, and walks d in chunks of 256 W rows through a double buffer,
//   the next chunk's loads in flight while the current one is used.
// Which block, warp or chunk does a sum never changes its order.
//
// Bound: bytes at decode (W once, 0.33 MB at d 5120, E 16), operations at
// a long prefill (2 T d E f32 operations; the kernel issues a multiply and
// an add for each, no FMA).  chip_smoke.py times it against both.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kFewTokens = 64;            // at most this many: the few kernel
constexpr int kFewEC = 2;                 // its experts a block
constexpr int kManyTPW = 2;               // the many kernel's tokens a warp
constexpr int kManyEC = 16;               // its experts a block
constexpr int kDC = 256;                  // its W rows a chunk
constexpr int kSmemMax = 232448;          // bytes a block may use

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// A few tokens: the block stages the columns [e0, e0 + ec) of W whole.
template <typename Tx, typename Tw>
__global__ void __launch_bounds__(kThreads)
router_few_kernel(const Tx* __restrict__ x, const Tw* __restrict__ w,
                  float* __restrict__ out, int T, int d, int E, int ec) {
  extern __shared__ float sw[];               // [ne][d | 1]
  const int dp = d | 1;
  const int e0 = blockIdx.y * ec;
  const int ne = E - e0 < ec ? E - e0 : ec;
#pragma unroll 8
  for (int i = threadIdx.x; i < d * ne; i += kThreads) {
    const int r = i / ne, c = i - r * ne;
    sw[c * dp + r] = to_f(w[(long long)r * E + e0 + c]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= T) return;                         // whole warps, after the sync
  const Tx* xr = x + (long long)t * d;
  float acc[kFewEC];
#pragma unroll
  for (int e = 0; e < kFewEC; ++e) acc[e] = 0.f;
  constexpr int G = 16;                       // steps loaded at once
  for (int i0 = lane; i0 < d; i0 += 32 * G) {
    float xv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = i0 + 32 * g;
      xv[g] = i < d ? to_f(xr[i]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = i0 + 32 * g;
      if (i >= d) break;
#pragma unroll
      for (int e = 0; e < kFewEC; ++e)
        if (e < ne)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(xv[g], sw[e * dp + i]));
    }
  }
#pragma unroll
  for (int e = 0; e < kFewEC; ++e) {
    if (e >= ne) break;
    const float s = warp_sum(acc[e]);
    if (lane == 0) out[(long long)t * E + e0 + e] = s;
  }
}

// Many tokens: 2 tokens a warp, 16 experts a block, W in chunks of kDC
// rows through two buffers.
template <typename Tx, typename Tw>
__global__ void __launch_bounds__(kThreads)
router_many_kernel(const Tx* __restrict__ x, const Tw* __restrict__ w,
                   float* __restrict__ out, int T, int d, int E) {
  constexpr int TPW = kManyTPW, PER = kDC * kManyEC / kThreads;
  __shared__ float sw[2][kManyEC][kDC + 1];
  const int e0 = blockIdx.y * kManyEC;
  const int ne = E - e0 < kManyEC ? E - e0 : kManyEC;
  const int lane = threadIdx.x & 31;
  const int t0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * TPW;
  const int chunks = (d + kDC - 1) / kDC;
  float pre[PER];
  auto fetch = [&](int c) {       // element j: row r = j / 16, expert j % 16
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = threadIdx.x + k * kThreads, r = j / kManyEC,
                e = j % kManyEC, dd = c * kDC + r;
      pre[k] = dd < d && e < ne ? to_f(w[(long long)dd * E + e0 + e]) : 0.f;
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = threadIdx.x + k * kThreads;
      sw[buf][j % kManyEC][j / kManyEC] = pre[k];
    }
  };
  fetch(0);
  put(0);
  __syncthreads();
  float acc[TPW][kManyEC];
#pragma unroll
  for (int t = 0; t < TPW; ++t)
#pragma unroll
    for (int e = 0; e < kManyEC; ++e) acc[t][e] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) fetch(c + 1);         // in flight meanwhile
    const int buf = c & 1, d0 = c * kDC;
    constexpr int G = 4;                      // steps loaded at once
#pragma unroll
    for (int k0 = 0; k0 < kDC / 32; k0 += G) {
      float xv[G][TPW];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int i = d0 + 32 * (k0 + g) + lane;
#pragma unroll
        for (int t = 0; t < TPW; ++t)
          xv[g][t] = i < d && t0 + t < T
                         ? to_f(x[(long long)(t0 + t) * d + i]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int r = 32 * (k0 + g) + lane;
        if (d0 + r >= d) break;
#pragma unroll
        for (int e = 0; e < kManyEC; ++e) {
          const float wv = sw[buf][e][r];
#pragma unroll
          for (int t = 0; t < TPW; ++t)
            acc[t][e] = __fadd_rn(acc[t][e], __fmul_rn(xv[g][t], wv));
        }
      }
    }
    if (c + 1 < chunks) put(buf ^ 1);   // its readers passed the last sync
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < TPW; ++t) {
    if (t0 + t >= T) break;                   // the same for the warp
#pragma unroll
    for (int e = 0; e < kManyEC; ++e) {
      if (e >= ne) break;
      const float s = warp_sum(acc[t][e]);
      if (lane == 0) out[(long long)(t0 + t) * E + e0 + e] = s;
    }
  }
}

template <typename Tx, typename Tw>
int launch_typed(const void* x, const void* w, float* out, int T, int d,
                 int E, cudaStream_t s) {
  const Tx* xx = static_cast<const Tx*>(x);
  const Tw* ww = static_cast<const Tw*>(w);
  if (T > kFewTokens) {
    const int per_block = kWarps * kManyTPW;
    const dim3 grid((T + per_block - 1) / per_block,
                    (E + kManyEC - 1) / kManyEC);
    router_many_kernel<Tx, Tw><<<grid, kThreads, 0, s>>>(xx, ww, out, T, d,
                                                         E);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)kFewEC * (d | 1) * sizeof(float);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  static bool configured = false;             // once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        router_few_kernel<Tx, Tw>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((T + kWarps - 1) / kWarps, (E + kFewEC - 1) / kFewEC);
  router_few_kernel<Tx, Tw><<<grid, kThreads, smem, s>>>(xx, ww, out, T, d, E,
                                                        kFewEC);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches R1 on `stream`; returns cudaGetLastError() after the launch (0 =
// launched).  x: contiguous (T, d) of `x_dtype`; w: contiguous (d, E) of
// `w_dtype` (0 = float32, 1 = bfloat16); out: (T, E) float32.
int router_launch(const void* x, const void* w, float* out, int T, int d,
                  int E, int x_dtype, int w_dtype, void* stream) {
  if (T < 1 || d < 1 || E < 1 || E > 65535 ||
      (long long)(T + kWarps - 1) / kWarps > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBF16 && w_dtype == kF32)
    return launch_typed<__nv_bfloat16, float>(x, w, out, T, d, E, s);
  if (x_dtype == kF32 && w_dtype == kF32)
    return launch_typed<float, float>(x, w, out, T, d, E, s);
  if (x_dtype == kBF16 && w_dtype == kBF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(x, w, out, T, d, E, s);
  if (x_dtype == kF32 && w_dtype == kBF16)
    return launch_typed<float, __nv_bfloat16>(x, w, out, T, d, E, s);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
