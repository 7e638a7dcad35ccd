// K5: SpMSpM over padded-ELL index streams for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `spmspm_ell` / `_spmspm_kernel` (and
// `_spmspm_quant_kernel`) in src/repro/kernels/spmspm/kernel.py:
// C[r, c] = sum of a * b over the keys that A's row r (keys (R, La)) and
// B's column c (keys (C, Lb)) share, each stream ascending and padded with
// INVALID_KEY; optional per-row f32 `a_scales` dequantize narrow A values.
//
// The TPU kernel compares all pairs, (rt x ct x lb) keys per step of a
// serial walk over A's `la` stream, and accumulates in `la` order.  That
// shape suits the VPU, not a GPU.  Here a thread block takes a band of `rt`
// A rows and `nt * ct` output columns.  For one chunk of `kt` keys at a
// time it scatters its rows' entries into a dense f32 row of shared memory
// with a presence bitmask, so a key of B is looked up in A's row with one
// shared-memory probe.  Each warp then takes one output column at a time:
// its 32 lanes read 32 consecutive B keys and values (coalesced), test them
// against each of the band's rows, and a warp ballot hands the matches to
// the row's accumulator in ascending key order.  Ascending key order is
// A's `la` order, so the sum is the reference's sum, bit for bit.  A key
// with no match contributes nothing -- not 0 * b, which would turn an Inf
// of B into a NaN.  When the band's keys span more than one chunk, the
// chunks run in ascending key order, each column's walk over B's keys
// resumes where the previous chunk stopped (the position is kept in shared
// memory), and the partial sums go through the output in device memory
// (each (r, c) belongs to one lane of one block, so no atomics).  `nt` only
// sets how many columns share one staging of the band's rows: every value
// gives the same bits.
//
// Numerics: `__fmul_rn` / `__fadd_rn` (no FMA contraction), and narrow A
// values dequantize as `__fmul_rn(float(q), scale)` before the product --
// the host's `values.float() * scale` -- so the quantized path equals the
// f32 path on host-dequantized values bit for bit.
//
// Bound: bytes (the dense (R, C) f32 output, written once, dominates), and
// the key lookups: one shared-memory probe per (B key, band row).
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kInvalid = 0x7fffffff;
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kE4M3 = 2;
constexpr int kE5M2 = 3;
constexpr int kI8 = 4;
constexpr int kMaxRows = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

struct Args {
  const int32_t* a_keys;   // (R, La)
  const void* a_vals;      // (R, La)
  const float* a_scales;   // (R,) or null
  const int32_t* b_keys;   // (C, Lb)
  const void* b_vals;      // (C, Lb)
  float* out;              // (R, C)
  int R, La, C, Lb, rt, cols, kt, threads;
  cudaStream_t stream;
};

// grid (ceil(R / rt), ceil(C / cols)), block `threads` (a multiple of 32),
// dynamic shared memory rt * kt floats + rt * kt / 32 mask words + `cols`
// walk positions.
template <typename TA, typename TB>
__global__ void spmspm_ell_kernel(
    const int32_t* __restrict__ a_keys, const TA* __restrict__ a_vals,
    const float* __restrict__ a_scales, const int32_t* __restrict__ b_keys,
    const TB* __restrict__ b_vals, float* __restrict__ out, int R, int La,
    int C, int Lb, int rt, int cols, int kt) {
  extern __shared__ float smem[];
  float* vals = smem;                                           // (rt, kt)
  const int words = kt / 32;
  // presence bits (rt, kt / 32), then each column's walk position (cols,)
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + rt * kt);
  int* walk = reinterpret_cast<int*>(mask + rt * words);
  __shared__ int s_kmin, s_kmax;
  const int r0 = blockIdx.x * rt;
  const int nrows = min(rt, R - r0);
  const int c_begin = blockIdx.y * cols;
  const int c_end = min(C, c_begin + cols);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t n_band = (size_t)nrows * La;
  const int32_t* ak = a_keys + (size_t)r0 * La;
  const TA* av = a_vals + (size_t)r0 * La;

  // the band's key range: its chunks run from kmin to kmax
  if (threadIdx.x == 0) {
    s_kmin = kInvalid;
    s_kmax = -1;
  }
  __syncthreads();
  for (size_t i = threadIdx.x; i < n_band; i += blockDim.x) {
    const int key = ak[i];
    if (key != kInvalid) {
      atomicMin(&s_kmin, key);
      atomicMax(&s_kmax, key);
    }
  }
  __syncthreads();
  const long long kmin = s_kmin, kmax = s_kmax;

  if (kmin > kmax) {  // no valid key in the band: C is zero there
    for (int rr = 0; rr < nrows; ++rr)
      for (int c = c_begin + threadIdx.x; c < c_end; c += blockDim.x)
        out[(size_t)(r0 + rr) * C + c] = 0.f;
    return;
  }
  for (long long c0 = kmin; c0 <= kmax; c0 += kt) {
    const bool first = c0 == kmin;
    const long long c1 = c0 + kt;
    for (int i = threadIdx.x; i < rt * words; i += blockDim.x) mask[i] = 0u;
    __syncthreads();
    for (size_t i = threadIdx.x; i < n_band; i += blockDim.x) {
      const int key = ak[i];
      if (key == kInvalid || key < c0 || key >= c1) continue;
      const int rr = (int)(i / La);
      const int loc = (int)(key - c0);
      float a = to_f32(av[i]);
      if (a_scales != nullptr) a = __fmul_rn(a, a_scales[r0 + rr]);
      vals[rr * kt + loc] = a;
      atomicOr(&mask[rr * words + (loc >> 5)], 1u << (loc & 31));
    }
    __syncthreads();
    for (int c = c_begin + warp; c < c_end; c += n_warps) {
      const int32_t* bk = b_keys + (size_t)c * Lb;
      const TB* bv = b_vals + (size_t)c * Lb;
      // lane rr < nrows carries row rr's sum for this column
      float acc = 0.f;
      if (!first && lane < nrows) acc = out[(size_t)(r0 + lane) * C + c];
      // resume after the previous chunks' keys; the first chunk skips B's
      // keys below the band's smallest
      for (int q0 = first ? 0 : walk[c - c_begin];; q0 += 32) {
        const int q = q0 + lane;
        const int key = q < Lb ? bk[q] : kInvalid;
        const bool past = key == kInvalid || key >= c1;
        const bool in_chunk = !past && key >= c0;
        const int loc = in_chunk ? (int)(key - c0) : 0;
        const float b = in_chunk ? to_f32(bv[q]) : 0.f;
        for (int rr = 0; rr < nrows; ++rr) {
          const uint32_t bits = mask[rr * words + (loc >> 5)];
          const bool hit = in_chunk && ((bits >> (loc & 31)) & 1u);
          const float prod = hit ? __fmul_rn(vals[rr * kt + loc], b) : 0.f;
          unsigned m = __ballot_sync(kFull, hit);
          while (m) {  // matches in ascending key order
            const int src = __ffs(m) - 1;
            const float v = __shfl_sync(kFull, prod, src);
            if (lane == rr) acc = __fadd_rn(acc, v);
            m &= m - 1;
          }
        }
        const unsigned stop = __ballot_sync(kFull, past);
        if (stop != 0u) {  // keys ascend: every later key is past too
          if (lane == 0) walk[c - c_begin] = q0 + __ffs(stop) - 1;
          break;
        }
      }
      if (lane < nrows) out[(size_t)(r0 + lane) * C + c] = acc;
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }
}

template <typename TA, typename TB>
cudaError_t launch(const Args& a) {
  const size_t smem = sizeof(float) * (size_t)a.rt * a.kt +
                      sizeof(uint32_t) * (size_t)a.rt * (a.kt / 32) +
                      sizeof(int) * (size_t)a.cols;
  cudaError_t err = cudaFuncSetAttribute(
      spmspm_ell_kernel<TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.R + a.rt - 1) / a.rt, (a.C + a.cols - 1) / a.cols);
  spmspm_ell_kernel<TA, TB><<<grid, a.threads, smem, a.stream>>>(
      a.a_keys, static_cast<const TA*>(a.a_vals), a.a_scales, a.b_keys,
      static_cast<const TB*>(a.b_vals), a.out, a.R, a.La, a.C, a.Lb, a.rt,
      a.cols, a.kt);
  return cudaGetLastError();
}

template <typename TA>
cudaError_t dispatch_b(const Args& a, int b_dtype) {
  if (b_dtype == kF32) return launch<TA, float>(a);
  if (b_dtype == kBF16) return launch<TA, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches K5 on `stream`; returns cudaGetLastError() after the launch (0 =
// launched).  dtype codes: 0 = float32, 1 = bfloat16, 2 = fp8 e4m3,
// 3 = fp8 e5m2, 4 = int8 (A only); B is float32 or bfloat16.  1 <= rt <=
// 32; threads a multiple of 32 in [32, 1024]; cols >= 1 columns per block;
// kt a multiple of 32; rt * kt * 4.125 + cols * 4 bytes of shared memory
// <= 227 KB.
int spmspm_ell_launch(const int32_t* a_keys, const void* a_vals,
                      const float* a_scales, const int32_t* b_keys,
                      const void* b_vals, float* out, int R, int La, int C,
                      int Lb, int rt, int threads, int cols, int kt,
                      int a_dtype, int b_dtype, void* stream) {
  const size_t smem =
      (size_t)rt * kt * 4 + (size_t)rt * (kt / 32) * 4 + (size_t)cols * 4;
  if (R < 1 || C < 1 || La < 1 || Lb < 1 || rt < 1 || rt > kMaxRows ||
      threads < 32 || threads > 1024 || threads % 32 != 0 || cols < 1 ||
      kt < 32 || kt % 32 != 0 || smem > 232448 ||
      (C + cols - 1) / cols > 65535)
    return cudaErrorInvalidValue;
  Args a{a_keys, a_vals, a_scales, b_keys, b_vals, out, R, La, C, Lb, rt,
         cols, kt, threads, static_cast<cudaStream_t>(stream)};
  switch (a_dtype) {
    case kF32: return dispatch_b<float>(a, b_dtype);
    case kBF16: return dispatch_b<__nv_bfloat16>(a, b_dtype);
    case kE4M3: return dispatch_b<__nv_fp8_e4m3>(a, b_dtype);
    case kE5M2: return dispatch_b<__nv_fp8_e5m2>(a, b_dtype);
    case kI8: return dispatch_b<int8_t>(a, b_dtype);
    default: return cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
