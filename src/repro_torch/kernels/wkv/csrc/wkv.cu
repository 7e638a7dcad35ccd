// K7: the RWKV-6 chunked WKV recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `wkv_pallas` / `_wkv_kernel` in
// src/repro/kernels/wkv/kernel.py.  Per (batch, head), over chunks of Q
// positions of r, k, v and the log-decay w (< 0), with an (hd, hd) f32
// state S carried from chunk to chunk:
//   cum  = inclusive cumsum of w over the chunk,  mid = cum[Q / 2]
//   att  = strictly-lower((r exp(cum - w - mid)) (k exp(mid - cum))^T)
//   y    = att v + ((r u) . k) v + (r exp(cum - w)) S
//   S'   = S exp(cum[Q-1]) + (k exp(cum[Q-1] - cum))^T v
// y is f32; the final state is written out when asked (the model's prefill
// hands it to decode, as the reference's `wkv_chunked` returns it).  The
// mid-chunk rescale is kept exactly: referring both exponents to `mid`
// bounds each by half a chunk of decay, e^64 at the clamp (w >= -1), where
// a refactored exp(-cum) would reach e^128 and overflow f32.
//
// On the TPU the chunks were the innermost, sequential grid dimension and S
// lived in VMEM scratch between grid steps.  CUDA blocks run in no order, so
// here one thread block owns one (batch, head) and loops over its chunks,
// with S resident in shared memory for the whole loop; nothing crosses
// blocks, and there are no atomics, so two launches give the same bits.
// Per chunk the block stages r, k, v and w in f32 shared memory, takes the
// cumsum (one thread per channel, position by position), forms the rescaled
// r and k in place, the strictly lower part of the (Q, Q) score tile, then y
// and the new state; r, k and w are read again from device memory (mostly
// L2) where a second form of them is needed.  Register tiles that lie wholly
// above the diagonal are skipped in the scores and in att v, and the first
// chunk skips r S (S is zero there).
// One chunk, Q = 128: a chunk changes no result beyond rounding (the
// callers pad T to whole chunks with zeros), so the card keeps the largest
// one whose tiles fit: 217,088 bytes of shared memory (tuning.wkv_smem_bytes),
// one block per SM.
//
// Bound: operations.  Per (b, h) the dots the function needs are the
// strictly lower triangle, 2 Q (Q - 1) hd flops for the scores and att v
// together per chunk, plus 2 Q hd^2 for r S on every chunk but the first and
// 2 Q hd^2 for the state update; at B 4, T 2048, 64 heads of 64 that is
// 16.8 GFLOP of f32, 0.251 ms at the card's 67 TFLOP/s (no tensor-core f32
// path), against 0.20 ms to move r, k, v, w and y once at 3.35 TB/s
// (chip_smoke.py computes it from the run's shape).  This first version
// runs the dots on CUDA cores from shared memory (an 8 x 8 register tile per
// thread for the scores); `wgmma` and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kHD = 64;          // head dim, the only one any config uses
constexpr int kPad = kHD + 1;    // row stride of the (Q, hd) and (hd, hd) tiles
constexpr int kThreads = 256;    // 16 x 16
constexpr int kStep = 16;        // rows and columns interleave by this
constexpr int kQ = 128;          // the chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__host__ __device__ constexpr size_t smem_floats(int q) {
  return 4 * (size_t)q * kPad + (size_t)q * (q + 1) + (size_t)kHD * kPad + q +
         3 * kHD;
}

// grid (B * nh), block 256, dynamic shared memory smem_floats(Q) floats.
// r, k, v: (B, T, nh, hd) in T_; w: the same shape in TW; u: (nh, hd) f32;
// y: (B, T, nh, hd) f32; s_out: (B, nh, hd, hd) f32 or null.
template <typename T_, typename TW>
__global__ void __launch_bounds__(kThreads)
    wkv_kernel(const T_* __restrict__ r, const T_* __restrict__ k,
               const T_* __restrict__ v, const TW* __restrict__ w,
               const float* __restrict__ u, float* __restrict__ y,
               float* __restrict__ s_out, int T, int nh) {
  constexpr int Q = kQ;
  constexpr int NA = Q / kStep;  // rows (and score columns) per thread
  extern __shared__ float sm[];
  float* A = sm;                      // r, then its rescaled forms
  float* Kb = A + Q * kPad;           // k, then its rescaled forms
  float* V = Kb + Q * kPad;
  float* C = V + Q * kPad;            // w, then its cumsum
  float* att = C + Q * kPad;          // (Q, Q + 1)
  float* S = att + Q * (Q + 1);       // (hd, kPad), the carried state
  float* diag = S + kHD * kPad;       // (Q) the u bonus per row
  float* mid = diag + Q;              // (hd)
  float* last = mid + kHD;            // (hd)
  float* us = last + kHD;             // (hd)

  const int b = blockIdx.x / nh, h = blockIdx.x % nh;
  const int tid = threadIdx.x, ty = tid / kStep, tx = tid % kStep;
  const size_t row = (size_t)nh * kHD;  // elements from one position to the next

  for (int e = tid; e < kHD * kHD; e += kThreads)
    S[(e / kHD) * kPad + e % kHD] = 0.f;
  if (tid < kHD) us[tid] = u[h * kHD + tid];

  for (int c0 = 0; c0 < T; c0 += Q) {
    const size_t base = ((size_t)b * T + c0) * row + (size_t)h * kHD;
    for (int e = tid; e < Q * kHD; e += kThreads) {
      const int i = e / kHD, t = e % kHD;
      const size_t g = base + i * row + t;
      A[i * kPad + t] = to_f32(r[g]);
      Kb[i * kPad + t] = to_f32(k[g]);
      V[i * kPad + t] = to_f32(v[g]);
      C[i * kPad + t] = to_f32(w[g]);
    }
    __syncthreads();

    // the cumsum (warps 0-1, one channel each) beside the bonus (warps 2-7)
    if (tid < kHD) {
      float acc = 0.f;
      for (int i = 0; i < Q; ++i) {
        acc = __fadd_rn(acc, C[i * kPad + tid]);
        C[i * kPad + tid] = acc;
      }
      mid[tid] = C[(Q / 2) * kPad + tid];
      last[tid] = acc;
    } else {
      const int warp = (tid - kHD) / 32, lane = tid % 32;
      for (int i = warp; i < Q; i += (kThreads - kHD) / 32) {
        const float* ri = A + i * kPad;
        const float* ki = Kb + i * kPad;
        float p = __fmul_rn(__fmul_rn(ri[lane], us[lane]), ki[lane]) +
                  __fmul_rn(__fmul_rn(ri[lane + 32], us[lane + 32]),
                            ki[lane + 32]);
        for (int o = 16; o > 0; o >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, o);
        if (lane == 0) diag[i] = p;
      }
    }
    __syncthreads();

    // r and k rescaled about the mid-chunk cumsum, in place
    for (int e = tid; e < Q * kHD; e += kThreads) {
      const int i = e / kHD, t = e % kHD;
      const float cu = C[i * kPad + t];
      const float wv = to_f32(w[base + i * row + t]);
      A[i * kPad + t] =
          __fmul_rn(A[i * kPad + t], expf(__fsub_rn(__fsub_rn(cu, wv), mid[t])));
      Kb[i * kPad + t] = __fmul_rn(Kb[i * kPad + t], expf(__fsub_rn(mid[t], cu)));
    }
    __syncthreads();

    // the strictly lower (Q, Q) score tile: rows ty + 16a, columns tx + 16c;
    // tiles with c > a lie above the diagonal and are neither computed nor
    // read
    {
      float acc[NA][NA];
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int c = 0; c <= a; ++c) acc[a][c] = 0.f;
      for (int t = 0; t < kHD; ++t) {
        float ra[NA], kc[NA];
#pragma unroll
        for (int a = 0; a < NA; ++a) ra[a] = A[(ty + kStep * a) * kPad + t];
#pragma unroll
        for (int c = 0; c < NA; ++c) kc[c] = Kb[(tx + kStep * c) * kPad + t];
#pragma unroll
        for (int a = 0; a < NA; ++a)
#pragma unroll
          for (int c = 0; c <= a; ++c) acc[a][c] = fmaf(ra[a], kc[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int c = 0; c <= a; ++c) {
          const int i = ty + kStep * a, j = tx + kStep * c;
          att[i * (Q + 1) + j] = j < i ? acc[a][c] : 0.f;
        }
    }
    __syncthreads();

    // r decayed to the chunk start (inter-chunk term), k decayed to its end
    // (state update), from fresh reads of r, k and w
    for (int e = tid; e < Q * kHD; e += kThreads) {
      const int i = e / kHD, t = e % kHD;
      const size_t g = base + i * row + t;
      const float cu = C[i * kPad + t];
      A[i * kPad + t] = __fmul_rn(to_f32(r[g]), expf(__fsub_rn(cu, to_f32(w[g]))));
      Kb[i * kPad + t] = __fmul_rn(to_f32(k[g]), expf(__fsub_rn(last[t], cu)));
    }
    __syncthreads();

    // y = att v + diag v + ri S: rows ty + 16a, columns tx + 16c
    {
      float intra[NA][4], inter[NA][4];
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) intra[a][c] = inter[a][c] = 0.f;
      // row block a takes columns j < 16 (a + 1): the rest of its row is
      // above the diagonal
#pragma unroll
      for (int jb = 0; jb < NA; ++jb)
        for (int j = kStep * jb; j < kStep * (jb + 1); ++j) {
          float vv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) vv[c] = V[j * kPad + tx + kStep * c];
#pragma unroll
          for (int a = jb; a < NA; ++a) {
            const float p = att[(ty + kStep * a) * (Q + 1) + j];
#pragma unroll
            for (int c = 0; c < 4; ++c) intra[a][c] = fmaf(p, vv[c], intra[a][c]);
          }
        }
      if (c0 > 0)  // S is zero before the first chunk
        for (int t = 0; t < kHD; ++t) {
          float ss[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) ss[c] = S[t * kPad + tx + kStep * c];
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            const float p = A[(ty + kStep * a) * kPad + t];
#pragma unroll
            for (int c = 0; c < 4; ++c) inter[a][c] = fmaf(p, ss[c], inter[a][c]);
          }
        }
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const int i = ty + kStep * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = tx + kStep * c;
          const float yv = __fadd_rn(intra[a][c],
                                     __fmul_rn(diag[i], V[i * kPad + d]));
          y[base + i * row + d] = __fadd_rn(yv, inter[a][c]);
        }
      }
    }
    __syncthreads();

    // S' = S exp(last) + kd^T v: rows t = ty + 16a, columns tx + 16c
    {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
      for (int j = 0; j < Q; ++j) {
        float vv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) vv[c] = V[j * kPad + tx + kStep * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float kd = Kb[j * kPad + ty + kStep * a];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(kd, vv[c], acc[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty + kStep * a;
        const float decay = expf(last[t]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* s = S + t * kPad + tx + kStep * c;
          *s = __fadd_rn(__fmul_rn(*s, decay), acc[a][c]);
        }
      }
    }
    __syncthreads();
  }

  if (s_out != nullptr) {
    float* dst = s_out + ((size_t)b * nh + h) * kHD * kHD;
    for (int e = tid; e < kHD * kHD; e += kThreads)
      dst[e] = S[(e / kHD) * kPad + e % kHD];
  }
}

template <typename T_, typename TW>
int launch_typed(const void* r, const void* k, const void* v, const void* w,
                 const float* u, float* y, float* s_out, int B, int T, int nh,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(kQ);
  cudaError_t e = cudaFuncSetAttribute(
      wkv_kernel<T_, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  wkv_kernel<T_, TW><<<B * nh, kThreads, smem, stream>>>(
      static_cast<const T_*>(r), static_cast<const T_*>(k),
      static_cast<const T_*>(v), static_cast<const TW*>(w), u, y, s_out, T,
      nh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K7 on `stream`; returns cudaGetLastError() after the launch (0 =
// launched).  r, k, v: contiguous (B, T, nh, hd) of `dtype` (0 = float32,
// 1 = bfloat16); w: the same shape of `w_dtype`, float32 or `dtype` (bf16
// r, k, v with an f32 decay is the reference's mixed case); u: (nh, hd)
// float32; y: (B, T, nh, hd) float32; s_out: (B, nh, hd, hd) float32, or
// null for no state.  hd must be 64, chunk 128, T a positive multiple of
// chunk.
int wkv_launch(const void* r, const void* k, const void* v, const void* w,
               const float* u, float* y, float* s_out, int B, int T, int nh,
               int hd, int chunk, int dtype, int w_dtype, void* stream) {
  if (hd != kHD || chunk != kQ || T < chunk || T % chunk || B < 1 || nh < 1 ||
      (long long)B * nh > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && w_dtype == kF32)
    return launch_typed<float, float>(r, k, v, w, u, y, s_out, B, T, nh, s);
  if (dtype == kBF16 && w_dtype == kF32)
    return launch_typed<__nv_bfloat16, float>(r, k, v, w, u, y, s_out, B, T,
                                              nh, s);
  if (dtype == kBF16 && w_dtype == kBF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, y, s_out,
                                                      B, T, nh, s);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
