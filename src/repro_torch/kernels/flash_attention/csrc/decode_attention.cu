// D1: one-token decode attention for Hopper (sm_90a), batch-invariant.
//
// No TPU kernel to replace: the reference computes `decode_attention`
// (src/repro/kernels/flash_attention/ops.py:212) as plain array code.  This
// kernel computes that function in the same order of operations:
//   qg  = cast_cache((q * D^-0.5) in q's dtype)
//   s_j = sum_d qg[d] k_j[d] in f32, for the visible j in
//         [max(0, kv_len - window), min(kv_len, S_cap))
//   m   = max_j s_j over ALL visible positions (the row's global max)
//   p_j = exp(s_j - m) in f32,  l = sum_j p_j in f32
//   out = (sum_j f32(cast_cache(p_j)) v_j in f32) / (l == 0 ? 1 : l),
//         cast to q's dtype.
// The narrow cast applies to the unnormalized p against the global max, as
// prefill's chunked attention casts it, so a split over positions has to
// find m first: a flash-decoding rescale of per-split maxima would cast
// other numbers.
//
// The law it exists for: a row's reduction order is a function of that
// row's kv_len, the window and D only -- never of B, the grid, the other
// rows or S_cap -- so a request decoded in a batch of any size gets the bits
// it gets alone.  A library product picks its kernel (and so its order) by
// the batch count; this one has one order:
// - one thread block per (batch row, kv head), the GQA group of g <= 8 query
//   heads sharing each K / V read (or a part of the group, when B Hkv
//   blocks are too few for the card: a head's arithmetic does not depend
//   on which heads share its block); kWarps warps;
// - a dot product: lane l holds dims [l E, l E + E) (E = D / 32, or one dim
//   on lanes < 16 at D 16), sums its E products in index order, then a
//   fixed xor-butterfly over the 32 lanes (every lane ends with the same
//   bits: a + b == b + a);
// - warp w takes the visible positions lo + w, lo + w + kWarps, ... in
//   order, in both passes; pass 1 writes s_j to an f32 scratch (B, Hq,
//   S_cap) and keeps the warp's max; the block's max is exact in any order;
//   pass 2 reads back the warp's own scores, accumulates l and the PV sum
//   per warp in position order, and the kWarps partials are added in warp
//   order 0 .. kWarps - 1.  A warp loads kUnroll of its positions before it
//   uses any (more loads in flight; the order of the sums is unchanged).
// Products and sums are __fmul_rn / __fadd_rn (no FMA contraction), exp is
// the full-precision expf, the division is IEEE.  kv_len is read on the
// device (a (B,) int64 tensor, or one int for every row), so the caller
// makes no host sync.  A row with no visible position (kv_len <= 0) gives
// zeros (the plain version, with its finite NEG_INF, gives the mean of V).
//
// Bound: bytes.  The visible K and V read once (4 B D Hkv kv_len bytes at
// bf16), at 3.35 TB/s; the scores' scratch adds 8 B Hq kv_len.  The
// positions a row sees are walked by 8 warps of one block, so a short batch
// fills few SMs; chip_smoke.py times it against its bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroupMax = 8;          // query heads per kv head
constexpr int kUnroll = 4;            // positions a warp loads at once

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and read back as f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// The fixed butterfly: xor 16, 8, 4, 2, 1.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T, int N> struct alignas(sizeof(T) * N) Vec { T v[N]; };

template <typename Tq, typename Tc, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Tq* __restrict__ q, const Tc* __restrict__ k,
                        const Tc* __restrict__ v, Tq* __restrict__ out,
                        float* __restrict__ scores,
                        const long long* __restrict__ kv_len, int kv_scalar,
                        int Hq, int Hkv, int S, int window, float scale,
                        int hb) {
  constexpr int E = D >= 32 ? D / 32 : 1;     // dims a lane
  constexpr int kLanes = D >= 32 ? 32 : D;    // lanes holding dims
  __shared__ float qg[kGroupMax][D];
  __shared__ float part_m[kWarps][kGroupMax];
  __shared__ float part_l[kWarps][kGroupMax];
  __shared__ float part_o[kWarps][kGroupMax][D];

  const int g = Hq / Hkv, splits = (g + hb - 1) / hb;
  const int kvh = blockIdx.x / splits, b = blockIdx.y;
  const int h0 = kvh * g + (blockIdx.x % splits) * hb;   // first head
  const int gc = min(hb, kvh * g + g - h0);               // heads here
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool holds = lane < kLanes;
  const long long len = kv_len ? kv_len[b] : (long long)kv_scalar;
  const int hi = (int)(len < S ? len : (long long)S);
  const int lo = window >= 0 && len - window > 0 ? (int)(len - window) : 0;

  // qg = cast_cache(round_q(q * scale)), as f32
  for (int i = threadIdx.x; i < gc * D; i += kThreads) {
    const int h = i / D, d = i % D;
    const float x = to_f(q[((long long)b * Hq + h0 + h) * D + d]);
    qg[h][d] = round_to<Tc>(round_to<Tq>(__fmul_rn(x, scale)));
  }
  __syncthreads();

  const long long row = ((long long)b * Hkv + kvh) * S;
  float* sc = scores + ((long long)b * Hq + h0) * S;   // (gc, S) here
  float m_w[kGroupMax];
#pragma unroll
  for (int h = 0; h < kGroupMax; ++h) m_w[h] = -INFINITY;

  // pass 1: scores and the warp's max.  Warp w's positions are lo + w,
  // lo + w + kWarps, ...; kUnroll of them are loaded before any is used.
  for (int j0 = lo + warp; j0 < hi; j0 += kWarps * kUnroll) {
    float kf[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWarps;
      if (holds && j < hi) {
        const Vec<Tc, E> kv = *reinterpret_cast<const Vec<Tc, E>*>(
            k + (row + j) * D + lane * E);
#pragma unroll
        for (int e = 0; e < E; ++e) kf[u][e] = to_f(kv.v[e]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWarps;
      if (j >= hi) break;                       // the same for the warp
#pragma unroll
      for (int h = 0; h < kGroupMax; ++h) {
        if (h >= gc) break;
        float part = 0.f;
        if (holds) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            part = __fadd_rn(part, __fmul_rn(qg[h][lane * E + e], kf[u][e]));
        }
        const float s = warp_sum(part);
        if (lane == 0) sc[(long long)h * S + j] = s;
        m_w[h] = fmaxf(m_w[h], s);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < kGroupMax; ++h) part_m[warp][h] = m_w[h];
  }
  __syncthreads();   // the scores and the partial maxima are visible
  float m[kGroupMax];
#pragma unroll
  for (int h = 0; h < kGroupMax; ++h) {
    m[h] = part_m[0][h];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m[h] = fmaxf(m[h], part_m[w][h]);
  }

  // pass 2: p, l and the PV sum over the warp's own positions, in order
  float l_w[kGroupMax], acc[kGroupMax][E];
#pragma unroll
  for (int h = 0; h < kGroupMax; ++h) {
    l_w[h] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.f;
  }
  for (int j0 = lo + warp; j0 < hi; j0 += kWarps * kUnroll) {
    float vf[kUnroll][E], sv[kUnroll][kGroupMax];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWarps;
      if (j < hi) {
        if (holds) {
          const Vec<Tc, E> vv = *reinterpret_cast<const Vec<Tc, E>*>(
              v + (row + j) * D + lane * E);
#pragma unroll
          for (int e = 0; e < E; ++e) vf[u][e] = to_f(vv.v[e]);
        }
#pragma unroll
        for (int h = 0; h < kGroupMax; ++h)
          if (h < gc) sv[u][h] = sc[(long long)h * S + j];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u * kWarps >= hi) break;
#pragma unroll
      for (int h = 0; h < kGroupMax; ++h) {
        if (h >= gc) break;
        const float p = expf(__fsub_rn(sv[u][h], m[h]));
        l_w[h] = __fadd_rn(l_w[h], p);
        const float pn = round_to<Tc>(p);
        if (holds) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[h][e] = __fadd_rn(acc[h][e], __fmul_rn(pn, vf[u][e]));
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < kGroupMax; ++h) {
    if (h >= gc) break;
    if (holds) {
#pragma unroll
      for (int e = 0; e < E; ++e) part_o[warp][h][lane * E + e] = acc[h][e];
    }
    if (lane == 0) part_l[warp][h] = l_w[h];
  }
  __syncthreads();

  // the warps' partials in warp order, then the division by l
  for (int i = threadIdx.x; i < gc * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float o = part_o[0][h][d], l = part_l[0][h];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      o = __fadd_rn(o, part_o[w][h][d]);
      l = __fadd_rn(l, part_l[w][h]);
    }
    out[((long long)b * Hq + h0 + h) * D + d] =
        from_f<Tq>(__fdiv_rn(o, l == 0.f ? 1.f : l));
  }
}

template <typename Tq, typename Tc>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 float* scores, const long long* kv_len, int kv_scalar, int B,
                 int Hq, int Hkv, int S, int D, int window, float scale,
                 cudaStream_t s) {
  // Heads a block: the whole group while B Hkv blocks fill the card, else
  // fewer, so that more blocks share the work (each head's arithmetic is
  // the same wherever it runs; its group's K / V are then read again, from
  // L2).
  static int sms = 0;                         // the card's SM count, once
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return cudaErrorInvalidValue;
  }
  const int g = Hq / Hkv;
  const int want = (2 * sms + B * Hkv - 1) / (B * Hkv);    // splits wanted
  const int hb = (g + (want < g ? want : g) - 1) / (want < g ? want : g);
  const int splits = (g + hb - 1) / hb;
  const dim3 grid(Hkv * splits, B);
  const Tq* qq = static_cast<const Tq*>(q);
  const Tc* kk = static_cast<const Tc*>(k);
  const Tc* vv = static_cast<const Tc*>(v);
  Tq* oo = static_cast<Tq*>(out);
#define D1_LAUNCH(DIM)                                                        \
  decode_attention_kernel<Tq, Tc, DIM><<<grid, kThreads, 0, s>>>(             \
      qq, kk, vv, oo, scores, kv_len, kv_scalar, Hq, Hkv, S, window, scale,  \
      hb)
  switch (D) {
    case 16: D1_LAUNCH(16); break;
    case 64: D1_LAUNCH(64); break;
    case 128: D1_LAUNCH(128); break;
    default: return cudaErrorInvalidValue;
  }
#undef D1_LAUNCH
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Launches D1 on `stream`; returns cudaGetLastError() after the launch (0 =
// launched).  q: contiguous (B, Hq, 1, D) of `q_dtype`; k, v: contiguous
// (B, Hkv, S, D) of `cache_dtype` (0 = float32, 1 = bfloat16), 16-byte
// aligned; out: (B, Hq, 1, D) of `q_dtype`; scores: (B, Hq, S) float32
// scratch; kv_len: (B,) int64 on the device, or null for `kv_scalar` on
// every row; window < 0 for none.  D must be 16, 64 or 128 and Hq / Hkv at
// most 8.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* out, float* scores, const long long* kv_len,
                            int kv_scalar, int B, int Hq, int Hkv, int S,
                            int D, int window, float scale, int q_dtype,
                            int cache_dtype, void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || Hkv > 65535 || Hq % Hkv ||
      Hq / Hkv > kGroupMax || S < 1 || !aligned16(k) || !aligned16(v))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && cache_dtype == kF32)
    return launch_typed<float, float>(q, k, v, out, scores, kv_len, kv_scalar,
                                      B, Hq, Hkv, S, D, window, scale, s);
  if (q_dtype == kBF16 && cache_dtype == kBF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, out, scores, kv_len, kv_scalar, B, Hq, Hkv, S, D, window,
        scale, s);
  if (q_dtype == kBF16 && cache_dtype == kF32)
    return launch_typed<__nv_bfloat16, float>(q, k, v, out, scores, kv_len,
                                              kv_scalar, B, Hq, Hkv, S, D,
                                              window, scale, s);
  if (q_dtype == kF32 && cache_dtype == kBF16)
    return launch_typed<float, __nv_bfloat16>(q, k, v, out, scores, kv_len,
                                              kv_scalar, B, Hq, Hkv, S, D,
                                              window, scale, s);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
