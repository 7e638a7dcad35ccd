// M1: a Mamba-2 layer's whole decode step, from the causal conv's output to
// the gated norm's input, for Hopper (sm_90a), batch-invariant.
//
// No TPU kernel to replace: the reference computes the one-token step as
// plain array code (src/repro/models/mamba2.py:132-135, :141-147,
// :149-151).  Per (batch, head), from the conv's output xs (d_in), the
// token's B and C (ns each), the projection's gate z (d_in) and raw dt
// (nh), all in the compute dtype T (bf16 or f32), and the layer's f32
// a_log, dt_bias and d_skip (nh), with the (hd, ns) f32 state h:
//   dt'      = softplus(dt + dt_bias)        (v > 20 ? v : log1pf(expf(v)))
//   e        = expf(-expf(a_log) * dt')
//   x[d]     = xs[d] * dt'
//   h'[d, s] = h[d, s] e + x[d] B[s]
//   y[d]     = sum_s C[s] h'[d, s], then + d_skip xs[d]
//   out[d]   = T(y[d]) * T(z[d] / (1 + expf(-z[d])))        rounded to T
// each product and sum one rounded __fmul_rn / __fadd_rn (no FMA
// contraction), each transcendental the CUDA function torch's own kernels
// call, each narrowing round to nearest even: bit for bit the PyTorch ops
// of kernels/ssd/ref.py `mamba_step_ordered` on the card, and h' bit for
// bit the plain `h0 * e + einsum(x, B)`.  y sums over s = 0, 1, ..., ns-1
// in that order from +0 in one thread: a function of the head alone, not
// of the batch, so a row's output is the same bits at any batch.
//
// Bound: bytes.  The state is read once and written once (2 x 16 KB a
// (batch, head) at (64, 64); 8.4 MB a layer at B 4, 64 heads: ~2.5 us at
// 3.35 TB/s); the inputs and the output are a few KB, and the ~5 hd ns
// operations a (batch, head) are nothing beside the bytes.
//
// Design: one block of NT threads a (batch, head); its (hd, ns) tile is
// contiguous (16 KB at (64, 64)) and moves as 16-byte pieces, consecutive
// lanes on consecutive pieces, so a warp's load or store is 512 contiguous
// bytes.  Each thread first issues its PER loads of the tile, then computes
// dt' and the decay while they are in flight; its pieces all lie in one
// column group (4 values of B), over PER rows.  It steps each value where
// it landed, stores h' back the same way and into a shared copy of the
// tile padded to ns + 1 floats a row, so that a warp walking a column (one
// row a lane) reads 32 banks; a half-warp's pieces on columns >= 32 store
// their two float pairs in swapped order, so the stores into the copy are
// conflict-free too.  Then thread d < hd sums y[d] over that row in order
// and writes out[d] with the gate.  Several blocks stay resident on an SM
// (~17 KB of shared memory each), so more than one tile is in flight per SM
// at any batch past one wave.  h' may be h itself (the step in place, into
// the model's cache): every value is read into a register by the thread
// that writes it, before it writes it, and no other thread touches it, so
// h0 and h1 carry no __restrict__.  Instances: (hd, ns) = (64, 64),
// zamba2-1.2b's, and (16, 16), its small config's, each in bf16 and f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the value torch holds after a cast to T
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return widen(narrow<T>(v));
}

template <typename T, int HD, int NS, int NT>
__global__ void __launch_bounds__(NT)
mamba_step_kernel(const T* __restrict__ xs, const T* __restrict__ bv,
                  const T* __restrict__ cv, const T* __restrict__ z,
                  const T* __restrict__ dt, const float* __restrict__ a_log,
                  const float* __restrict__ dt_bias,
                  const float* __restrict__ d_skip, const float* h0,
                  T* __restrict__ out, float* h1, int nh, long long sxs,
                  long long sb, long long sc, long long sz, long long sdt) {
  constexpr int Q = NS / 4;           // 16-byte pieces a state row
  constexpr int PER = HD * Q / NT;    // pieces a thread
  static_assert(NS % 4 == 0 && HD * Q % NT == 0 && NT % Q == 0 && HD <= NT,
                "a thread's pieces share one column group");
  __shared__ float sh[HD * (NS + 1)];
  __shared__ float sc_s[NS];
  const int t = threadIdx.x;
  const long long bh = blockIdx.x;
  const long long row = bh / nh;
  const int head = static_cast<int>(bh - row * nh);
  const float4* src = reinterpret_cast<const float4*>(h0) + bh * (HD * Q);
  float4 hv[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) hv[j] = __ldcs(src + t + NT * j);

  const float v = __fadd_rn(widen(dt[row * sdt + head]), dt_bias[head]);
  const float dtp = v > 20.f ? v : log1pf(expf(v));
  const float e = expf(__fmul_rn(-expf(a_log[head]), dtp));
  for (int s = t; s < NS; s += NT) sc_s[s] = widen(cv[row * sc + s]);
  const int q = t % Q;
  const T* brow = bv + row * sb + 4 * q;
  const float b0 = widen(brow[0]), b1 = widen(brow[1]), b2 = widen(brow[2]),
              b3 = widen(brow[3]);
  const T* xrow = xs + row * sxs + static_cast<long long>(head) * HD;
  float4* dst = reinterpret_cast<float4*>(h1) + bh * (HD * Q);
  const int swap = (q & 8) ? 2 : 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int k = t + NT * j;
    const int d = k / Q;
    const float xd = __fmul_rn(widen(xrow[d]), dtp);
    float4 n;
    n.x = __fadd_rn(__fmul_rn(hv[j].x, e), __fmul_rn(xd, b0));
    n.y = __fadd_rn(__fmul_rn(hv[j].y, e), __fmul_rn(xd, b1));
    n.z = __fadd_rn(__fmul_rn(hv[j].z, e), __fmul_rn(xd, b2));
    n.w = __fadd_rn(__fmul_rn(hv[j].w, e), __fmul_rn(xd, b3));
    __stcs(dst + k, n);
    float* to = sh + d * (NS + 1) + 4 * q;
    const float2 lo = make_float2(n.x, n.y), hi = make_float2(n.z, n.w);
    const float2 first = swap ? hi : lo, second = swap ? lo : hi;
    to[swap] = first.x;
    to[swap + 1] = first.y;
    to[swap ^ 2] = second.x;
    to[(swap ^ 2) + 1] = second.y;
  }
  __syncthreads();
  if (t < HD) {
    const float* hrow = sh + t * (NS + 1);
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      acc = __fadd_rn(acc, __fmul_rn(sc_s[s], hrow[s]));
    const float y = round_to<T>(
        __fadd_rn(acc, __fmul_rn(d_skip[head], widen(xrow[t]))));
    const float zd = widen(z[row * sz + static_cast<long long>(head) * HD + t]);
    const float gate = round_to<T>(__fdiv_rn(zd, __fadd_rn(1.f, expf(-zd))));
    out[(row * nh + head) * HD + t] = narrow<T>(__fmul_rn(y, gate));
  }
}

template <typename T, int HD, int NS, int NT>
int launch(const void* xs, const void* b, const void* c, const void* z,
           const void* dt, const float* a_log, const float* dt_bias,
           const float* d_skip, const float* h0, void* out, float* h1, int B,
           int nh, long long sxs, long long sb, long long sc, long long sz,
           long long sdt, cudaStream_t s) {
  mamba_step_kernel<T, HD, NS, NT>
      <<<static_cast<unsigned>(B * nh), NT, 0, s>>>(
          static_cast<const T*>(xs), static_cast<const T*>(b),
          static_cast<const T*>(c), static_cast<const T*>(z),
          static_cast<const T*>(dt), a_log, dt_bias, d_skip, h0,
          static_cast<T*>(out), h1, nh, sxs, sb, sc, sz, sdt);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* xs, const void* b, const void* c, const void* z,
             const void* dt, const float* a_log, const float* dt_bias,
             const float* d_skip, const float* h0, void* out, float* h1,
             int B, int nh, int hd, int ns, long long sxs, long long sb,
             long long sc, long long sz, long long sdt, cudaStream_t s) {
  if (hd == 64 && ns == 64)
    return launch<T, 64, 64, 128>(xs, b, c, z, dt, a_log, dt_bias, d_skip,
                                  h0, out, h1, B, nh, sxs, sb, sc, sz, sdt,
                                  s);
  if (hd == 16 && ns == 16)
    return launch<T, 16, 16, 64>(xs, b, c, z, dt, a_log, dt_bias, d_skip,
                                 h0, out, h1, B, nh, sxs, sb, sc, sz, sdt, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches M1 on `stream`; returns cudaGetLastError() after the launch (0 =
// launched), cudaErrorInvalidValue for a shape or dtype without an
// instance.  xs, z: (B, d_in = nh hd) rows; b, c: (B, ns) rows; dt: (B,
// nh) rows; each row's elements contiguous, rows `s*` elements apart, all
// in the dtype `dtype` (0 float32, 1 bfloat16); a_log, dt_bias, d_skip:
// contiguous (nh) float32; h0, h1: contiguous (B, nh, hd, ns) float32
// starting on 16 bytes, h1 either h0 itself or not overlapping it; out:
// contiguous (B, d_in) in `dtype`.
int ssd_step_launch(const void* xs, const void* b, const void* c,
                    const void* z, const void* dt, const float* a_log,
                    const float* dt_bias, const float* d_skip,
                    const float* h0, void* out, float* h1, int B, int nh,
                    int hd, int ns, long long sxs, long long sb,
                    long long sc, long long sz, long long sdt, int dtype,
                    void* stream) {
  if (B < 1 || nh < 1 || (long long)B * nh > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(xs, b, c, z, dt, a_log, dt_bias, d_skip, h0, out,
                           h1, B, nh, hd, ns, sxs, sb, sc, sz, sdt, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(xs, b, c, z, dt, a_log, dt_bias, d_skip,
                                   h0, out, h1, B, nh, hd, ns, sxs, sb, sc,
                                   sz, sdt, s);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
