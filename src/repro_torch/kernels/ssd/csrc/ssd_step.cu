// M1: one Mamba-2 decode step of the SSD recurrence for Hopper (sm_90a),
// batch-invariant.
//
// No TPU kernel to replace: the reference computes the one-token step as
// plain array code (src/repro/models/mamba2.py:144-147).  Per (batch, head),
// with the dt-scaled input x (hd), the decay e = exp(a dt), the token's B
// and C (ns each) and the (hd, ns) f32 state h:
//   h'[d, s] = h[d, s] e + x[d] B[s]
//   y[d]     = sum_s C[s] h'[d, s]
// h' is one rounded product h e, one rounded product x B and their rounded
// sum (__fmul_rn, __fadd_rn: no FMA contraction), bit for bit the plain
// `h0 * e + einsum(x, B)`.  y sums over s = 0, 1, ..., ns - 1 in that
// order from +0, every product and sum rounded on its own: a function of
// the head alone, not of the batch, so a row's y is the same bits at any
// batch (kernels/ssd/ref.py `ssd_step_ordered`); a library's batched
// product picks its kernel, and so its order, by the batch.
//
// Bound: bytes.  The state is read once and written once (2 x 16 KB a
// (batch, head) at (64, 64); 8.4 MB a layer at B 4, 64 heads: ~2.5 us at
// 3.35 TB/s); the 4 x 64 x 64 operations a (batch, head) are nothing
// beside it.
//
// Design: one block of hd threads a (batch, head), thread d owning row d of
// the state.  B, C and the decay go to shared memory; thread d loads its ns
// state values at once as 16-byte pieces (independent loads, every 32-byte
// sector used whole across two of them), steps them, sums y[d] as it goes,
// and stores the row back as 16-byte pieces.  h' may be h itself (the step
// in place, into the model's cache): thread d holds all of row d in
// registers before it writes any of it, and no other thread reads or
// writes that row, so h0 and h1 carry no __restrict__.  Instances: (hd, ns)
// = (64, 64), zamba2-1.2b's, and (16, 16), its small config's.
#include <cuda_runtime.h>

namespace {

template <int HD, int NS>
__global__ void __launch_bounds__(HD)
ssd_step_kernel(const float* __restrict__ x, const float* __restrict__ e,
                const float* __restrict__ b, const float* __restrict__ c,
                const float* h0, float* __restrict__ y, float* h1, int nh) {
  static_assert(NS % 4 == 0, "rows are loaded as 16-byte pieces");
  __shared__ float sb[NS], sc[NS];
  const int d = threadIdx.x;
  const long long bh = blockIdx.x;
  const long long row = bh / nh;
  for (int s = d; s < NS; s += HD) {
    sb[s] = b[row * NS + s];
    sc[s] = c[row * NS + s];
  }
  const float xd = x[bh * HD + d];
  const float ed = e[bh];
  const long long o = (bh * HD + d) * NS;
  const float4* src = reinterpret_cast<const float4*>(h0 + o);
  float hv[NS];
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    const float4 t = src[j];
    hv[4 * j] = t.x;
    hv[4 * j + 1] = t.y;
    hv[4 * j + 2] = t.z;
    hv[4 * j + 3] = t.w;
  }
  __syncthreads();
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    hv[s] = __fadd_rn(__fmul_rn(hv[s], ed), __fmul_rn(xd, sb[s]));
    acc = __fadd_rn(acc, __fmul_rn(sc[s], hv[s]));
  }
  float4* dst = reinterpret_cast<float4*>(h1 + o);
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
    dst[j] = make_float4(hv[4 * j], hv[4 * j + 1], hv[4 * j + 2],
                         hv[4 * j + 3]);
  y[bh * HD + d] = acc;
}

template <int HD, int NS>
int launch(const float* x, const float* e, const float* b, const float* c,
           const float* h0, float* y, float* h1, int B, int nh,
           cudaStream_t s) {
  ssd_step_kernel<HD, NS><<<static_cast<unsigned>(B * nh), HD, 0, s>>>(
      x, e, b, c, h0, y, h1, nh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches M1 on `stream`; returns cudaGetLastError() after the launch (0 =
// launched), cudaErrorInvalidValue for a shape without an instance.  x, y:
// contiguous (B, nh, hd) float32; e: (B, nh); b, c: (B, ns); h0, h1: (B,
// nh, hd, ns) float32 starting on 16 bytes, h1 either h0 itself or not
// overlapping it.
int ssd_step_launch(const float* x, const float* e, const float* b,
                    const float* c, const float* h0, float* y, float* h1,
                    int B, int nh, int hd, int ns, void* stream) {
  if (B < 1 || nh < 1 || (long long)B * nh > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64 && ns == 64) return launch<64, 64>(x, e, b, c, h0, y, h1, B,
                                                  nh, s);
  if (hd == 16 && ns == 16) return launch<16, 16>(x, e, b, c, h0, y, h1, B,
                                                  nh, s);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
