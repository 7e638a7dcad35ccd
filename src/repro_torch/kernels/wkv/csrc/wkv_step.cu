// W1: one RWKV-6 decode step of the WKV recurrence for Hopper (sm_90a),
// batch-invariant.
//
// No TPU kernel to replace: the reference computes the one-token step as
// plain array code (src/repro/models/rwkv6.py:145-150).  Per (batch, head),
// with r, k, v and the decay e = exp(w_log) of one token (64 channels each)
// and the (64, 64) f32 state S:
//   y[d]     = sum_t r[t] S[t, d] + (sum_t (r[t] u[t]) k[t]) v[d]
//   S'[t, d] = S[t, d] e[t] + k[t] v[d]
// Each sum runs over t = 0, 1, ..., 63 in that order, every product and
// every sum rounded to f32 on its own (__fmul_rn, __fadd_rn: no FMA
// contraction).  That order is a function of the head alone, not of the
// batch, so a row's y and S' are the same bits at any batch; a library's
// batched product picks its kernel, and so its order, by the batch.  S' is
// bit for bit the plain `s0 * e[..., None] + k[..., :, None] *
// v[..., None, :]` (one rounded product each, one rounded sum), and y is
// bit for bit `kernels/wkv/ref.py` `wkv_step_ordered`.
//
// Bound: bytes.  The state is read once and written once (32 KB a
// (batch, head); 8.4 MB a layer at B 4, 64 heads: ~2.5 us at 3.35 TB/s);
// the 3 x 64 x 64 operations a (batch, head) are nothing beside it.
//
// Design: one block of 64 threads a (batch, head), thread d owning column
// d of the state.  The token's r, r u, k and e go to shared memory; thread
// d loads its 64 state values at once (independent loads, coalesced across
// the block: a row of S is 256 contiguous bytes), sums r S down its
// column, writes its column of S' and y[d].  Every thread sums the bonus
// (r u) . k itself, in the same order, from shared memory.  S' may be S
// itself (the step in place, into the model's cache): thread d holds all
// of column d in registers before it writes any of it, and no other
// thread reads or writes that column, so s0 and s1 carry no __restrict__.
#include <cuda_runtime.h>

namespace {

constexpr int kHD = 64;

__global__ void __launch_bounds__(kHD)
wkv_step_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ e,
                const float* __restrict__ u, const float* s0,
                float* __restrict__ y, float* s1, int nh) {
  __shared__ float sr[kHD], sru[kHD], sk[kHD], se[kHD];
  const int d = threadIdx.x;
  const long long bh = blockIdx.x;
  const int h = static_cast<int>(bh % nh);
  const long long o = bh * kHD;
  const float rd = r[o + d];
  sr[d] = rd;
  sru[d] = __fmul_rn(rd, u[h * kHD + d]);
  sk[d] = k[o + d];
  se[d] = e[o + d];
  const float vd = v[o + d];
  const float* S = s0 + o * kHD;
  float col[kHD];
#pragma unroll
  for (int t = 0; t < kHD; ++t) col[t] = S[t * kHD + d];
  __syncthreads();
  float acc = 0.f, bonus = 0.f;
#pragma unroll
  for (int t = 0; t < kHD; ++t) {
    acc = __fadd_rn(acc, __fmul_rn(sr[t], col[t]));
    bonus = __fadd_rn(bonus, __fmul_rn(sru[t], sk[t]));
  }
  float* S1 = s1 + o * kHD;
#pragma unroll
  for (int t = 0; t < kHD; ++t)
    S1[t * kHD + d] = __fadd_rn(__fmul_rn(col[t], se[t]),
                                __fmul_rn(sk[t], vd));
  y[o + d] = __fadd_rn(acc, __fmul_rn(bonus, vd));
}

}  // namespace

extern "C" {

// Launches W1 on `stream`; returns cudaGetLastError() after the launch (0 =
// launched).  r, k, v, e: contiguous (B, nh, 64) float32; u: (nh, 64)
// float32; s0: (B, nh, 64, 64) float32; y: (B, nh, 64) float32; s1: (B, nh,
// 64, 64) float32, either s0 itself or not overlapping it.
int wkv_step_launch(const float* r, const float* k, const float* v,
                    const float* e, const float* u, const float* s0, float* y,
                    float* s1, int B, int nh, int hd, void* stream) {
  if (hd != kHD || B < 1 || nh < 1 || (long long)B * nh > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wkv_step_kernel<<<static_cast<unsigned>(B * nh), kHD, 0, s>>>(
      r, k, v, e, u, s0, y, s1, nh);
  return cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
