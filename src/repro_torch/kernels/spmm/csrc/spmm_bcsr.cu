// K2: batched BCSR x dense SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `spmm_bcsr` / `_spmm_kernel` in
// src/repro/kernels/spmm/kernel.py: C[b] = A[b] @ dense[b], where every A[b]
// is streamed as (row, col)-sorted BCSR blocks sharing one index stream.  On
// the TPU the grid walked the stream in order and kept the output tile
// resident in VMEM across a block-row's run; here blocks run in parallel in
// no order, so one thread block owns one (batch b, block-row r, N-tile) and
// walks its row's slice indptr[r]..indptr[r+1] of the stream with the
// accumulator in registers.  Nothing carries between thread blocks: no
// atomics, so the result is deterministic, and an empty row writes zeros.
//
// Accumulation follows the Pallas body `o += dot(a, b, f32).astype(o)`: each
// stream entry's block product is computed in f32, rounded to the output
// type, and added to the accumulator, which is rounded to the output type
// again.  The accumulator lives in an f32 register; for an f32 output both
// roundings are the identity, for bf16 they reproduce the reference's
// per-entry rounding, so a 0/1 dispatch stream copies bf16 rows exactly.
//
// Bound: bytes.  Each stream entry reads its (bm, bk) block and the (bk,
// tile) slice of dense it selects, and the tile is written once; at bm = 8
// that is 8 multiply-adds per dense element read, far below the ~300 flops
// per byte at which the tensor cores would become the limit.  The design
// therefore spends nothing on tensor cores: one thread per output column,
// BM f32 accumulators per thread, the block staged in shared memory and
// read as a broadcast, dense rows read coalesced along N.
//
// K2q, the quantized variant (`_spmm_quant_kernel`, the same Pallas call
// with `scales`): blocks of fp8 e4m3 / e5m2 or int8 with one f32 scale per
// (batch, stream entry).  Each value is dequantized as it is staged in
// shared memory, `__fmul_rn(float(q), scale)` -- the host's
// `values.float() * scale` -- and the f32-block path runs unchanged, so K2q
// equals K2 on host-dequantized blocks bit for bit.  Only what the library
// reaches is instantiated: narrow blocks x f32 / bf16 dense -> f32 out.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kE4M3 = 2;
constexpr int kE5M2 = 3;
constexpr int kI8 = 4;
constexpr int kMaxBK = 32;

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

template <typename T>
struct Out;

template <>
struct Out<float> {
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <>
struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

struct Args {
  const int32_t* indptr;      // (gm + 1,)
  const int32_t* block_cols;  // (nnzb,)
  const void* blocks;         // (B, nnzb, BM, bk)
  const float* scales;        // (B, nnzb) for narrow blocks, else null
  const void* dense;          // (B, K, N)
  void* out;                  // (B, gm * BM, N)
  int batch, gm, nnzb, bk, K, N, bn;
  cudaStream_t stream;
};

// grid (ceil(N / bn), gm, B), block (bn): thread x owns output column
// n = blockIdx.x * bn + x of the BM rows of block-row blockIdx.y.
template <int BM, typename TA, typename TB, typename TO>
__global__ void spmm_bcsr_kernel(const int32_t* __restrict__ indptr,
                                 const int32_t* __restrict__ block_cols,
                                 const TA* __restrict__ blocks,
                                 const float* __restrict__ scales,
                                 const TB* __restrict__ dense,
                                 TO* __restrict__ out, int nnzb, int bk,
                                 int K, int N) {
  __shared__ float a_s[BM * kMaxBK];
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  const bool active = n < N;
  const int start = indptr[r];
  const int end = indptr[r + 1];
  const TA* blocks_b = blocks + (size_t)b * nnzb * BM * bk;
  const TB* dense_b = dense + (size_t)b * K * N;

  float acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;

  for (int i = start; i < end; ++i) {
    __syncthreads();  // the previous entry's block is no longer read
    const TA* a = blocks_b + (size_t)i * BM * bk;
    if (scales == nullptr) {
      for (int j = threadIdx.x; j < BM * bk; j += blockDim.x)
        a_s[j] = to_f32(a[j]);
    } else {  // K2q: dequantize as staged
      const float s = scales[(size_t)b * nnzb + i];
      for (int j = threadIdx.x; j < BM * bk; j += blockDim.x)
        a_s[j] = __fmul_rn(to_f32(a[j]), s);
    }
    __syncthreads();
    if (active) {
      const TB* d = dense_b + (size_t)block_cols[i] * bk * N + n;
      float p[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) p[m] = 0.f;
      for (int k = 0; k < bk; ++k) {
        const float x = to_f32(d[(size_t)k * N]);
#pragma unroll
        for (int m = 0; m < BM; ++m) p[m] = fmaf(a_s[m * bk + k], x, p[m]);
      }
#pragma unroll
      for (int m = 0; m < BM; ++m)
        acc[m] = Out<TO>::round(acc[m] + Out<TO>::round(p[m]));
    }
  }
  if (active) {
    TO* o = out + ((size_t)b * gridDim.y + r) * BM * N + n;
#pragma unroll
    for (int m = 0; m < BM; ++m) o[(size_t)m * N] = Out<TO>::store(acc[m]);
  }
}

template <int BM, typename TA, typename TB, typename TO>
cudaError_t launch(const Args& a) {
  dim3 grid((a.N + a.bn - 1) / a.bn, a.gm, a.batch);
  spmm_bcsr_kernel<BM, TA, TB, TO><<<grid, a.bn, 0, a.stream>>>(
      a.indptr, a.block_cols, static_cast<const TA*>(a.blocks), a.scales,
      static_cast<const TB*>(a.dense), static_cast<TO*>(a.out), a.nnzb, a.bk,
      a.K, a.N);
  return cudaGetLastError();
}

template <int BM, typename TA, typename TB>
cudaError_t dispatch_out(const Args& a, int o_dtype) {
  if (o_dtype == kF32) return launch<BM, TA, TB, float>(a);
  if (o_dtype == kBF16) return launch<BM, TA, TB, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

template <int BM, typename TA>
cudaError_t dispatch_dense(const Args& a, int b_dtype, int o_dtype) {
  if (b_dtype == kF32) return dispatch_out<BM, TA, float>(a, o_dtype);
  if (b_dtype == kBF16) return dispatch_out<BM, TA, __nv_bfloat16>(a, o_dtype);
  return cudaErrorInvalidValue;
}

// K2q: narrow blocks, f32 output only
template <int BM, typename TA>
cudaError_t dispatch_quant(const Args& a, int b_dtype, int o_dtype) {
  if (a.scales == nullptr || o_dtype != kF32) return cudaErrorInvalidValue;
  if (b_dtype == kF32) return launch<BM, TA, float, float>(a);
  if (b_dtype == kBF16) return launch<BM, TA, __nv_bfloat16, float>(a);
  return cudaErrorInvalidValue;
}

template <int BM>
cudaError_t dispatch_blocks(const Args& a, int a_dtype, int b_dtype,
                            int o_dtype) {
  if (a.scales != nullptr && (a_dtype == kF32 || a_dtype == kBF16))
    return cudaErrorInvalidValue;
  switch (a_dtype) {
    case kF32: return dispatch_dense<BM, float>(a, b_dtype, o_dtype);
    case kBF16: return dispatch_dense<BM, __nv_bfloat16>(a, b_dtype, o_dtype);
    case kE4M3: return dispatch_quant<BM, __nv_fp8_e4m3>(a, b_dtype, o_dtype);
    case kE5M2: return dispatch_quant<BM, __nv_fp8_e5m2>(a, b_dtype, o_dtype);
    case kI8: return dispatch_quant<BM, int8_t>(a, b_dtype, o_dtype);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream`; returns cudaGetLastError() after the launch (0 =
// launched).  dtype codes: 0 = float32, 1 = bfloat16; blocks also 2 = fp8
// e4m3, 3 = fp8 e5m2, 4 = int8, which take `scales` (B, nnzb) f32 and an
// f32 output (K2q); wide blocks take scales = null.  bm must be 8 or 16,
// 1 <= bk <= 32, 32 <= bn <= 1024 with bn % 32 == 0.
int spmm_bcsr_launch(const int32_t* indptr, const int32_t* block_cols,
                     const void* blocks, const float* scales,
                     const void* dense, void* out,
                     int batch, int gm, int nnzb, int bm, int bk, int K,
                     int N, int bn, int a_dtype, int b_dtype, int o_dtype,
                     void* stream) {
  if (bk < 1 || bk > kMaxBK || bn < 32 || bn > 1024 || bn % 32 != 0 ||
      batch < 1 || gm < 1 || N < 1)
    return cudaErrorInvalidValue;
  Args a{indptr, block_cols, blocks, scales, dense, out, batch, gm, nnzb, bk,
         K, N, bn, static_cast<cudaStream_t>(stream)};
  if (bm == 8) return dispatch_blocks<8>(a, a_dtype, b_dtype, o_dtype);
  if (bm == 16) return dispatch_blocks<16>(a, a_dtype, b_dtype, o_dtype);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
