// K5: SpMSpM over padded-ELL index streams for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `spmspm_ell` / `_spmspm_kernel` (and
// `_spmspm_quant_kernel`) in src/repro/kernels/spmspm/kernel.py:
// C[r, c] = sum of a * b over the keys that A's row r (keys (R, La)) and
// B's column c (keys (C, Lb)) share, each stream ascending and padded with
// INVALID_KEY; optional per-row f32 `a_scales` dequantize narrow A values.
//
// The TPU kernel compares all pairs, (rt x ct x lb) keys per step of a
// serial walk over A's `la` stream.  Only a few keys of a pair match, so on
// a GPU that walk pays for B's whole key stream per output element.  Here
// the work follows the matches instead (Gustavson's row-wise product):
// C[r, :] = sum over A's row r, in stream order, of a * B[k, :].
//
// 1. B is bucketed on the card on every call: three small kernels count
//    B's entries per (key k, slab s of W output columns), scan the counts
//    into bucket offsets (one block), and scatter each (column, value as
//    f32) into bucket (k - kmin) * slabs + s.  The order inside a bucket is
//    free: B's keys are unique within a column, so one key's entries lie
//    on distinct columns.  A fourth kernel finds [kmin, kmax], the range of
//    B's valid keys that sizes the table (the wrapper reads it to the
//    host).
// 2. One warp per (A row, slab): the warp zeroes a W-float accumulator in
//    shared memory and walks its row 32 keys at a time: one lane per key
//    loads the key's bucket bounds, the live keys (non-empty buckets) are
//    staged in stream order, and for each the lanes take the bucket's
//    entries and add `a * b` into `acc[c - s * W]`, with a `__syncwarp()`
//    between keys.  Entry loads run `kDepth` keys ahead of the adds (a
//    register ring), and the next 32 keys load while this group runs.  At
//    the end the warp writes its slab to `out` once, with streaming 16-byte
//    stores.
//
// Why the sums are the reference's, bit for bit: C[r, c] receives one
// rounded `a * b` per key that row r and column c share, added in the order
// of A's stream (the `la` order of `_spmspm_kernel`), and nothing else.
// Within one key the lanes write distinct columns, so their order cannot
// change a bit; between keys `__syncwarp()` orders the adds to a shared
// column.  A key of A outside B's range, or whose bucket is empty, adds
// nothing, and an entry of B (an Inf or NaN too) whose key A's row lacks
// is never read -- no 0 * b term that would turn an Inf into a NaN.
//
// Numerics: `__fmul_rn` / `__fadd_rn` (no FMA contraction), and narrow A
// values dequantize as `__fmul_rn(float(q), scale)` before the product --
// the host's `values.float() * scale` -- so the quantized path equals the
// f32 path on host-dequantized values bit for bit.
//
// Bound: bytes (the dense (R, C) f32 output, written once, dominates the
// inputs).  The work is one shared-memory add per key match; the bucket
// reads come mostly from L2 (B's bucketed copy is small), and each key's
// chain (bounds, then entries) is latency that the warps in flight and the
// entry ring hide.  On an H100 at 8192^2 (A 5 %, B 1 %) the product runs
// ~9x the bytes bound and no one part dominates it (tools/
// compare_spmspm.py with a pass removed: without the entry loads -18 %,
// without bank conflicts -5 %; a ring of 8 keys was 2-6 % faster than 4
// and 7-14 % than 2, one of 16 spilled and lost): what is left is the
// per-key chain of ~13 M key steps -- stage read, compare, shared load,
// add, store, warp sync -- at ~24 warps an SM, which the 8 KB accumulator
// of a 2048-column slab allows.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int32_t kInvalid = 0x7fffffff;
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kE4M3 = 2;
constexpr int kE5M2 = 3;
constexpr int kI8 = 4;
constexpr int kMaxRows = 32;            // warps (A rows) per product block
constexpr int kDepth = 8;               // keys whose entries load ahead
constexpr int kStageBytes = 32 * 16;    // a warp's staged live keys
constexpr int kThreads = 256;           // threads of the bucketing kernels
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr long long kMaxBuckets = 1ll << 26;
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

// range[0] = min, range[1] = max over the valid keys of keys[0, n); the
// caller presets range to (0x7f7f7f7f, 0x80808080), so with no valid key
// range[1] < range[0], and otherwise [range[0], range[1]] holds every valid
// key (range[0] is the true minimum unless every key is >= 0x7f7f7f7f).
__global__ void key_range_kernel(const int32_t* __restrict__ keys,
                                 long long n, int32_t* __restrict__ range) {
  int lo = INT_MAX, hi = INT_MIN;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = keys[i];
    if (k != kInvalid) {
      lo = min(lo, k);
      hi = max(hi, k);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, o));
    hi = max(hi, __shfl_xor_sync(kFull, hi, o));
  }
  if ((threadIdx.x & 31) == 0 && lo <= hi) {
    atomicMin(&range[0], lo);
    atomicMax(&range[1], hi);
  }
}

// The bucket of B's slot i (column i / Lb), or -1 for a pad.
__device__ __forceinline__ int bucket_of(int key, long long i, int Lb,
                                         int kmin, int nkeys, int W,
                                         int slabs, int* col) {
  const long long d = (long long)key - kmin;
  if (key == kInvalid || d < 0 || d >= nkeys) return -1;
  *col = (int)(i / Lb);
  return (int)d * slabs + *col / W;
}

__global__ void bucket_count_kernel(const int32_t* __restrict__ b_keys,
                                    long long n, int Lb, int kmin, int nkeys,
                                    int W, int slabs,
                                    int32_t* __restrict__ counts) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int c;
  const int b = bucket_of(b_keys[i], i, Lb, kmin, nkeys, W, slabs, &c);
  if (b >= 0) atomicAdd(&counts[b], 1);
}

// One block: offsets[b] = sum of counts[0, b) for b in [0, nb]; counts are
// zeroed for the scatter's cursors.
__global__ void __launch_bounds__(kScanThreads)
bucket_scan_kernel(int32_t* __restrict__ counts,
                   int32_t* __restrict__ offsets, int nb) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int carry = 0;
  for (int base = 0; base < nb; base += blockDim.x * kScanItems) {
    const int i0 = base + threadIdx.x * kScanItems;
    int v[kScanItems];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      v[j] = i0 + j < nb ? counts[i0 + j] : 0;
      sum += v[j];
    }
    int x = sum;  // inclusive scan over the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int ws = lane < n_warps ? warp_sums[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, ws, o);
        if (lane >= o) ws += y;
      }
      if (lane < n_warps) warp_sums[lane] = ws;
    }
    __syncthreads();
    int excl = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - sum;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (i0 + j < nb) {
        offsets[i0 + j] = excl;
        counts[i0 + j] = 0;
      }
      excl += v[j];
    }
    carry += warp_sums[n_warps - 1];
    __syncthreads();  // warp_sums is rewritten by the next tile
  }
  if (threadIdx.x == 0) offsets[nb] = carry;
}

template <typename TB>
__global__ void bucket_scatter_kernel(const int32_t* __restrict__ b_keys,
                                      const TB* __restrict__ b_vals,
                                      long long n, int Lb, int kmin,
                                      int nkeys, int W, int slabs,
                                      const int32_t* __restrict__ offsets,
                                      int32_t* __restrict__ cursors,
                                      int2* __restrict__ entries) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int c;
  const int b = bucket_of(b_keys[i], i, Lb, kmin, nkeys, W, slabs, &c);
  if (b < 0) return;
  const int pos = offsets[b] + atomicAdd(&cursors[b], 1);
  entries[pos] = make_int2(c, __float_as_int(to_f32(b_vals[i])));
}

// The entries this lane takes of staged key t (none past the live ones).
__device__ __forceinline__ int2 fetch(const int4* stage,
                                      const int2* __restrict__ entries, int t,
                                      int n_live, int lane) {
  if (t < n_live) {
    const int4 st = stage[t];
    if (lane < st.y) return entries[st.x + lane];
  }
  return make_int2(0, 0);
}

__device__ __forceinline__ void add(float* acc, int2 e, float a, int c0) {
  float* p = acc + (e.x - c0);
  *p = __fadd_rn(*p, __fmul_rn(a, __int_as_float(e.y)));
}

// grid slabs * ceil(R / rows) (slab fastest, so the slabs of one row run
// side by side), block rows * 32; dynamic shared memory rows * (W floats +
// kStageBytes).
template <typename TA>
__global__ void __launch_bounds__(kMaxRows * 32)
spmspm_row_kernel(const int32_t* __restrict__ a_keys,
                  const TA* __restrict__ a_vals,
                  const float* __restrict__ a_scales,
                  const int32_t* __restrict__ offsets,
                  const int2* __restrict__ entries, float* __restrict__ out,
                  int R, int La, int C, int kmin, int nkeys, int W,
                  int slabs) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = blockDim.x >> 5;
  const int s = blockIdx.x % slabs;
  const int r = (blockIdx.x / slabs) * rows + warp;
  if (r >= R) return;
  float* acc = reinterpret_cast<float*>(smem) + (size_t)warp * W;
  float4* acc4 = reinterpret_cast<float4*>(acc);
  int4* stage = reinterpret_cast<int4*>(reinterpret_cast<float*>(smem) +
                                        (size_t)rows * W) + warp * 32;
  const int c0 = s * W;
  const int w = min(W, C - c0);
  for (int i = lane; i < W / 4; i += 32)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const float scale = a_scales != nullptr ? a_scales[r] : 1.f;
  const int32_t* ak = a_keys + (size_t)r * La;
  const TA* av = a_vals + (size_t)r * La;
  const unsigned below = (1u << lane) - 1u;
  int key = lane < La ? ak[lane] : kInvalid;
  TA val = av[min(lane, La - 1)];
  for (int p0 = 0; p0 < La; p0 += 32) {
    // this group's bucket bounds, one key a lane
    const long long d = (long long)key - kmin;
    int lo = 0, n = 0;
    if (key != kInvalid && d >= 0 && d < nkeys) {
      const int b = (int)d * slabs + s;
      lo = offsets[b];
      n = offsets[b + 1] - lo;
    }
    float a = to_f32(val);
    if (a_scales != nullptr) a = __fmul_rn(a, scale);
    if (p0 + 32 < La) {  // the next group loads while this one runs
      const int p = p0 + 32 + lane;
      key = p < La ? ak[p] : kInvalid;
      val = av[min(p, La - 1)];
    }
    // the live keys (non-empty buckets) staged in stream order
    const unsigned live = __ballot_sync(kFull, n > 0);
    const int n_live = __popc(live);
    if (n > 0)
      stage[__popc(live & below)] = make_int4(lo, n, __float_as_int(a), 0);
    __syncwarp();
    int2 e[kDepth];
#pragma unroll
    for (int j = 0; j < kDepth; ++j)
      e[j] = fetch(stage, entries, j, n_live, lane);
    for (int t0 = 0; t0 < n_live; t0 += kDepth) {
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        const int t = t0 + j;
        if (t >= n_live) break;
        const int4 st = stage[t];
        const int2 cur = e[j];
        e[j] = fetch(stage, entries, t + kDepth, n_live, lane);
        const float ka = __int_as_float(st.z);
        if (lane < st.y) add(acc, cur, ka, c0);
        for (int q = 32 + lane; q < st.y; q += 32)  // buckets over 32
          add(acc, entries[st.x + q], ka, c0);
        __syncwarp();  // the next key's adds come after this key's
      }
    }
  }
  __syncwarp();
  float* orow = out + (size_t)r * C + c0;
  if ((C & 3) == 0) {  // rows and slabs start on 16 bytes
    float4* o4 = reinterpret_cast<float4*>(orow);
    for (int i = lane; i < w / 4; i += 32) __stcs(o4 + i, acc4[i]);
  } else {
    for (int i = lane; i < w; i += 32) __stcs(orow + i, acc[i]);
  }
}

size_t product_smem(int rows, int W) {
  return (size_t)rows * ((size_t)W * 4 + kStageBytes);
}

template <typename TA>
cudaError_t launch_product(const int32_t* a_keys, const void* a_vals,
                           const float* a_scales, const int32_t* offsets,
                           const void* entries, float* out, int R, int La,
                           int C, int kmin, int nkeys, int W, int rows,
                           cudaStream_t stream) {
  const size_t smem = product_smem(rows, W);
  cudaError_t err = cudaFuncSetAttribute(
      spmspm_row_kernel<TA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(spmspm_row_kernel<TA>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int slabs = (C + W - 1) / W;
  const long long grid = (long long)slabs * ((R + rows - 1) / rows);
  spmspm_row_kernel<TA><<<(unsigned)grid, rows * 32, smem, stream>>>(
      a_keys, static_cast<const TA*>(a_vals), a_scales, offsets,
      static_cast<const int2*>(entries), out, R, La, C, kmin, nkeys, W,
      slabs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Presets range (2 int32) and launches the key-range kernel over keys[0, n)
// on `stream`; returns cudaGetLastError() (0 = launched).
int spmspm_ell_key_range(const int32_t* keys, long long n, int32_t* range,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(range, 0x7f, 4, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(range + 1, 0x80, 4, st);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + kThreads - 1) / kThreads;
  key_range_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), kThreads, 0,
                     st>>>(keys, n, range);
  return cudaGetLastError();
}

// Buckets B's (C, Lb) column streams by (key - kmin, slab of W columns):
// counts (nkeys * slabs int32, zeroed here) become the cursors, offsets
// (nkeys * slabs + 1 int32) the bucket starts, entries (C * Lb int2:
// column, f32 value bits) the bucketed copy.  b_dtype: 0 = float32,
// 1 = bfloat16.  nkeys 0 (no valid key) writes offsets[0] = 0 only.
int spmspm_ell_bucket(const int32_t* b_keys, const void* b_vals, int C,
                      int Lb, int kmin, int nkeys, int W, int b_dtype,
                      int32_t* counts, int32_t* offsets, void* entries,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 1 || Lb < 1 || W < 1 || nkeys < 0 || kmin < 0) {
    return cudaErrorInvalidValue;
  }
  const int slabs = (C + W - 1) / W;
  const long long nb = (long long)nkeys * slabs;
  if (nb > kMaxBuckets || (b_dtype != kF32 && b_dtype != kBF16)) {
    return cudaErrorInvalidValue;
  }
  const long long n = (long long)C * Lb;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (nb > 0) {
    const cudaError_t err = cudaMemsetAsync(counts, 0, nb * 4, st);
    if (err != cudaSuccess) return err;
    bucket_count_kernel<<<blocks, kThreads, 0, st>>>(
        b_keys, n, Lb, kmin, nkeys, W, slabs, counts);
  }
  bucket_scan_kernel<<<1, kScanThreads, 0, st>>>(counts, offsets, (int)nb);
  if (nb > 0) {
    int2* ent = static_cast<int2*>(entries);
    if (b_dtype == kF32) {
      bucket_scatter_kernel<float><<<blocks, kThreads, 0, st>>>(
          b_keys, static_cast<const float*>(b_vals), n, Lb, kmin, nkeys, W,
          slabs, offsets, counts, ent);
    } else {
      bucket_scatter_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
          b_keys, static_cast<const __nv_bfloat16*>(b_vals), n, Lb, kmin,
          nkeys, W, slabs, offsets, counts, ent);
    }
  }
  return cudaGetLastError();
}

// Launches the row-wise product on `stream` over a bucketed B (as
// spmspm_ell_bucket left it, with the same kmin, nkeys and W); returns
// cudaGetLastError() (0 = launched).  dtype codes: 0 = float32,
// 1 = bfloat16, 2 = fp8 e4m3, 3 = fp8 e5m2, 4 = int8.  1 <= rows <= 32 A
// rows (warps) a block; W a multiple of 4; rows * (4 W + 512) bytes of
// shared memory <= 227 KB.
int spmspm_ell_product(const int32_t* a_keys, const void* a_vals,
                       const float* a_scales, const int32_t* offsets,
                       const void* entries, float* out, int R, int La, int C,
                       int kmin, int nkeys, int W, int rows, int a_dtype,
                       void* stream) {
  if (R < 1 || C < 1 || La < 1 || nkeys < 0 || W < 4 || W % 4 != 0 ||
      rows < 1 || rows > kMaxRows || product_smem(rows, W) > 232448 ||
      (long long)((C + W - 1) / W) * ((R + rows - 1) / rows) > INT_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a_dtype) {
    case kF32:
      return launch_product<float>(a_keys, a_vals, a_scales, offsets,
                                   entries, out, R, La, C, kmin, nkeys, W,
                                   rows, st);
    case kBF16:
      return launch_product<__nv_bfloat16>(a_keys, a_vals, a_scales,
                                           offsets, entries, out, R, La, C,
                                           kmin, nkeys, W, rows, st);
    case kE4M3:
      return launch_product<__nv_fp8_e4m3>(a_keys, a_vals, a_scales,
                                           offsets, entries, out, R, La, C,
                                           kmin, nkeys, W, rows, st);
    case kE5M2:
      return launch_product<__nv_fp8_e5m2>(a_keys, a_vals, a_scales,
                                           offsets, entries, out, R, La, C,
                                           kmin, nkeys, W, rows, st);
    case kI8:
      return launch_product<int8_t>(a_keys, a_vals, a_scales, offsets,
                                    entries, out, R, La, C, kmin, nkeys, W,
                                    rows, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
