// K3 / K4m / K4s: flash attention for Hopper (sm_90a), one source.
//
// Replaces three Pallas TPU kernels of src/repro/kernels/flash_attention/
// kernel.py:
//   K3  `flash_attention` (`_flash_kernel`): causal / sliding-window GQA
//       attention with a dead-tile skip and a q_offset;
//   K4m `flash_attention_masked` (`_flash_masked_kernel`): the full tile
//       grid gated by a per-tile kind map (core/masks.py BlockMask);
//   K4s `flash_attention_sparse` (`_flash_sparse_kernel`): a walk of the
//       sorted (row, col, kind) stream that BlockMask.lower() builds.
// On the TPU the online-softmax state (m, l, acc) stays in VMEM across
// sequential grid steps.  Here blocks run in parallel and in no order, so one
// thread block owns one (batch, head, q-tile row), keeps the state in
// registers and loops over the row's KV tiles inside the block: every KV tile
// in column order for K3 and K4m, the row's slice of the stream for K4s
// (found by binary search in the sorted rows; bucket pads repeat the last
// entry with a dead kind and fall in the last row's slice as no-ops).
// Nothing carries between blocks: no atomics, deterministic results.
//
// All three kernels call the one `tile_update` below, with its one reduction
// order, so sparse == masked and sparse(causal / window) == K3 hold bit for
// bit.  As in the Pallas bodies, q, k and v are widened to f32, q is scaled in
// f32, and p stays f32 in the PV product; only the final acc / l is rounded,
// to q's type.  With p = (visible ? exp(s - m_new) : 0) a fully masked tile is
// an exact no-op, and a row that sees no key finalizes to 0.
//
// Bound: operations.  At llama4-scout's prefill (B = 4, Hq = 40, S = 2048,
// D = 128) one causal layer is 4 * B * Hq * D * S * (S + 1) / 2 ~ 172 GFLOP
// against ~0.2 GB of q, k, v and output moved once: ~860 flops per byte, above
// the ~295 at which the H100's bf16 tensor cores, not its memory, are the
// limit.  This first kernel runs on the CUDA cores in f32: 256 threads, each
// owning 4 rows x 4 columns of the 64 x 64 score tile and 4 rows x D / 16
// columns of the accumulator; the Q, K, V and P tiles sit in shared memory,
// with the rows of Q, K and P padded by one word so that column reads do not
// share banks.  Tensor cores (wgmma, with p kept at f32 precision) are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // core/masks.py NEG_INF
constexpr int kCausal = 1;         // KIND_CAUSAL
constexpr int kWindow = 2;         // KIND_WINDOW
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kMaxTile = 64;          // bq, bk <= 64
constexpr int kThreads = 256;         // a 16 x 16 grid of threads
constexpr int kRows = kMaxTile / 16;  // query rows per thread
constexpr int kCols = kMaxTile / 16;  // score columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Shape {
  int B, Hq, Hkv, Sq, Skv;  // padded lengths: Sq % bq == 0, Skv % bk == 0
  int bq, bk;
  int skv;       // keys at or past skv are masked (the KV tail)
  int window;    // < 0: no window
  int q_offset;  // absolute position of query row 0
  float scale;
};

template <int D>
struct Tiles {
  float* q;  // (bq, D + 1), scaled
  float* k;  // (bk, D + 1)
  float* v;  // (bk, D)
  float* p;  // (bq, bk + 1)
  __device__ Tiles(float* smem, int bq, int bk)
      : q(smem), k(q + bq * (D + 1)), v(k + bk * (D + 1)), p(v + bk * D) {}
};

template <int D>
size_t smem_bytes(int bq, int bk) {
  return sizeof(float) *
         ((size_t)bq * (D + 1) + bk * (D + 1) + bk * D + bq * (bk + 1));
}

// The online-softmax state of the thread's rows ty * kRows + i; the
// accumulator columns are tx + 16 * j.  m and l are the same in the 16
// threads of a row.
template <int D>
struct RowState {
  float m[kRows], l[kRows], acc[kRows][D / 16];
};

template <int D, typename T>
__device__ void load_q(const T* __restrict__ q, const Shape& s,
                       const Tiles<D>& t, RowState<D>& st) {
  for (int i = threadIdx.x; i < s.bq * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    t.q[r * (D + 1) + d] = __fmul_rn(to_f32(q[i]), s.scale);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) st.acc[i][j] = 0.f;
  }
}

// One online-softmax update of the row state with the KV tile whose first
// key is k0 (k, v point at that tile's first row); q0 is the absolute
// position of the tile's first query.  The kind bits refine the tile.
template <int D, typename T>
__device__ void tile_update(const T* __restrict__ k, const T* __restrict__ v,
                            int kind, int q0, int k0, const Shape& s,
                            const Tiles<D>& t, RowState<D>& st) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  __syncthreads();  // Q is written; the last tile's K, V, P are read
  for (int i = threadIdx.x; i < s.bk * D; i += kThreads) {
    const int c = i / D, d = i - c * D;
    t.k[c * (D + 1) + d] = to_f32(k[i]);
    t.v[i] = to_f32(v[i]);
  }
  __syncthreads();

  // s = q k^T, one f32 fma chain over d per entry.  Rows past bq and
  // columns past bk read a clamped row and are discarded below.
  const float* qrow[kRows];
  const float* krow[kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    qrow[i] = t.q + min(ty * kRows + i, s.bq - 1) * (D + 1);
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    krow[j] = t.k + min(tx + 16 * j, s.bk - 1) * (D + 1);
  float sc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[kRows], kv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) qv[i] = qrow[i][d];
#pragma unroll
    for (int j = 0; j < kCols; ++j) kv[j] = krow[j][d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
  }

  // mask, row max, p and row sum; the 16 threads of a row reduce by a
  // butterfly, which leaves the same value in each of them.
  float alpha[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    const int q_pos = q0 + r;
    bool ok[kCols];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      const int k_pos = k0 + c;
      bool o = c < s.bk && k_pos < s.skv;
      if (kind & kCausal) o = o && q_pos >= k_pos;
      if (s.window >= 0 && (kind & kWindow)) o = o && q_pos - k_pos < s.window;
      ok[j] = o;
      sc[i][j] = o ? sc[i][j] : kNegInf;
      mx = fmaxf(mx, sc[i][j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(st.m[i], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
      const int c = tx + 16 * j;
      if (r < s.bq && c < s.bk) t.p[r * (s.bk + 1) + c] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    alpha[i] = expf(st.m[i] - m_new);
    st.l[i] = fmaf(st.l[i], alpha[i], sum);
    st.m[i] = m_new;
  }
  __syncthreads();

  // acc = acc * alpha + p v, p in f32.
  const float* prow[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    prow[i] = t.p + min(ty * kRows + i, s.bq - 1) * (s.bk + 1);
  float pv[kRows][D / 16];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) pv[i][j] = 0.f;
  for (int c = 0; c < s.bk; ++c) {
    float pr[kRows], vr[D / 16];
#pragma unroll
    for (int i = 0; i < kRows; ++i) pr[i] = prow[i][c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) vr[j] = t.v[c * D + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) pv[i][j] = fmaf(pr[i], vr[j], pv[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      st.acc[i][j] = fmaf(st.acc[i][j], alpha[i], pv[i][j]);
}

// out = acc / l (l == 0: a row that saw no key gives 0), written once.
template <int D, typename T>
__device__ void finalize(T* __restrict__ out, const Shape& s,
                         const RowState<D>& st) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r >= s.bq) continue;
    const float l = st.l[i] == 0.f ? 1.f : st.l[i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      store(out + r * D + tx + 16 * j, st.acc[i][j] / l);
  }
}

// Offsets of the block's query tile and of its (batch, KV head) in k / v.
struct Block {
  size_t q, kv;
  __device__ explicit Block(const Shape& s) {
    const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    q = (size_t)(b * s.Hq + h) * s.Sq + (size_t)qi * s.bq;
    kv = (size_t)(b * s.Hkv + h / (s.Hq / s.Hkv)) * s.Skv;  // GQA: h // g
  }
};

// K3: grid (Sq / bq, Hq, B).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Shape s,
                 int causal) {
  extern __shared__ float smem[];
  const Tiles<D> t(smem, s.bq, s.bk);
  const Block blk(s);
  RowState<D> st;
  load_q<D>(q + blk.q * D, s, t, st);
  const int q_lo = s.q_offset + (int)blockIdx.x * s.bq, q_hi = q_lo + s.bq - 1;
  const int kind = (causal ? kCausal : 0) | (s.window >= 0 ? kWindow : 0);
  for (int k_lo = 0; k_lo < s.Skv; k_lo += s.bk) {
    // the tile-level skip: no (q, k) pair of the tile can be visible
    if (causal && k_lo > q_hi) continue;
    if (s.window >= 0 && k_lo + s.bk - 1 < q_lo - s.window + 1) continue;
    const size_t off = (blk.kv + k_lo) * D;
    tile_update<D>(k + off, v + off, kind, q_lo, k_lo, s, t, st);
  }
  finalize<D>(out + blk.q * D, s, st);
}

// K4m: grid (Sq / bq, Hq, B); kinds (Sq / bq, Skv / bk).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_masked_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ kinds, T* __restrict__ out,
                        Shape s) {
  extern __shared__ float smem[];
  const Tiles<D> t(smem, s.bq, s.bk);
  const Block blk(s);
  RowState<D> st;
  load_q<D>(q + blk.q * D, s, t, st);
  const int q_lo = s.q_offset + (int)blockIdx.x * s.bq;
  const int n_kv = s.Skv / s.bk;
  const int32_t* row = kinds + (size_t)blockIdx.x * n_kv;
  for (int ki = 0; ki < n_kv; ++ki) {
    const int kind = row[ki];
    if (kind < 0) continue;
    const size_t off = (blk.kv + (size_t)ki * s.bk) * D;
    tile_update<D>(k + off, v + off, kind, q_lo, ki * s.bk, s, t, st);
  }
  finalize<D>(out + blk.q * D, s, st);
}

__device__ int lower_bound(const int32_t* __restrict__ a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// K4s: grid (Sq / bq, Hq, B); block x walks the entries of row x of the
// (capacity,) stream.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_sparse_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ rows,
                        const int32_t* __restrict__ cols,
                        const int32_t* __restrict__ kinds, int capacity,
                        T* __restrict__ out, Shape s) {
  extern __shared__ float smem[];
  const Tiles<D> t(smem, s.bq, s.bk);
  const Block blk(s);
  RowState<D> st;
  load_q<D>(q + blk.q * D, s, t, st);
  const int r = (int)blockIdx.x;
  const int q_lo = s.q_offset + r * s.bq;
  const int start = lower_bound(rows, capacity, r);
  const int end = lower_bound(rows, capacity, r + 1);
  for (int i = start; i < end; ++i) {
    const int kind = kinds[i];
    if (kind < 0) continue;  // bucket pad or empty-row marker
    const int k_lo = cols[i] * s.bk;
    const size_t off = (blk.kv + k_lo) * D;
    tile_update<D>(k + off, v + off, kind, q_lo, k_lo, s, t, st);
  }
  finalize<D>(out + blk.q * D, s, st);
}

enum Mode { kDense = 0, kMasked = 1, kSparse = 2 };

struct Args {
  const void *q, *k, *v;
  void* out;
  const int32_t *rows, *cols, *kinds;
  int capacity, causal;
  Shape s;
  cudaStream_t stream;
};

template <int D, typename T>
cudaError_t launch(Mode mode, const Args& a) {
  const Shape& s = a.s;
  const size_t smem = smem_bytes<D>(s.bq, s.bk);
  const dim3 grid(s.Sq / s.bq, s.Hq, s.B);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
  cudaError_t err;
  if (mode == kDense) {
    err = cudaFuncSetAttribute(flash_kernel<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    flash_kernel<D, T><<<grid, kThreads, smem, a.stream>>>(q, k, v, out, s,
                                                           a.causal);
  } else if (mode == kMasked) {
    err = cudaFuncSetAttribute(flash_masked_kernel<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    flash_masked_kernel<D, T><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, a.kinds, out, s);
  } else {
    err = cudaFuncSetAttribute(flash_sparse_kernel<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    flash_sparse_kernel<D, T><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, a.rows, a.cols, a.kinds, a.capacity, out, s);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(Mode mode, int D, const Args& a) {
  switch (D) {
    case 16: return launch<16, T>(mode, a);
    case 64: return launch<64, T>(mode, a);
    case 128: return launch<128, T>(mode, a);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(Mode mode, int D, int dtype, const Args& a) {
  const Shape& s = a.s;
  if (s.bq < 1 || s.bq > kMaxTile || s.bk < 1 || s.bk > kMaxTile ||
      s.B < 1 || s.B > 65535 || s.Hq < 1 || s.Hq > 65535 || s.Hkv < 1 ||
      s.Hq % s.Hkv != 0 || s.Sq < 1 || s.Skv < 1 || s.Sq % s.bq != 0 ||
      s.Skv % s.bk != 0)
    return cudaErrorInvalidValue;
  if (dtype == kF32) return by_dim<float>(mode, D, a);
  if (dtype == kBF16) return by_dim<__nv_bfloat16>(mode, D, a);
  return cudaErrorInvalidValue;
}

Shape make_shape(int B, int Hq, int Hkv, int Sq, int Skv, int bq, int bk,
                 int skv, int window, int q_offset, float scale) {
  return Shape{B, Hq, Hkv, Sq, Skv, bq, bk, skv, window, q_offset, scale};
}

}  // namespace

extern "C" {

// Each launcher starts its kernel on `stream` and returns cudaGetLastError()
// after the launch (0 = launched).  q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D),
// out like q, all contiguous and of one type: 0 = float32, 1 = bfloat16.
// D in {16, 64, 128}; 1 <= bq, bk <= 64 dividing Sq and Skv; window < 0
// means none; skv is the true KV length (keys at or past it are masked).

int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Hq, int Hkv, int Sq, int Skv,
                           int D, int bq, int bk, int causal, int skv,
                           int window, int q_offset, float scale, int dtype,
                           void* stream) {
  Args a{q, k, v, out, nullptr, nullptr, nullptr, 0, causal,
         make_shape(B, Hq, Hkv, Sq, Skv, bq, bk, skv, window, q_offset, scale),
         static_cast<cudaStream_t>(stream)};
  return dispatch(kDense, D, dtype, a);
}

// kinds: (Sq / bq, Skv / bk) int32.
int flash_attention_masked_launch(const void* q, const void* k, const void* v,
                                  const int32_t* kinds, void* out, int B,
                                  int Hq, int Hkv, int Sq, int Skv, int D,
                                  int bq, int bk, int skv, int window,
                                  int q_offset, float scale, int dtype,
                                  void* stream) {
  Args a{q, k, v, out, nullptr, nullptr, kinds, 0, 0,
         make_shape(B, Hq, Hkv, Sq, Skv, bq, bk, skv, window, q_offset, scale),
         static_cast<cudaStream_t>(stream)};
  return dispatch(kMasked, D, dtype, a);
}

// rows / cols / kinds: (capacity,) int32, sorted by (row, col).
int flash_attention_sparse_launch(const void* q, const void* k, const void* v,
                                  const int32_t* rows, const int32_t* cols,
                                  const int32_t* kinds, int capacity,
                                  void* out, int B, int Hq, int Hkv, int Sq,
                                  int Skv, int D, int bq, int bk, int skv,
                                  int window, int q_offset, float scale,
                                  int dtype, void* stream) {
  if (capacity < 0) return cudaErrorInvalidValue;
  Args a{q, k, v, out, rows, cols, kinds, capacity, 0,
         make_shape(B, Hq, Hkv, Sq, Skv, bq, bk, skv, window, q_offset, scale),
         static_cast<cudaStream_t>(stream)};
  return dispatch(kSparse, D, dtype, a);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
