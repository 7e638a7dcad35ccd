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
// Each input type has one tile update, which all three kernels call with its
// one reduction order, so sparse == masked and sparse(causal / window) == K3
// hold bit for bit within a type.  As in the Pallas bodies, p keeps f32
// precision in the PV product; only the final acc / l is rounded, to q's
// type.  With p = (visible ? exp(s - m_new) : 0) a fully masked tile is an
// exact no-op, and a row that sees no key finalizes to 0.
//
// Bound: operations.  At llama4-scout's prefill (B = 4, Hq = 40, S = 2048,
// D = 128) one causal layer is 4 * B * Hq * D * S * (S + 1) / 2 ~ 172 GFLOP
// against ~0.2 GB of q, k, v and output moved once: ~860 flops per byte, above
// the ~295 at which the H100's bf16 tensor cores, not its memory, are the
// limit.
//
// bf16 q, k, v (the serving path) run on the tensor cores (`tc_*` below, the
// building blocks in hopper.cuh): one warpgroup (128 threads) per 64-row q
// tile, the unscaled Q tile loaded once into swizzled shared memory, K / V
// tiles through a three-stage cp.async ring (two tiles in flight while one
// computes; the walk reads its entries ahead).  S = Q K^T is D / 16 wgmma
// m64n64k16 into f32 registers, then s * scale in f32; the softmax runs in
// the accumulator layout, a row's max and sum reduced over the four threads
// that share it, with the mask test skipped on wholly visible tiles and exp
// as __expf (ex2.approx; ~1e-6 relative at the arguments that matter).  P V
// keeps p at f32 precision: p = hi + lo with hi = bf16(p), lo = bf16(p - hi)
// (together within 2^-18 of p), and two register-A wgmma m64nDk16 per 16
// keys, hi then lo, accumulate into the one f32 accumulator (v is bf16, so
// each product is exact).  Tile j's softmax runs while tile j - 1's P V is
// on the tensor cores.  Tiles smaller than 64 x 64 are computed 64 wide: Q
// rows past bq and K / V rows past bk are loaded as zeros and masked.  113
// KB of shared memory at D = 128: two blocks per SM.
//
// At D = 256 (gemma3-12b) the Q tile and the three-stage ring take 230,400
// of the 232,448 bytes a block may have, so one block holds an SM, and the
// (64, 256) f32 accumulator is 128 registers a thread.  P V runs as two
// m64n128k16 halves (output columns 0-127 and 128-255, each entry summed in
// the same hi-then-lo order of 16-key steps as at D <= 128), in the same
// overlapped tile loop.  A thread issues its 16 tile copies 8 at a time
// (hopper.cuh load_tile), so o, s and two sets of p fragments fit in 253 to
// 255 registers without spills (ptxas -v); with all 16 copies unrolled the
// build spilled.
//
// At D = 192 (nemotron-4-340b) the Q tile and the ring take 173,056 bytes,
// one block an SM again, and the (64, 192) f32 accumulator is 96 registers
// a thread.  A 384-byte row is three 128-byte swizzle atoms (hopper.cuh
// Tile), and P V runs as an m64n128k16 over output columns 0-127 and an
// m64n64k16 over 128-191 (registers 0-63 and 64-95: the m64n192 layout),
// each entry in the same hi-then-lo order of 16-key steps; a thread issues
// its 12 tile copies 6 at a time.
//
// f32 q, k, v run on the CUDA cores in f32 (`tile_update` below): 256
// threads, each owning 4 rows x 4 columns of the 64 x 64 score tile and 4
// rows x D / 16 columns of the accumulator; the Q, K, V and P tiles sit in
// shared memory, with the rows of Q, K and P padded by one word so that
// column reads do not share banks (213,760 bytes at D = 256 and 164,608 at
// D = 192, with 64 x 64 tiles).  q is scaled first, in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ------------------------------------------------ bf16: tensor cores ------

using bf16 = __nv_bfloat16;

// The online-softmax state of a thread's two rows r0 = 16 warp + lane / 4 and
// r0 + 8, o in the wgmma accumulator layout (hopper.cuh).  m and l are the
// same in the four threads of a row.
template <int D>
struct TcState {
  float m[2], l[2], o[D / 2];
};

// p of one tile as bf16 A fragments, hi and lo: k-step j of P V takes
// entries 8 j .. 8 j + 7 of the score accumulator, in pairs.
struct PFrags {
  uint32_t hi[4][4], lo[4][4];
};

// s = q k^T over D / 16 k-steps, issued (the caller commits and waits).
template <int D>
__device__ __forceinline__ void tc_scores(float (&sc)[32], uint32_t q_tile,
                                          uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::mma_ss(sc, hopper::k_major<D>(q_tile, kk),
                   hopper::k_major<D>(k_tile, kk), kk > 0);
}

// o += hi v + lo v, 16 keys at a time, issued (the caller commits and waits).
// Past D = 128 as an m64n128k16 over output columns 0-127 (accumulator
// registers 0-63) and a second product over the rest (registers 64 on:
// n128 at D = 256, n64 at D = 192; the m64nDk16 layout), whose V columns
// start two 64-column blocks into the tile.
template <int D>
__device__ __forceinline__ void tc_pv(float (&o)[D / 2], const PFrags& p,
                                      uint32_t v_tile) {
  if constexpr (D <= 128) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t vd = hopper::mn_major<D>(v_tile, j);
      hopper::mma_rs(o, p.hi[j], vd);
      hopper::mma_rs(o, p.lo[j], vd);
    }
  } else {
    static_assert(D == 192 || D == 256, "head dim 192 or 256 past 128");
    constexpr int kFirst = 64;           // registers of 128 output columns
    constexpr int kRest = D / 2 - kFirst;
    constexpr uint32_t kSecond = 2 * hopper::Tile<D>::kBlockBytes;
    float(&o0)[kFirst] = *reinterpret_cast<float(*)[kFirst]>(&o[0]);
    float(&o1)[kRest] = *reinterpret_cast<float(*)[kRest]>(&o[kFirst]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t vd0 = hopper::mn_major<D>(v_tile, j);
      const uint64_t vd1 = hopper::mn_major<D>(v_tile + kSecond, j);
      hopper::mma_rs(o0, p.hi[j], vd0);
      hopper::mma_rs(o0, p.lo[j], vd0);
      hopper::mma_rs(o1, p.hi[j], vd1);
      hopper::mma_rs(o1, p.lo[j], vd1);
    }
  }
}

// The online softmax of one tile: s (q k^T, unscaled) becomes p = visible ?
// exp(s * scale - m_new) : 0, split into p's bf16 fragments; m and l are
// updated and alpha = exp(m_old - m_new) returned for the caller's rescale of
// o.  Entry e of s is (r0 + 8 h, c0 + 8 i + b), e = 4 i + 2 h + b.  The kind
// bits, skv, causal and window edges and columns past bk mask a tile that is
// not wholly visible; a wholly visible one (most tiles) skips the test, with
// the same result.
template <int D>
__device__ __forceinline__ void tc_softmax(float (&sc)[32], int kind, int q0,
                                           int k0, const Shape& s,
                                           TcState<D>& st, PFrags& p,
                                           float (&alpha)[2]) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
  const bool causal = kind & kCausal;
  const bool windowed = s.window >= 0 && (kind & kWindow);
  const int last = hopper::kTileRows - 1;
  const bool whole = s.bk == hopper::kTileRows && k0 + last < s.skv &&
                     (!causal || q0 >= k0 + last) &&
                     (!windowed || q0 + last - k0 < s.window);
  uint32_t vis = 0;
  float mx[2] = {kNegInf, kNegInf};
  if (whole) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sc[e] = __fmul_rn(sc[e], s.scale);
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h = (e >> 1) & 1;
      const int c = 8 * (e >> 2) + c0 + (e & 1);
      const int q_pos = q0 + r0 + 8 * h, k_pos = k0 + c;
      bool o = c < s.bk && k_pos < s.skv;
      if (causal) o = o && q_pos >= k_pos;
      if (windowed) o = o && q_pos - k_pos < s.window;
      sc[e] = o ? __fmul_rn(sc[e], s.scale) : kNegInf;
      vis |= (uint32_t)o << e;
      mx[h] = fmaxf(mx[h], sc[e]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    mx[h] = fmaxf(st.m[h], mx[h]);  // m_new
  }
  float sum[2] = {0.f, 0.f};
  if (whole) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sc[e] = __expf(sc[e] - mx[(e >> 1) & 1]);
      sum[(e >> 1) & 1] += sc[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sc[e] = (vis >> e) & 1 ? __expf(sc[e] - mx[(e >> 1) & 1]) : 0.f;
      sum[(e >> 1) & 1] += sc[e];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    alpha[h] = __expf(st.m[h] - mx[h]);
    st.l[h] = fmaf(st.l[h], alpha[h], sum[h]);
    st.m[h] = mx[h];
  }
  // p = hi + lo: hi = bf16(p), lo = bf16(p - hi)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float p0 = sc[8 * j + 2 * t], p1 = sc[8 * j + 2 * t + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 back = __bfloat1622float2(hi);
      p.hi[j][t] = hopper::bits(hi);
      p.lo[j][t] = hopper::bits(__floats2bfloat162_rn(
          __fsub_rn(p0, back.x), __fsub_rn(p1, back.y)));
    }
}

// out = o / l (l == 0: a row that saw no key gives 0), rounded once to bf16.
template <int D>
__device__ void tc_finalize(bf16* __restrict__ out, const Shape& s,
                            const TcState<D>& st) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= s.bq) continue;
    const float l = st.l[h] == 0.f ? 1.f : st.l[h];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const __nv_bfloat162 x = __floats2bfloat162_rn(
          st.o[4 * i + 2 * h] / l, st.o[4 * i + 2 * h + 1] / l);
      *reinterpret_cast<__nv_bfloat162*>(out + r * D + 8 * i + c0) = x;
    }
  }
}

// The walks: each yields the live KV tiles of the block's q-tile row in its
// kernel's order, as (first key, kind), and reads its next entry ahead of
// the tile being computed.
struct DenseWalk {  // K3: column order, tiles no (q, k) pair of which is
  int k_lo, Skv, bk, q_lo, q_hi, window, causal, kind;  // visible skipped
  __device__ bool next(int& k0, int& kd) {
    while (k_lo < Skv) {
      const int k = k_lo;
      k_lo += bk;
      if (causal && k > q_hi) continue;
      if (window >= 0 && k + bk - 1 < q_lo - window + 1) continue;
      k0 = k;
      kd = kind;
      return true;
    }
    return false;
  }
};

struct MaskedWalk {  // K4m: column order, kind < 0 skipped unloaded
  const int32_t* row;
  int ki, n_kv, bk;
  __device__ bool next(int& k0, int& kd) {
    while (ki < n_kv) {
      const int k = ki++;
      if (row[k] < 0) continue;
      k0 = k * bk;
      kd = row[k];
      return true;
    }
    return false;
  }
};

struct SparseWalk {  // K4s: the row's slice of the stream, in order
  const int32_t *cols, *kinds;
  int i, end, bk;
  __device__ bool next(int& k0, int& kd) {
    while (i < end) {
      const int j = i++;
      if (kinds[j] < 0) continue;  // bucket pad or empty-row marker
      k0 = cols[j] * bk;
      kd = kinds[j];
      return true;
    }
    return false;
  }
};

constexpr int kStages = 3;  // the K / V ring

template <int D>
constexpr size_t tc_smem_bytes() {  // Q, the K / V ring, 1 KB alignment
  return 1024 + (1 + 2 * kStages) * (size_t)hopper::Tile<D>::kBytes;
}

struct TileRef {  // a live KV tile of the walk
  int k0, kind;
  bool live;
};

// The body of the three bf16 kernels, and their one reduction order: Q once,
// then the walk's tiles, tile i in ring stage i % 3.  Tile j's scores are
// issued with tile j - 1's P V, and its softmax runs while that P V is on the
// tensor cores; o is rescaled by tile j's alpha after tile j - 1's P V has
// landed, so o = o * alpha_j + p_j v_j as in a tile-at-a-time loop.  Two
// tiles are in flight ahead of the one being computed.
template <int D, typename Walk>
__device__ void tc_run(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       const Shape& s, Walk walk) {
  constexpr uint32_t kTile = hopper::Tile<D>::kBytes, kStage = 2 * kTile;
  extern __shared__ uint8_t tc_smem[];
  const uint32_t q_tile = (hopper::smem_addr(tc_smem) + 1023u) & ~1023u;
  const uint32_t ring = q_tile + kTile;  // stage t: K at t, V at t + kTile
  const int tid = threadIdx.x;
  const Block blk(s);
  const bf16* kb = k + blk.kv * D;
  const bf16* vb = v + blk.kv * D;
  auto load = [&](int stage, const TileRef& t) {
    if (t.live) {
      const uint32_t at = ring + stage * kStage;
      hopper::load_tile<D>(at, kb + (size_t)t.k0 * D, s.bk, tid);
      hopper::load_tile<D>(at + kTile, vb + (size_t)t.k0 * D, s.bk, tid);
    }
    hopper::cp_async_commit();
  };
  hopper::load_tile<D>(q_tile, q + blk.q * D, s.bq, tid);
  hopper::cp_async_commit();
  TileRef a{0, 0, false}, b{0, 0, false}, c{0, 0, false};  // j - 1, j, j + 1
  a.live = walk.next(a.k0, a.kind);
  load(0, a);
  b.live = a.live && walk.next(b.k0, b.kind);
  load(1, b);
  c.live = b.live && walk.next(c.k0, c.kind);
  load(2, c);

  TcState<D> st;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.m[h] = kNegInf;
    st.l[h] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) st.o[i] = 0.f;
  const int q_lo = s.q_offset + (int)blockIdx.x * s.bq;
  if (a.live) {
    float sc[32], alpha[2];
    PFrags p;
    hopper::cp_async_wait<2>();  // Q and tile 0
    hopper::fence_async_shared();
    __syncthreads();
    hopper::mma_fence();
    tc_scores<D>(sc, q_tile, ring);
    hopper::mma_commit();
    hopper::mma_wait<0>();
    hopper::fence_operands(sc);
    tc_softmax<D>(sc, a.kind, q_lo, a.k0, s, st, p, alpha);  // o is 0
    int stage = 0;  // of tile j - 1
    while (b.live) {
      const int next = stage == kStages - 1 ? 0 : stage + 1;  // of tile j
      hopper::cp_async_wait<1>();  // tile j (tile j + 1 may be in flight)
      hopper::fence_async_shared();
      __syncthreads();
      hopper::mma_fence();
      tc_scores<D>(sc, q_tile, ring + next * kStage);
      hopper::mma_commit();
      tc_pv<D>(st.o, p, ring + stage * kStage + kTile);
      hopper::mma_commit();
      hopper::mma_wait<1>();  // the scores (groups complete in order)
      hopper::fence_operands(sc);
      PFrags p_next;
      tc_softmax<D>(sc, b.kind, q_lo, b.k0, s, st, p_next, alpha);
      hopper::mma_wait<0>();  // tile j - 1's P V
      hopper::fence_operands(st.o);
      hopper::keep(p.hi);
      hopper::keep(p.lo);
      p = p_next;
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        st.o[i] = __fmul_rn(st.o[i], alpha[(i >> 1) & 1]);
      __syncthreads();  // every warp's wgmma has read tile j - 1's stage
      a = b;
      b = c;
      c.live = c.live && walk.next(c.k0, c.kind);
      load(stage, c);  // tile j + 2 into the stage just freed
      stage = next;
    }
    hopper::mma_fence();
    tc_pv<D>(st.o, p, ring + stage * kStage + kTile);
    hopper::mma_commit();
    hopper::mma_wait<0>();
    hopper::fence_operands(st.o);
  }
  hopper::cp_async_wait<0>();
  tc_finalize<D>(out + blk.q * D, s, st);
}

template <int D>
__global__ void __launch_bounds__(hopper::kThreads)
    tc_flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    Shape s, int causal) {
  const int q_lo = s.q_offset + (int)blockIdx.x * s.bq;
  const int kind = (causal ? kCausal : 0) | (s.window >= 0 ? kWindow : 0);
  tc_run<D>(q, k, v, out, s,
            DenseWalk{0, s.Skv, s.bk, q_lo, q_lo + s.bq - 1, s.window, causal,
                      kind});
}

template <int D>
__global__ void __launch_bounds__(hopper::kThreads)
    tc_flash_masked_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const int32_t* __restrict__ kinds,
                           bf16* __restrict__ out, Shape s) {
  const int n_kv = s.Skv / s.bk;
  tc_run<D>(q, k, v, out, s,
            MaskedWalk{kinds + (size_t)blockIdx.x * n_kv, 0, n_kv, s.bk});
}

template <int D>
__global__ void __launch_bounds__(hopper::kThreads)
    tc_flash_sparse_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const int32_t* __restrict__ rows,
                           const int32_t* __restrict__ cols,
                           const int32_t* __restrict__ kinds, int capacity,
                           bf16* __restrict__ out, Shape s) {
  const int r = (int)blockIdx.x;
  tc_run<D>(q, k, v, out, s,
            SparseWalk{cols, kinds, lower_bound(rows, capacity, r),
                       lower_bound(rows, capacity, r + 1), s.bk});
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

// Dynamic shared memory of `kernel`, and the largest carveout, so that two
// blocks share an SM (one at D = 192 and 256).
template <typename Kernel>
cudaError_t tc_attributes(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int D>
cudaError_t launch_tc(Mode mode, const Args& a) {
  const Shape& s = a.s;
  const size_t smem = tc_smem_bytes<D>();
  const dim3 grid(s.Sq / s.bq, s.Hq, s.B);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  bf16* out = static_cast<bf16*>(a.out);
  // cp.async copies 16-byte chunks
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.out)) %
      16)
    return cudaErrorMisalignedAddress;
  cudaError_t err;
  if (mode == kDense) {
    err = tc_attributes(tc_flash_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    tc_flash_kernel<D><<<grid, hopper::kThreads, smem, a.stream>>>(
        q, k, v, out, s, a.causal);
  } else if (mode == kMasked) {
    err = tc_attributes(tc_flash_masked_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    tc_flash_masked_kernel<D><<<grid, hopper::kThreads, smem, a.stream>>>(
        q, k, v, a.kinds, out, s);
  } else {
    err = tc_attributes(tc_flash_sparse_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    tc_flash_sparse_kernel<D><<<grid, hopper::kThreads, smem, a.stream>>>(
        q, k, v, a.rows, a.cols, a.kinds, a.capacity, out, s);
  }
  return cudaGetLastError();
}

// f32 on the CUDA cores, bf16 on the tensor cores: each type has its path.
cudaError_t by_type(Mode mode, int D, int dtype, const Args& a) {
  if (dtype == kF32) {
    switch (D) {
      case 16: return launch<16, float>(mode, a);
      case 64: return launch<64, float>(mode, a);
      case 128: return launch<128, float>(mode, a);
      case 192: return launch<192, float>(mode, a);
      case 256: return launch<256, float>(mode, a);
    }
  } else if (dtype == kBF16) {
    switch (D) {
      case 16: return launch_tc<16>(mode, a);
      case 64: return launch_tc<64>(mode, a);
      case 128: return launch_tc<128>(mode, a);
      case 192: return launch_tc<192>(mode, a);
      case 256: return launch_tc<256>(mode, a);
    }
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
  return by_type(mode, D, dtype, a);
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
// D in {16, 64, 128, 192, 256}; 1 <= bq, bk <= 64 dividing Sq and Skv;
// window < 0 means none; skv is the true KV length (keys at or past it are
// masked).

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
