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
// stream entry's block product is computed in f32 (an fmaf chain over k in
// order), rounded to the output type, and added to the accumulator, which is
// rounded to the output type again.  For an f32 output both roundings are the
// identity, for bf16 they reproduce the reference's per-entry rounding, so a
// 0/1 dispatch stream copies bf16 rows exactly.  That rounding, entry by
// entry in stream order, is why no row is split across thread blocks: a
// split row would round partial sums that the reference never rounds.
//
// Bound: bytes.  Each stream entry reads its (bm, bk) block and the (bk,
// tile) slice of dense it selects, and the tile is written once; at bm = 8
// that is 8 multiply-adds per dense element read, far below the ~300 flops
// per byte at which the tensor cores would become the limit, so the design
// spends nothing on tensor cores.  What it fights is latency: a row is a
// chain of entries, and the MoE dispatch stream's rows are short (a median
// of 8-20 entries) except the last, which holds every bucket pad entry (a
// zero block) -- up to ~2,900 at a 4 x 2048 prefill.
//
// The walk, per chunk of up to 64 entries (fewer where their blocks pass
// 8 KB or their f32 values 12 KB):
//
// 1. Staging.  The blocks of a row's consecutive entries in one batch are
//    one contiguous span, so the chunk is copied with cp.async (16 bytes a
//    thread), with its block_cols, into a two-stage ring: chunk
//    c + 1 is in flight while chunk c is walked.
// 2. Zero blocks.  All threads OR the staged words, conflict-free, into a
//    64-bit mask of the entries with a nonzero bit (-0.0 counts as
//    nonzero); a chunk with none costs this scan and three barriers, and
//    the pad tail is walked at that rate.  One warp per live entry then
//    writes its values in f32, transposed to (k, m), and the masks of its
//    block rows and columns with a nonzero bit.
// 3. Dense.  Each thread owns VEC = 16 / sizeof(dense) consecutive output
//    columns (8 bf16 or 4 f32) of the BM block rows; `bn` is the columns of
//    one thread block (bn / VEC threads).  It walks the items (live entry,
//    nonzero block column k) in stream order, k ascending, and keeps its
//    own 16 bytes of dense row k of the next kRing - 1 items in flight, in
//    its own slots of a shared-memory ring (cp.async; no barrier, since no
//    thread reads another's slots).  A 0/1 dispatch block has one nonzero
//    per occupied slot row, so most items are the block's only live column.
//    Where N is not a multiple of VEC (or a pointer is not 16-byte aligned)
//    the edge is loaded and stored by scalars with a bound check.
// 4. Rows are launched in reverse, so the padded last row starts first and
//    its tail runs beside the others instead of after them.
//
// Skipping is exact on finite data.  A zero block, a zero block row or a
// zero block column adds +-0 to a sum, which leaves every value as it was
// (at most the sign of a zero result differs), so the kernel stays equal
// (`torch.equal`) to the plain version, which walks every entry in full.
// Non-finite input: a skipped zero against an inf / NaN dense value
// contributes nothing here, where the plain version (and the Pallas body)
// gives NaN.  No contract covers non-finite input.
//
// K2q, the quantized variant (`_spmm_quant_kernel`, the same Pallas call
// with `scales`: blocks of fp8 e4m3 / e5m2 or int8 with one f32 scale per
// (batch, stream entry), f32 or bf16 dense, f32 out) has a kernel of its
// own, `spmm_quant_kernel` below.  Its operand is the library's banded
// matrix (8192^2 fp8 e4m3, bandwidth 512, 8 x 8 blocks: ~125 entries a
// block-row, every one live), so it is bound by operations: 2 flops per
// block element and output column at the f32 CUDA-core peak.  A block-row
// walked alone fetches every dense K-tile it touches from L2, and each
// fetched value then serves only BM multiply-adds, so the kernel above runs
// it from L2 at a fifth of the f32 peak (NVIDIA H100 80GB HBM3, 700 W).
// K2q instead:
//
// 1. Groups rows.  A thread block of eight warps owns a group of
//    consecutive block-rows x an N-tile of `bn` columns.  Each warp owns 8
//    output rows (one block-row, or half of a 16-row one) x 128 columns,
//    4 a lane, so a group is 8 block-rows of 8 x 8 blocks at bn 128
//    (8 / (bm / 8) / (bn / 128) in general).
// 2. Walks the group's K-tiles once, by merging the rows' cursors.  A
//    window of up to 1024 K-tiles starts at the least head column of the
//    rows still in their sweep; every row marks, in a shared bitmap, the
//    columns of its entries from its cursor that stay inside the window and
//    do not descend; the marked columns, ascending, are the window's
//    steps.  A row whose next column descends waits for a new sweep, which
//    starts when no row can go on.  So each row meets its entries in its
//    own stream order whether or not its columns ascend or repeat; on
//    ascending rows (the library's) a group's window is one sweep and each
//    K-tile is staged once for all the rows that use it.
// 3. Stages each step's dense tile (bk rows x bn columns) once, with
//    cp.async, into a ring of four commit groups of up to four tiles
//    (as many as 64 KB holds): three groups are in flight behind the
//    products, and the block meets at one barrier a group.  Where N is not
//    a multiple of VEC or a pointer is not 16-byte aligned, a tile is
//    loaded by scalars with a bound check.
// 4. Computes from shared memory.  At a step every warp whose row's head
//    entry has the step's column takes its entries there (several in a row
//    for a repeated column): it dequantizes the entry's 8 x bk values,
//    `__fmul_rn(float(q), scale)` as the host does (at bk 8 two values a
//    lane, converted as a pair), transposed to (k, m) in its own double
//    buffer, and runs the fmaf chain over k from the buffer (two broadcast
//    vector reads of a, one of x, a k) into an 8 x 4 register tile, then
//    adds it to the row's accumulator.  Each warp keeps its next entry's
//    block bytes, scale and column in flight.
//
// What bounds it (tools/compare_spmm.py ablations on NVIDIA H100 80GB
// HBM3, 700 W): the shared-memory reads.  A 16-byte read costs the
// shared-memory pipe four cycles whether it broadcasts or not, so an
// entry's 24 of them per warp take ~96 cycles of the SM's one pipe against
// 256 FMAs on each of its four schedulers; an 8 x 8 lane tile cuts that by
// a third but needs ~220 registers.
//
// Every output element still takes p = the fmaf chain over k from 0, then
// acc + p per entry in the row's stream order, as the kernel above does
// with host-dequantized f32 blocks; it only skips nothing (an fmaf with a
// zero factor leaves a finite sum as it was, up to the sign of a zero), so
// K2q equals K2 on host-dequantized blocks bit for bit on finite data.  No
// row is split across warps or thread blocks and nothing is atomic but the
// bitmap's marks.  An empty row writes zeros.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kE4M3 = 2;
constexpr int kE5M2 = 3;
constexpr int kI8 = 4;
constexpr int kMaxBK = 32;
constexpr int kMaxChunk = 64;     // stream entries per staged chunk
constexpr int kStages = 2;        // chunks in the cp.async ring
constexpr int kRawBytes = 8192;   // block bytes of one ring stage
constexpr int kAFloats = 3072;    // f32 values of a chunk's live blocks
constexpr int kRing = 12;         // dense rows in flight per thread
constexpr int kMaxThreads = 256;  // threads of a block (bn / VEC)

// A kernel's dynamic shared memory allowed past 48 KB, once a device: the
// attribute belongs to the current device, so a flag kept once a process
// would skip it on a second card.  Two first calls at once both set it,
// which is harmless; a device past kDevices sets it every launch.
constexpr int kDevices = 64;
template <typename Kernel>
cudaError_t smem_opt_in(std::atomic<bool> (&done)[kDevices], Kernel kernel,
                        size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first `valid` of the 16 bytes of dense at p, zero-filled: the ragged
// edge, or a row that is not 16-byte aligned.
template <typename TB>
__device__ __forceinline__ uint4 load_partial(const TB* p, int valid) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  TB* t = reinterpret_cast<TB*>(&w);
#pragma unroll
  for (int v = 0; v < 16 / (int)sizeof(TB); ++v)
    if (v < valid) t[v] = p[v];
  return w;
}

// Value v of a 16-byte row as f32.
__device__ __forceinline__ float elem(const uint4& w, int v, float) {
  return __uint_as_float((&w.x)[v]);
}
__device__ __forceinline__ float elem(const uint4& w, int v, __nv_bfloat16) {
  const uint32_t h = (&w.x)[v >> 1];
  return __uint_as_float((v & 1) ? (h & 0xffff0000u) : (h << 16));
}

// One thread's BM x VEC output values, in f32 or as packed bf16 pairs (a
// bf16 accumulator is rounded to bf16 after every entry, so bf16 holds it
// exactly, in half the registers).
template <int BM, int VEC, typename TO>
struct Acc;

template <int BM, int VEC>
struct Acc<BM, VEC, float> {
  float v[BM][VEC];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[m][i] = 0.f;
  }
  // acc = round(acc + round(p)), both roundings the identity
  __device__ __forceinline__ void add(int m, const float* p) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[m][i] = v[m][i] + p[i];
  }
  __device__ __forceinline__ void store(float* o, int m, bool full,
                                        int valid) const {
    if (full) {
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(o + j) =
            make_float4(v[m][j], v[m][j + 1], v[m][j + 2], v[m][j + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (i < valid) o[i] = v[m][i];
    }
  }
};

template <int BM, int VEC>
struct Acc<BM, VEC, __nv_bfloat16> {
  __nv_bfloat162 v[BM][VEC / 2];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i)
        v[m][i] = __floats2bfloat162_rn(0.f, 0.f);
  }
  // acc = round(acc + round(p)) in bf16, each sum taken in f32
  __device__ __forceinline__ void add(int m, const float* p) {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const float2 a = __bfloat1622float2(v[m][i]);
      const float2 r = __bfloat1622float2(__floats2bfloat162_rn(p[2 * i],
                                                                p[2 * i + 1]));
      v[m][i] = __floats2bfloat162_rn(a.x + r.x, a.y + r.y);
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* o, int m, bool full,
                                        int valid) const {
    if (full) {
#pragma unroll
      for (int j = 0; j < VEC / 2; j += 4)
        *reinterpret_cast<uint4*>(o + 2 * j) =
            *reinterpret_cast<const uint4*>(&v[m][j]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (i < valid) o[i] = (i & 1) ? v[m][i / 2].y : v[m][i / 2].x;
    }
  }
};

// The raw bits of one block value (-0.0 counts as nonzero).
__device__ __forceinline__ uint32_t raw_bits(const unsigned char* p, int n) {
  if (n == 4) return *reinterpret_cast<const uint32_t*>(p);
  if (n == 2) return *reinterpret_cast<const uint16_t*>(p);
  return *p;
}

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

// Dynamic shared memory: the per-thread ring of dense rows.
__host__ __device__ constexpr int ring_bytes(int threads) {
  return kRing * threads * 16;
}

// grid (ceil(N / bn), B, gm), block (bn / VEC): thread x owns output
// columns n0 .. n0 + VEC of the BM rows of block-row gm - 1 - blockIdx.z
// (rows in reverse, so that the bucket-padded last row starts first), n0 =
// blockIdx.x * bn + x * VEC.  `vec_ok`: N % VEC == 0 and dense / out are
// 16-byte aligned, so whole-vector loads and stores are legal.
// Registers: at BM 8 at most 128 a thread, so that two blocks of 256
// threads, or four of 128, share an SM.  At BM 16 a thread's accumulator and
// entry product alone take 192 (bf16 out) or 256 (f32 out) floats of 8 bf16
// columns, which would spill at 128, so BM 16 may use up to 255, one block
// of 256 threads (two of 128) an SM.
template <int BM, typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(kMaxThreads, BM == 8 ? 2 : 1)
spmm_bcsr_kernel(const int32_t* __restrict__ indptr,
                 const int32_t* __restrict__ block_cols,
                 const TA* __restrict__ blocks,
                 const TB* __restrict__ dense, TO* __restrict__ out,
                 int nnzb, int bk, int K, int N, int bn, bool vec_ok) {
  constexpr int VEC = 16 / sizeof(TB);
  constexpr int TSZ = static_cast<int>(sizeof(TA));
  __shared__ __align__(16) unsigned char raw_s[kStages][kRawBytes];
  __shared__ __align__(16) float a_s[kAFloats];  // the chunk's blocks, (k, m)
  __shared__ int32_t cols_s[kStages][kMaxChunk];
  __shared__ uint32_t rows_s[kMaxChunk];   // nonzero block rows of an entry
  __shared__ uint32_t kcols_s[kMaxChunk];  // and its nonzero block columns
  __shared__ unsigned long long live_s[2];  // entries with a nonzero bit
  extern __shared__ uint4 ring_s[];         // [kRing][blockDim.x]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n0 = blockIdx.x * bn + tid * VEC;
  const int b = blockIdx.y;
  const int r = gridDim.z - 1 - blockIdx.z;  // the long last row first
  const bool active = n0 < N;
  const bool full = vec_ok && n0 + VEC <= N;
  const int valid = N - n0;
  const int start = indptr[r];
  const int end = indptr[r + 1];
  const int bsz = BM * bk;  // values of a block
  const int eb = bsz * TSZ;  // bytes of a block
  const int chunk = min(kMaxChunk, min(kRawBytes / eb, kAFloats / bsz));
  const unsigned char* blocks_b = reinterpret_cast<const unsigned char*>(
      blocks + (size_t)b * nnzb * bsz);
  const TB* dense_b = dense + (size_t)b * K * N + n0;

  // Stage chunk c (entries start + c * chunk ..) into ring slot c % kStages:
  // cp.async for the 16-byte body when the span is aligned, plain copies
  // for the rest, in one commit group (empty past the last chunk, so that
  // "all but the newest kStages - 2 groups" always covers chunk c).
  const int n_chunks = (end - start + chunk - 1) / chunk;
  auto stage = [&](int c) {
    if (c >= n_chunks) {
      cp_async_commit();
      return;
    }
    const int s = c % kStages;
    const int i0 = start + c * chunk;
    const int n = min(chunk, end - i0);
    const unsigned char* src = blocks_b + (size_t)i0 * eb;
    const int bytes = n * eb;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      done = bytes & ~15;
      for (int j = tid * 16; j < done; j += nthreads * 16)
        cp_async16(&raw_s[s][j], src + j);
    }
    for (int j = done + tid; j < bytes; j += nthreads) raw_s[s][j] = src[j];
    for (int j = tid; j < n; j += nthreads)
      cp_async4(&cols_s[s][j], block_cols + i0 + j);
    cp_async_commit();
  };

  Acc<BM, VEC, TO> acc;
  acc.zero();
  if (tid == 0) live_s[0] = 0ull;  // before the first barrier
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) stage(c);
  for (int c = 0; c < n_chunks; ++c) {
    // Chunk c landed.  The groups newer than its own are the next chunks'
    // and the walk's; a walk waits for all but its newest kRing - 1 items,
    // which finishes every chunk staged before it, and its last kRing - 1
    // groups are empty.
    cp_async_wait<kStages - 2>();
    __syncthreads();  // ... for every thread; chunk c - 1 is no longer read
    stage(c + kStages - 1);
    const int s = c % kStages;
    const int n = min(chunk, end - start - c * chunk);
    // The chunk's live entries (a nonzero bit; -0.0 counts): every thread
    // ORs its share of the staged words, conflict-free, into a 64-bit mask
    // of entries, one warp-reduced atomic a warp.
    {
      const int w = (eb & 15) == 0 ? 16 : (eb & 3) == 0 ? 4 : 1;
      const float inv_eb = 1.f / eb;
      uint64_t mine = 0;
      for (int j = tid * w; j < n * eb; j += nthreads * w) {
        const unsigned char* p = raw_s[s] + j;
        uint32_t any;
        if (w == 16) {
          const uint4 q = *reinterpret_cast<const uint4*>(p);
          any = q.x | q.y | q.z | q.w;
        } else {
          any = raw_bits(p, w);
        }
        if (any) mine |= 1ull << static_cast<int>((j + 0.5f) * inv_eb);
      }
      const uint32_t lo = __reduce_or_sync(0xffffffffu, (uint32_t)mine);
      const uint32_t hi = __reduce_or_sync(0xffffffffu, (uint32_t)(mine >> 32));
      if ((lo | hi) && (tid & 31) == 0)
        atomicOr(&live_s[c & 1], ((unsigned long long)hi << 32) | lo);
    }
    __syncthreads();
    const uint64_t live = live_s[c & 1];
    if (tid == 0) live_s[(c + 1) & 1] = 0ull;  // read again at c + 2 only
    if (live == 0ull) continue;
    // One warp per live entry: its f32 values, transposed to (k, m) so
    // that a block column is one vector read, and the masks of its block
    // rows and columns that hold a nonzero bit.
    {
      const int lane = tid & 31;
      const float inv_bk = 1.f / bk;
      uint64_t todo = live;
      for (int i = 0; todo; ++i) {
        const int e = __ffsll(todo) - 1;
        todo &= todo - 1;
        if (i % (nthreads >> 5) != (tid >> 5)) continue;
        const TA* blk = reinterpret_cast<const TA*>(raw_s[s] + e * eb);
        uint32_t rows = 0, cols = 0;
        for (int q = lane; q < bsz; q += 32) {
          const int m = static_cast<int>((q + 0.5f) * inv_bk);
          const int k = q - m * bk;
          if (raw_bits(reinterpret_cast<const unsigned char*>(blk + q),
                       TSZ)) {
            rows |= 1u << m;
            cols |= 1u << k;
          }
          a_s[e * bsz + k * BM + m] = to_f32(blk[q]);
        }
        rows = __reduce_or_sync(0xffffffffu, rows);
        cols = __reduce_or_sync(0xffffffffu, cols);
        if (lane == 0) {
          rows_s[e] = rows;
          kcols_s[e] = cols;
        }
      }
    }
    __syncthreads();
    if (!active) continue;

    // The walk: one item per (live entry, nonzero block column k) in
    // stream order, k ascending; each item is the thread's 16 bytes of
    // dense row k of the entry's K-tile, kept kRing - 1 items ahead in the
    // thread's own ring (cp.async, so no barrier is needed).
    uint64_t pending = live;       // entries the next issues load from
    int pe = __ffsll(pending) - 1;
    uint32_t pk = kcols_s[pe];
    auto issue = [&](int slot) {
      if (pe >= 0) {
        const int k = __ffs(pk) - 1;
        const TB* src = dense_b + ((size_t)cols_s[s][pe] * bk + k) * N;
        uint4* dst = &ring_s[slot * nthreads + tid];
        if (full)
          cp_async16(dst, src);
        else
          *dst = load_partial(src, valid);
        pk &= pk - 1;
        if (pk == 0u) {
          pending &= pending - 1;
          pe = __ffsll(pending) - 1;
          if (pe >= 0) pk = kcols_s[pe];
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int j = 0; j < kRing - 1; ++j) issue(j);
    int it = 0;
    for (uint64_t todo = live; todo; todo &= todo - 1) {
      const int e = __ffsll(todo) - 1;  // zero blocks add +-0: skipped
      const uint32_t rows = rows_s[e];
      uint32_t ks = kcols_s[e];
      const float* a = a_s + e * bsz;
      float p[BM][VEC];
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int v = 0; v < VEC; ++v) p[m][v] = 0.f;
      do {  // a zero column adds +-0 to each row
        const int k = __ffs(ks) - 1;
        ks &= ks - 1;
        issue((it + kRing - 1) % kRing);
        cp_async_wait<kRing - 1>();
        const uint4 x = ring_s[(it % kRing) * nthreads + tid];
        ++it;
        float ak[BM];
#pragma unroll
        for (int m = 0; m < BM; m += 4) {
          const float4 q = *reinterpret_cast<const float4*>(a + k * BM + m);
          ak[m] = q.x; ak[m + 1] = q.y; ak[m + 2] = q.z; ak[m + 3] = q.w;
        }
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          if (!((rows >> m) & 1u)) continue;  // a zero row adds +-0
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            p[m][v] = fmaf(ak[m], elem(x, v, TB()), p[m][v]);
        }
      } while (ks);
#pragma unroll
      for (int m = 0; m < BM; ++m)
        if ((rows >> m) & 1u) acc.add(m, p[m]);
    }
  }
  cp_async_wait<0>();
  if (active) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
      acc.store(out + ((size_t)b * gridDim.z + r) * BM * N + (size_t)m * N +
                    n0,
                m, full, valid);
  }
}

template <int BM, typename TA, typename TB, typename TO>
cudaError_t launch(const Args& a) {
  constexpr int VEC = 16 / sizeof(TB);
  if (a.bn % (32 * VEC) != 0 || a.bn / VEC > kMaxThreads)
    return cudaErrorInvalidValue;
  const bool vec_ok = a.N % VEC == 0 &&
                      (reinterpret_cast<uintptr_t>(a.dense) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(a.out) & 15) == 0;
  const int threads = a.bn / VEC;
  auto kernel = spmm_bcsr_kernel<BM, TA, TB, TO>;
  // the ring may take the block past 48 KB
  static std::atomic<bool> opted_in[kDevices];
  const cudaError_t err = smem_opt_in(opted_in, kernel,
                                      ring_bytes(kMaxThreads));
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + a.bn - 1) / a.bn, a.batch, a.gm);
  kernel<<<grid, threads, ring_bytes(threads), a.stream>>>(
      a.indptr, a.block_cols, static_cast<const TA*>(a.blocks),
      static_cast<const TB*>(a.dense), static_cast<TO*>(a.out), a.nnzb, a.bk,
      a.K, a.N, a.bn, vec_ok);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2q: narrow blocks, a thread block per (group of block-rows, N-tile).
// ---------------------------------------------------------------------------

constexpr int kQWarps = 8;                // warps of a K2q thread block
constexpr int kQThreads = 32 * kQWarps;
constexpr int kQWarpCols = 128;           // output columns of a warp, 4 a lane
constexpr int kQStages = 4;               // commit groups in the ring
constexpr int kQMaxSync = 4;              // steps (dense tiles) of a group
constexpr int kQSyncRing = 65536;         // ring bytes that sets the steps
constexpr int kQWindow = 1024;            // K-tiles of one window of steps
constexpr int kQMaxTileBytes = 32768;     // one dense tile (bk x bn)
constexpr int kNoCol = 0x7fffffff;        // the head of a walked row

// A narrow value from its byte.
template <typename TA>
__device__ __forceinline__ float narrow_f32(uint32_t byte) {
  TA x;
  *reinterpret_cast<unsigned char*>(&x) = static_cast<unsigned char>(byte);
  return to_f32(x);
}

// Two narrow values from the low and high bytes of `two`; fp8 pairs by one
// conversion to f16 (exact: every fp8 value is an f16 value).
template <typename TA>
__device__ __forceinline__ float2 narrow2_f32(uint32_t two) {
  return make_float2(narrow_f32<TA>(two & 0xffu),
                     narrow_f32<TA>((two >> 8) & 0xffu));
}
template <>
__device__ __forceinline__ float2 narrow2_f32<__nv_fp8_e4m3>(uint32_t two) {
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two), __NV_E4M3)));
}
template <>
__device__ __forceinline__ float2 narrow2_f32<__nv_fp8_e5m2>(uint32_t two) {
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two), __NV_E5M2)));
}

// Four consecutive dense values of a staged tile row, as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// Steps a commit group of the K2q ring stages, and so a barrier serves: the
// largest power of two up to kQMaxSync whose kQStages groups fit
// kQSyncRing (4 at the library's 4 KB tiles), else 1.  A power of two, so
// that the ring's slot is a mask.
__host__ __device__ constexpr int quant_sync(int tile_bytes) {
  int sync = kQMaxSync;
  while (sync > 1 && kQStages * sync * tile_bytes > kQSyncRing) sync /= 2;
  return sync;
}

// Dynamic shared memory of a K2q block: the ring of dense tiles, then each
// warp's two f32 (bk, 8) buffers of a dequantized half-block.
__host__ __device__ constexpr int quant_smem_bytes(int tile_bytes, int bk) {
  return kQStages * quant_sync(tile_bytes) * tile_bytes +
         kQWarps * 2 * 8 * bk * 4;
}

// Word j of a warp's half-block at p (8 * bk bytes, a multiple of 8): one
// load where the blocks are 4-byte aligned, else four byte loads.
__device__ __forceinline__ uint32_t half_word(const unsigned char* p, int j,
                                              bool a_words) {
  if (a_words) return __ldg(reinterpret_cast<const uint32_t*>(p) + j);
  const unsigned char* q = p + 4 * j;
  return (uint32_t)__ldg(q) | ((uint32_t)__ldg(q + 1) << 8) |
         ((uint32_t)__ldg(q + 2) << 16) | ((uint32_t)__ldg(q + 3) << 24);
}

// grid (ceil(N / bn), B, ceil(gm / group)), block kQThreads.  Warp w owns
// the 8 output rows rs = w % rows_w of the group (block-row rs / (BM / 8),
// half rs % (BM / 8)) and the 128 columns (w / rows_w) * 128 .. of the
// N-tile, rows_w = kQWarps / (bn / 128) = group * BM / 8.  Groups run in
// reverse, as block-rows do above.  `vec_ok` as above; `a_words`: the
// blocks are 4-byte aligned.  KB: bk when it is known at compile time (8,
// the library's), else 0 and bk is `bk_arg`.
template <int BM, typename TA, typename TB, int KB>
__global__ void __launch_bounds__(kQThreads, 2)
spmm_quant_kernel(const int32_t* __restrict__ indptr,
                  const int32_t* __restrict__ block_cols,
                  const unsigned char* __restrict__ blocks,
                  const float* __restrict__ scales,
                  const TB* __restrict__ dense, float* __restrict__ out,
                  int gm, int nnzb, int bk_arg, int K, int N, int bn,
                  int group, int sync, bool vec_ok, bool a_words) {
  constexpr int VEC = 16 / sizeof(TB);
  const int bk = KB ? KB : bk_arg;
  constexpr int kHalves = BM / 8;
  extern __shared__ __align__(16) unsigned char qsmem[];
  __shared__ uint32_t bits_s[kQWindow / 32];  // the window's K-tiles
  __shared__ uint16_t steps_s[kQWindow];      // ... in ascending order
  __shared__ int least_s[2];  // least head going on in its sweep; of any row
  __shared__ int nsteps_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows_w = kQWarps / (bn / kQWarpCols);
  const int rs = warp % rows_w;
  const int wc = warp / rows_w;
  const int half = rs % kHalves;
  const int r = (gridDim.z - 1 - blockIdx.z) * group + rs / kHalves;
  const bool row_ok = r < gm;
  const bool marker = row_ok && wc == 0 && half == 0;  // marks for its row
  const int b = blockIdx.y;
  const int n_tile = blockIdx.x * bn;
  const int c0 = n_tile + wc * kQWarpCols + lane * 4;  // the lane's columns
  const int tile_elems = bk * bn;
  TB* ring = reinterpret_cast<TB*>(qsmem);
  float* a_w = reinterpret_cast<float*>(
                   qsmem + kQStages * sync * tile_elems * (int)sizeof(TB)) +
               warp * 2 * 8 * bk;
  const unsigned char* blocks_h =
      blocks + (size_t)b * nnzb * BM * bk + half * 8 * bk;
  const float* scales_b = scales + (size_t)b * nnzb;
  const TB* dense_b = dense + (size_t)b * K * N + n_tile;

  // The row's walk: `cur` its next entry, `head` / `next` the columns of
  // entries cur and cur + 1 (kNoCol past the end), `floor_col` the column
  // of its last entry in this sweep.  Entry cur's scale and the lane's
  // share of its half-block are in flight: at bk 8 the two values (m, k),
  // (m, k + 1), m = lane / 4, k = 2 (lane % 4), in w0; else words lane and
  // lane + 32 in w0, w1.
  int cur = 0, end = 0;
  if (row_ok) {
    cur = indptr[r];
    end = indptr[r + 1];
  }
  int head = cur < end ? block_cols[cur] : kNoCol;
  int next = cur + 1 < end ? block_cols[cur + 1] : kNoCol;
  int floor_col = -1;
  const int nw = 2 * bk;  // words of a half-block
  uint32_t w0 = 0, w1 = 0;
  float sc = 0.f;
  const int pair = (lane >> 2) * 8 + 2 * (lane & 3);  // bk 8: (m, k) byte
  auto fetch = [&](int i) {
    const unsigned char* p = blocks_h + (size_t)i * BM * bk;
    if (KB == 8) {
      w0 = a_words ? __ldg(reinterpret_cast<const uint16_t*>(p + pair))
                   : (uint32_t)__ldg(p + pair) |
                         ((uint32_t)__ldg(p + pair + 1) << 8);
    } else {
      if (lane < nw) w0 = half_word(p, lane, a_words);
      if (lane + 32 < nw) w1 = half_word(p, lane + 32, a_words);
    }
    sc = __ldg(scales_b + i);
  };
  if (cur < end) fetch(cur);
  // Where the lane's words go in the (k, m) buffer: value 4 j + t of the
  // half-block is (m, k) = divmod(4 j + t, bk).
  const int m0 = (4 * lane) / bk, k0 = (4 * lane) % bk;
  const int m1 = (4 * lane + 128) / bk, k1 = (4 * lane + 128) % bk;
  auto dequant = [&](uint32_t w, int m, int k, float* a) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      a[k * 8 + m] = __fmul_rn(narrow_f32<TA>((w >> (8 * t)) & 0xffu), sc);
      if (++k == bk) {
        k = 0;
        ++m;
      }
    }
  };

  // Copy the dense tiles (K-tiles wstart + steps_s[s]) of steps s = j *
  // sync .. into ring slots s % slots: 16 bytes a thread with cp.async, the
  // ragged or unaligned rest by scalars, zero past N; one commit group for
  // them, empty past the window's last step.  A tile row is cpr = bn / VEC
  // chunks, a power of two that divides kQThreads: the thread copies column
  // v of rows k_first, k_first + k_step, ...
  const int slots = kQStages * sync;  // a power of two
  const int cpr = bn / VEC;
  const int k_first = tid / cpr, k_step = kQThreads / cpr;
  const int v = (tid % cpr) * VEC;
  const int valid = N - (n_tile + v);
  auto issue = [&](int j, int S, int wstart) {
    for (int s = j * sync; s < (j + 1) * sync && s < S; ++s) {
      const int t = wstart + steps_s[s];
      TB* dst = ring + (s & (slots - 1)) * tile_elems;
      const TB* src = dense_b + (size_t)t * bk * N;
      for (int k = k_first; k < bk; k += k_step) {
        uint4* d = reinterpret_cast<uint4*>(dst + k * bn + v);
        const TB* g = src + (size_t)k * N + v;
        if (vec_ok && valid >= VEC)
          cp_async16(d, g);
        else
          *d = valid > 0 ? load_partial(g, valid) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  int buf = 0;

  for (;;) {
    // The window's start: the least head column of the rows that go on in
    // their sweep, or, where none can, of all rows (a new sweep).
    if (tid < kQWindow / 32) bits_s[tid] = 0u;
    if (tid == 0) least_s[0] = least_s[1] = kNoCol;
    __syncthreads();
    if (marker && lane == 0 && head != kNoCol) {
      atomicMin(&least_s[1], head);
      if (head >= floor_col) atomicMin(&least_s[0], head);
    }
    __syncthreads();
    if (least_s[1] == kNoCol) break;  // every row walked
    const bool sweep = least_s[0] == kNoCol;
    const int wstart = sweep ? least_s[1] : least_s[0];
    if (sweep) floor_col = -1;
    // Each row marks the columns of its entries from the cursor while they
    // stay in the window and do not descend: exactly the entries it takes
    // in this window, at those columns' steps.
    if (marker) {
      int prev = floor_col;
      for (int j = cur; j < end; j += 32) {
        const int i = j + lane;
        const int c = i < end ? block_cols[i] : kNoCol;
        int pc = __shfl_up_sync(0xffffffffu, c, 1);
        if (lane == 0) pc = prev;
        const bool ok = i < end && c >= wstart && c - wstart < kQWindow &&
                        c >= pc;
        const uint32_t stop = __ballot_sync(0xffffffffu, !ok);
        if (lane < (stop ? __ffs(stop) - 1 : 32))
          atomicOr(&bits_s[(c - wstart) >> 5], 1u << ((c - wstart) & 31));
        if (stop) break;
        prev = __shfl_sync(0xffffffffu, c, 31);
      }
    }
    __syncthreads();
    if (warp == 0) {  // the steps: marked K-tiles in ascending order
      const uint32_t w = bits_s[lane];
      const int n = __popc(w);
      int off = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, off, d);
        if (lane >= d) off += t;
      }
      if (lane == 31) nsteps_s = off;
      off -= n;
      for (uint32_t x = w; x; x &= x - 1)
        steps_s[off++] = static_cast<uint16_t>(lane * 32 + __ffs(x) - 1);
    }
    __syncthreads();
    const int S = nsteps_s;

#pragma unroll
    for (int j = 0; j < kQStages - 1; ++j) issue(j, S, wstart);
    for (int j = 0; j * sync < S; ++j) {
      cp_async_wait<kQStages - 2>();
      __syncthreads();  // group j landed for all; group j - 1 is read no more
      issue(j + kQStages - 1, S, wstart);
      for (int s = j * sync; s < (j + 1) * sync && s < S; ++s) {
        const int t = wstart + steps_s[s];
        const TB* x = ring + (s & (slots - 1)) * tile_elems +
                      wc * kQWarpCols + lane * 4;
        while (head == t) {  // the row's entries at this K-tile, in order
          float* a = a_w + buf * 8 * bk;
          if (KB == 8) {
            const float2 v = narrow2_f32<TA>(w0);
            a[2 * (lane & 3) * 8 + (lane >> 2)] = __fmul_rn(v.x, sc);
            a[(2 * (lane & 3) + 1) * 8 + (lane >> 2)] = __fmul_rn(v.y, sc);
          } else {
            if (lane < nw) dequant(w0, m0, k0, a);
            if (lane + 32 < nw) dequant(w1, m1, k1, a);
          }
          ++cur;
          head = next;
          next = cur + 1 < end ? block_cols[cur + 1] : kNoCol;
          if (cur < end) fetch(cur);
          __syncwarp();
          float p[8][4];
#pragma unroll
          for (int m = 0; m < 8; ++m)
#pragma unroll
            for (int c = 0; c < 4; ++c) p[m][c] = 0.f;
#pragma unroll(KB ? KB : 4)
          for (int k = 0; k < bk; ++k) {
            const float4 lo = *reinterpret_cast<const float4*>(a + k * 8);
            const float4 hi = *reinterpret_cast<const float4*>(a + k * 8 + 4);
            const float4 xv = load4(x + k * bn);
            const float am[8] = {lo.x, lo.y, lo.z, lo.w,
                                 hi.x, hi.y, hi.z, hi.w};
            const float xc[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int m = 0; m < 8; ++m)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                p[m][c] = fmaf(am[m], xc[c], p[m][c]);
          }
#pragma unroll
          for (int m = 0; m < 8; ++m)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[m][c] = acc[m][c] + p[m][c];
          buf ^= 1;  // the other buffer is free: every lane is past its reads
          floor_col = t;
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!row_ok) return;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    float* o = out + ((size_t)b * gm * BM + (size_t)r * BM + half * 8 + m) *
                         N + c0;
    if (vec_ok && c0 + 4 <= N) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c0 + c < N) o[c] = acc[m][c];
    }
  }
}

template <int BM, typename TA, typename TB, int KB>
cudaError_t launch_quant(const Args& a) {
  constexpr int VEC = 16 / sizeof(TB);
  const int ncw = a.bn / kQWarpCols;
  const int tile_bytes = a.bk * a.bn * static_cast<int>(sizeof(TB));
  if (a.bn % kQWarpCols != 0 || ncw < 1 || kQWarps % (ncw * (BM / 8)) != 0 ||
      a.bn / VEC > kQThreads || tile_bytes > kQMaxTileBytes)
    return cudaErrorInvalidValue;
  const int group = kQWarps / ncw / (BM / 8);
  const bool vec_ok = a.N % VEC == 0 &&
                      (reinterpret_cast<uintptr_t>(a.dense) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(a.out) & 15) == 0;
  const bool a_words = (reinterpret_cast<uintptr_t>(a.blocks) & 3) == 0;
  auto kernel = spmm_quant_kernel<BM, TA, TB, KB>;
  // the ring may take the block past 48 KB
  static std::atomic<bool> opted_in[kDevices];
  const cudaError_t err = smem_opt_in(
      opted_in, kernel, quant_smem_bytes(kQMaxTileBytes, kMaxBK));
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + a.bn - 1) / a.bn, a.batch, (a.gm + group - 1) / group);
  kernel<<<grid, kQThreads, quant_smem_bytes(tile_bytes, a.bk), a.stream>>>(
      a.indptr, a.block_cols, static_cast<const unsigned char*>(a.blocks),
      a.scales, static_cast<const TB*>(a.dense), static_cast<float*>(a.out),
      a.gm, a.nnzb, a.bk, a.K, a.N, a.bn, group, quant_sync(tile_bytes),
      vec_ok, a_words);
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

// K2q: narrow blocks, f32 output only; bk 8 compiled apart
template <int BM, typename TA, typename TB>
cudaError_t dispatch_quant_bk(const Args& a) {
  if (a.bk == 8) return launch_quant<BM, TA, TB, 8>(a);
  return launch_quant<BM, TA, TB, 0>(a);
}

template <int BM, typename TA>
cudaError_t dispatch_quant(const Args& a, int b_dtype, int o_dtype) {
  if (a.scales == nullptr || o_dtype != kF32) return cudaErrorInvalidValue;
  if (b_dtype == kF32) return dispatch_quant_bk<BM, TA, float>(a);
  if (b_dtype == kBF16) return dispatch_quant_bk<BM, TA, __nv_bfloat16>(a);
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
// 1 <= bk <= 32; bn (output columns per thread block): for wide blocks a
// multiple of 32 x VEC with bn / VEC <= 256 threads, VEC = 16 /
// sizeof(dense) (4 for f32, 8 for bf16); for K2q 128 x a power of two with
// (bm / 8) x (bn / 128) <= 8 warps and bk x bn dense values in 32 KB.
int spmm_bcsr_launch(const int32_t* indptr, const int32_t* block_cols,
                     const void* blocks, const float* scales,
                     const void* dense, void* out,
                     int batch, int gm, int nnzb, int bm, int bk, int K,
                     int N, int bn, int a_dtype, int b_dtype, int o_dtype,
                     void* stream) {
  if (bk < 1 || bk > kMaxBK || bn < 1 || batch < 1 || gm < 1 || N < 1)
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
