// Hopper (sm_90a) building blocks of the flash kernels' bf16 path: the
// swizzled shared-memory tile that wgmma's descriptors read, cp.async loads
// into it, the descriptors, and the wgmma instructions with their fences.
//
// A tile is 64 rows x D bf16 (a Q tile, or a K or V tile of 64 keys).  It is
// stored as D / (R / 2) column blocks of 64 rows x R bytes, R = min(2 D, 128);
// inside a block the 16-byte chunks of a row are XOR-swizzled with the
// address bits above the row (the 128-byte swizzle for R = 128, the 32-byte
// one for R = 32), so that the eight rows a tensor-core read touches at
// once fall in different banks.  The same bytes are a K-major operand (rows
// along M or N, D along K: Q and K for S = Q K^T) and an MN-major one (rows
// along K, D along N: V for P V); only the descriptor differs.  The block
// must start on a 1024-byte boundary, where the swizzle pattern repeats.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

constexpr int kTileRows = 64;      // one wgmma M (or a 64-key K / V tile)
constexpr int kThreads = 128;      // one warpgroup

template <int D>
struct Tile {
  static constexpr int kRowBytes = 2 * D < 128 ? 2 * D : 128;   // R
  static constexpr int kBlockBytes = kTileRows * kRowBytes;
  static constexpr int kBytes = kTileRows * D * 2;
  static constexpr int kChunksPerRow = D / 8;   // 16-byte chunks
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 3;  // 128B, 32B
  static_assert(D == 16 || D % 64 == 0, "head dim 16 or a multiple of 64");

  // Byte offset of 16-byte chunk `chunk` of row `row` from the tile start.
  __device__ static uint32_t offset(int row, int chunk) {
    constexpr int per = kRowBytes / 16;
    const uint32_t lin = (chunk / per) * kBlockBytes + row * kRowBytes
                         + (chunk % per) * 16;
    return lin ^ (((lin >> 7) & (per - 1)) << 4);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy rows [0, valid) of a (64, D) row-major bf16 tile at `src` into the
// swizzled tile at shared address `dst`; rows from `valid` on are zeroed
// (no byte past them is read).  All 128 threads take part; the copies are
// asynchronous (cp.async), in the caller's current group.  A thread issues
// its copies at most 8 at a time (D = 256: two rounds of 8; D = 192: two
// of 6), so that no more than 8 addresses are live beside a wide
// accumulator.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int valid, int tid) {
  using T = Tile<D>;
  constexpr int kPerThread = kTileRows * T::kChunksPerRow / kThreads;
  constexpr int kRound = kPerThread <= 8 ? kPerThread
                         : kPerThread % 8 == 0 ? 8 : kPerThread / 2;
  static_assert(kPerThread % kRound == 0 && kRound <= 8,
                "whole rounds of at most 8 copies");
  auto copy = [&](int j) {
    const int i = tid + kThreads * j;
    const int row = i / T::kChunksPerRow, chunk = i % T::kChunksPerRow;
    const bool ok = row < valid;
    const __nv_bfloat16* from = src + (ok ? row * D + chunk * 8 : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst + T::offset(row, chunk)), "l"(from),
                    "r"(ok ? 16 : 0)
                 : "memory");
  };
  if constexpr (kPerThread == kRound) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) copy(j);
  } else {
#pragma unroll 1
    for (int j0 = 0; j0 < kPerThread; j0 += kRound)
#pragma unroll
      for (int j = 0; j < kRound; ++j) copy(j0 + j);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Make this thread's shared-memory writes visible to wgmma, which reads
// through the async proxy (then a barrier makes everyone's visible).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, uint64_t type) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
         | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (type << 62);
}

// K-major operand (Q as A, K as B of S = Q K^T), k-step `kk` (d from 16 kk):
// 32 bytes along the swizzled row, the next column block every R bytes; 8-row
// groups R * 8 bytes apart.
template <int D>
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  using T = Tile<D>;
  const int byte = kk * 32;
  return descriptor(tile + (byte / T::kRowBytes) * T::kBlockBytes
                        + byte % T::kRowBytes,
                    16, 8 * T::kRowBytes, T::kSwizzle);
}

// MN-major operand (V as the transposed B of P V), k-step `j` (keys from
// 16 j): 8-key groups R * 8 bytes apart, 64-wide column blocks a block apart.
template <int D>
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int j) {
  using T = Tile<D>;
  return descriptor(tile + j * 16 * T::kRowBytes, T::kBlockBytes,
                    8 * T::kRowBytes, T::kSwizzle);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warp are pending (groups
// complete in order).
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from touching accumulator registers across the
// asynchronous wgmma: reads after this point depend on it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Keep A-fragment registers alive (unreused) up to this point: a wgmma reads
// them asynchronously until its group has been waited for.
template <int M, int N>
__device__ __forceinline__ void keep(const uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" :: "r"(r[i][j]) : "memory");
}

// Two bf16 (x in the low half) as one 32-bit A-fragment register.
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return (uint32_t)__bfloat16_as_ushort(x.x)
         | ((uint32_t)__bfloat16_as_ushort(x.y) << 16);
}

// Accumulator layout of an m64nNk16 f32 result: thread t of the warpgroup
// holds rows 16 (t / 32) + (t % 32) / 4 and 8 more, columns 8 i + 2 (t % 4)
// and the next, as d[4 i + 2 h + b] (row + 8 h, column + b).  The A-fragment
// layout of k16 columns 16 j .. 16 j + 15 is d[8 j .. 8 j + 7] of such a
// result, in pairs: that is how p goes from S's accumulator into P V.

// d (+)= a b: m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += a b: m64n16k16, A (four bf16 pairs a thread) in registers, B
// MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[8],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b: m64n64k16, A (four bf16 pairs a thread) in registers, B
// MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[32],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b: m64n128k16, A (four bf16 pairs a thread) in registers, B
// MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[64],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace hopper
