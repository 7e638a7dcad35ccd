// R1: the MoE router's logits for Hopper (sm_90a), batch-invariant.
//
// No TPU kernel to replace: the reference computes the router product
// `x.astype(f32) @ router.astype(f32)` (src/repro/models/moe.py:232) as plain
// array code.  This kernel computes
//   logits[t, e] = sum_d f32(x[t, d]) f32(W[d, e])
// in one fixed order per (token, expert):
// - lane l of a warp takes d = l, l + 32, l + 64, ... (kLaneStride) and sums
//   its products in that order (__fmul_rn then __fadd_rn, no FMA
//   contraction);
// - then a fixed xor-butterfly over the 32 lanes (kButterfly: 16, 8, 4, 2,
//   1).
// That order is a function of d alone: not of the number of tokens, of the
// tile, of the expert chunk a block takes, or of the grid, so a token's
// logits are the same bits in a prefill or a decode step, in a batch bucket
// or alone.  A library product picks its kernel, and so its summation
// order, by the number of rows.
//
// What bounds it.  A decode step (a few tokens) moves W once (0.33 MB at d
// 5120, E 16, f32): bytes, and the latency of fetching them.  A long
// prefill is bound by instructions: the order forbids FMA, so each term is
// a multiply and an add, 2 T d E f32 instructions on 132 x 128 lanes (~0.045
// ms at 8,192 tokens, above the 0.025 ms of its bytes).  The tiles come from
// the host (`kernels/tuning.py` `router_tiles`, from T, E and the SM count),
// and the launcher takes only the instances below.
// - Few tokens (`router_few_kernel`): a warp takes one token and EF 2
//   experts, read as one aligned pair a row (EF 1 where W's rows hold no
//   aligned pairs: E odd, or W off an aligned start); a block takes 1-8
//   warps (tokens) of one expert group, so the warps of a block read the
//   same W rows.  Nothing is staged: each lane loads a batch of 16 or 32
//   steps of x and of its W row slice before its first add, so whole
//   batches of W are in flight at once, and d is unbounded.
// - Many tokens (`router_many_kernel`): a warp takes TPW of 1-8 tokens and
//   a block of 8 warps EC of 4, 8 or 16 experts, so that each W value read from shared
//   memory feeds TPW tokens (TPW x EC accumulators a lane).  W arrives in
//   chunks of 128 rows by 16-byte cp.async into a ring of four stages, as
//   f32, each row at a stride of an odd number of 16-byte groups (EC | 4
//   words), so a lane's EC / 4 `float4` reads of its row are free of bank
//   conflicts.  The block's x rows come the same way, as they are (bf16 or
//   f32), into the same stages: a lane reads its TPW values a step from
//   shared memory at fixed offsets, so no load of x waits in a register and
//   no address is computed per load.  Where rows are not whole aligned
//   16-byte pieces (bf16 W, E not a multiple of 4, d x sizeof(x) not a
//   multiple of 16, a base not 16-byte aligned), the threads stage that
//   operand by their own loads and stores instead (bf16 W widened on the
//   way): the same values land at the same places.
// Both end with the butterfly done as a transposing reduction: at each xor
// level a lane keeps half of its live sums and sends the other half, so a
// lane adds the same two partial sums as the plain butterfly would (a + b ==
// b + a in IEEE arithmetic) with a half, quarter, ... of the shuffles, and
// the lanes end holding distinct results, which they store.  Rows past d
// are zeros on both sides: adding +0 leaves a sum as it is (a running sum
// that starts at +0 is never -0).  Which block, warp, tile or chunk does a
// sum never changes its order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kLaneStride = 32;           // lane l takes d = l, l + 32, ...
constexpr int kButterfly[5] = {16, 8, 4, 2, 1};
__host__ __device__ constexpr int butterfly_offset(int level) {
  return kButterfly[level];
}
constexpr int kMaxWarps = 8;              // the few kernel's warps, at most
constexpr int kDC = 128;                  // W rows a chunk (many tokens)
constexpr int kStages = 4;                // chunks in the shared ring
constexpr int kManyWarps = 8;             // the many kernel's warps
constexpr int kManyThreads = 32 * kManyWarps;
constexpr int kSmemMax = 232448;          // bytes a block may use

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
// Both kernels' launch bounds name one block an SM as their minimum:
// without it ptxas held some instances to 64 or 128 registers and spilled.

// x and W as loaded: a bf16 value stays its 16 bits in a register until
// it is used, so no instruction waits on a load before its value is needed.
template <typename T>
struct Raw {
  using type = float;
};
template <>
struct Raw<__nv_bfloat16> {
  using type = unsigned short;
};
__device__ __forceinline__ float load_raw(const float* p) { return __ldg(p); }
__device__ __forceinline__ unsigned short load_raw(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
// Widened exactly: a bf16 is the upper half of the f32 of the same value.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// One term of a lane's sum: acc + x w, each rounded to f32.
__device__ __forceinline__ float term(float acc, float x, float w) {
  return __fadd_rn(acc, __fmul_rn(x, w));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The butterfly over N lane sums a lane holds (N a power of two), level L
// of kButterfly with S sums still live: a lane whose bit O is set keeps the
// upper half and sends the lower, its partner the other way round, and
// each adds what it keeps to what it receives.  After the last level slot
// k of lane l holds item k + (N / 32) l when N >= 32, else slot 0 holds
// item l / (32 / N) (every lane of that group holds it).
template <int N, int S, int L>
__device__ __forceinline__ void butterfly(float (&v)[N], int lane) {
  if constexpr (L < 5) {
    constexpr int O = butterfly_offset(L);
    if constexpr (S > 1) {
      constexpr int H = S / 2;
      const bool up = lane & O;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float send = up ? v[k] : v[k + H];
        const float keep = up ? v[k + H] : v[k];
        v[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));
      }
      butterfly<N, H, L + 1>(v, lane);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], O));
      butterfly<N, 1, L + 1>(v, lane);
    }
  }
}

// Reduce the N sums of a warp and store each item i of its tile through
// `store(i, value)`, from one lane.
template <int N, typename Store>
__device__ __forceinline__ void reduce_store(float (&v)[N], int lane,
                                             Store store) {
  butterfly<N, N, 0>(v, lane);
  if constexpr (N >= 32) {
#pragma unroll
    for (int k = 0; k < N / 32; ++k) store(k + (N / 32) * lane, v[k]);
  } else {
    if (lane % (32 / N) == 0) store(lane / (32 / N), v[0]);
  }
}

// EF raw W values of a row, loaded as one aligned EF-wide load.
template <typename R, int EF>
struct alignas(EF * sizeof(R)) WRow {
  R v[EF];
};

// W[i, e0 + e] for e < EF as raw values (E % EF == 0, W aligned to EF).
template <typename Tw, int EF, typename R = typename Raw<Tw>::type>
__device__ __forceinline__ void load_row(const Tw* p, R (&out)[EF]) {
  const WRow<R, EF> r = *reinterpret_cast<const WRow<R, EF>*>(p);
#pragma unroll
  for (int e = 0; e < EF; ++e) out[e] = r.v[e];
}

// One lane's sums over its steps of d for one token and EF experts, G
// steps loaded at a time before any is used: whole batches first, with no
// bound check, then the last one, whose steps past d load from a clamped
// row and count as zeros.
template <typename Tx, typename Tw, int EF>
__device__ __forceinline__ void few_sums(const Tx* __restrict__ xr,
                                         const Tw* __restrict__ wc, int lane,
                                         int d, int E, float (&acc)[EF]) {
  constexpr int G = sizeof(Tw) == 4 ? 32 : 16;
  using RX = typename Raw<Tx>::type;
  using RW = typename Raw<Tw>::type;
  auto add = [&](const RX (&xv)[G], const RW (&wv)[G][EF]) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float xf = to_f(xv[g]);
#pragma unroll
      for (int e = 0; e < EF; ++e) acc[e] = term(acc[e], xf, to_f(wv[g][e]));
    }
  };
  const int full = d / (kLaneStride * G);
  int i0 = lane;
  for (int b = 0; b < full; ++b, i0 += kLaneStride * G) {
    RX xv[G];
    RW wv[G][EF];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = i0 + kLaneStride * g;
      xv[g] = load_raw(xr + i);
      load_row<Tw, EF>(wc + (long long)i * E, wv[g]);
    }
    add(xv, wv);
  }
  if (full * kLaneStride * G < d) {
    RX xv[G];
    RW wv[G][EF];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = i0 + kLaneStride * g;
      const int ic = i < d ? i : d - 1;
      const RX xr_i = load_raw(xr + ic);
      load_row<Tw, EF>(wc + (long long)ic * E, wv[g]);
      xv[g] = i < d ? xr_i : RX(0);
#pragma unroll
      for (int e = 0; e < EF; ++e) wv[g][e] = i < d ? wv[g][e] : RW(0);
    }
    add(xv, wv);
  }
}

// A few tokens: warp w of block (bx, by) takes token bx * warps + w and
// experts [by EF, by EF + EF) (E % EF == 0).
template <typename Tx, typename Tw, int EF>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
router_few_kernel(const Tx* __restrict__ x, const Tw* __restrict__ w,
                  float* __restrict__ out, int T, int d, int E) {
  const int lane = threadIdx.x & 31;
  const long long t =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (t >= T) return;                        // whole warps; no barrier
  const int e0 = blockIdx.y * EF;
  float acc[EF];
#pragma unroll
  for (int e = 0; e < EF; ++e) acc[e] = 0.f;
  few_sums<Tx, Tw, EF>(x + t * d, w + e0, lane, d, E, acc);
  reduce_store<EF>(acc, lane,
                   [&](int e, float s) { out[t * E + e0 + e] = s; });
}

template <typename Tx, int TPW, int EC>
constexpr size_t many_smem_bytes() {
  return sizeof(float) * kStages * kDC * (EC | 4) +
         sizeof(typename Raw<Tx>::type) * kStages * kManyWarps * TPW * kDC;
}

// Many tokens: warp w of block (bx, by) takes tokens (bx kManyWarps + w)
// TPW + [0, TPW) and experts [by EC, by EC + EC).  Each chunk of kDC rows
// of W (f32, at a row stride of EC | 4 words) and of the block's x rows
// (raw) is staged once for all the block's warps, kStages - 1 chunks ahead;
// a thread's 16-byte copies sit at the same places in every chunk, so
// their addresses are set up once.  `xcopy` / `wcopy`: that operand's rows
// are whole aligned 16-byte pieces, which cp.async copies; else the
// threads load and store it.
template <typename Tx, typename Tw, int TPW, int EC>
__global__ void __launch_bounds__(kManyThreads, 1)
router_many_kernel(const Tx* __restrict__ x, const Tw* __restrict__ w,
                   float* __restrict__ out, int T, int d, int E, int xcopy,
                   int wcopy) {
  constexpr int SW = EC | 4;                 // row stride: odd 16-byte groups
  constexpr int STEPS = kDC / kLaneStride;
  constexpr int ROWS = kManyWarps * TPW;     // the block's tokens
  using RX = typename Raw<Tx>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sw = reinterpret_cast<float*>(smem);           // [stage][kDC][SW]
  RX* sx = reinterpret_cast<RX*>(sw + kStages * kDC * SW);  // [stage][row][kDC]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e0 = blockIdx.y * EC;
  const int ne = E - e0 < EC ? E - e0 : EC;
  const long long tb = (long long)blockIdx.x * ROWS;
  const int chunks = (d + kDC - 1) / kDC;

  // x by 16-byte copies: thread tid takes piece xq of rows xr0 + k XR.
  constexpr int XV = 16 / sizeof(RX), XP = kDC / XV, XR = kManyThreads / XP;
  constexpr int NX = (ROWS * XP + kManyThreads - 1) / kManyThreads;
  const int xq = tid % XP, xr0 = tid / XP;
  const long long xoff = (tb + xr0) * d + xq * XV;
  const long long xstep = static_cast<long long>(XR) * d;
  unsigned xtok = 0;                         // bit k: row k is a token
#pragma unroll
  for (int k = 0; k < NX; ++k)
    if (xr0 + k * XR < ROWS && tb + xr0 + k * XR < T) xtok |= 1u << k;
  // W by 16-byte copies: thread tid takes experts [we, we + 4) of rows
  // wr0 + k WR.
  constexpr int WQ = EC / 4, WR = kManyThreads / WQ;
  constexpr int NW = (kDC + WR - 1) / WR;
  const int we = 4 * (tid % WQ), wr0 = tid / WQ;

  auto stage_x = [&](int c, int buf) {
    RX* dst = sx + buf * ROWS * kDC;
    if (xcopy) {
      const int left = d - (c * kDC + xq * XV);
      const int n = left <= 0 ? 0 : left < XV ? left : XV;
      const long long src = xoff + static_cast<long long>(c) * kDC;
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        if (xr0 + k * XR >= ROWS) break;
        const bool ok = (xtok >> k & 1u) && n > 0;
        cp_async16(dst + (xr0 + k * XR) * kDC + xq * XV,
                   ok ? x + src + k * xstep : x,
                   ok ? n * static_cast<int>(sizeof(RX)) : 0);
      }
      return;
    }
    for (int j = tid; j < ROWS * kDC; j += kManyThreads) {
      const int r = j / kDC, col = c * kDC + j % kDC;
      const long long t = tb + r;
      dst[j] = t < T && col < d ? load_raw(x + t * d + col) : RX(0);
    }
  };
  auto stage_w = [&](int c, int buf) {
    float* dst = sw + buf * kDC * SW;
    if (wcopy) {                             // f32, E % 4 == 0, aligned
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        const int r = wr0 + k * WR, dd = c * kDC + r;
        if (r >= kDC) break;
        const bool ok = dd < d && we < ne;
        cp_async16(dst + r * SW + we,
                   ok ? w + static_cast<long long>(dd) * E + e0 + we : w,
                   ok ? 16 : 0);
      }
    } else {                       // by the threads; bf16 W widened
#pragma unroll 4
      for (int j = tid; j < kDC * EC; j += kManyThreads) {
        const int r = j / EC, e = j % EC, dd = c * kDC + r;
        dst[r * SW + e] =
            dd < d && e < ne
                ? to_f(load_raw(w + static_cast<long long>(dd) * E + e0 + e))
                : 0.f;
      }
    }
  };
  auto stage = [&](int c) {
    stage_x(c, c % kStages);
    stage_w(c, c % kStages);
  };

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) stage(s);
    cp_async_commit();
  }
  float acc[TPW * EC];
#pragma unroll
  for (int k = 0; k < TPW * EC; ++k) acc[k] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();            // chunk c is here ...
    __syncthreads();             // ... for every thread; chunk c - 1 done
    const int next = c + kStages - 1;        // into chunk c - 1's stage
    if (next < chunks) stage(next);
    cp_async_commit();
    const int buf = c % kStages;
    const float* wr = sw + buf * kDC * SW + lane * SW;
    const RX* xr = sx + buf * ROWS * kDC + warp * TPW * kDC + lane;
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      float wv[EC];
#pragma unroll
      for (int q = 0; q < EC / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            wr + kLaneStride * j * SW + 4 * q);
        wv[4 * q] = v.x;
        wv[4 * q + 1] = v.y;
        wv[4 * q + 2] = v.z;
        wv[4 * q + 3] = v.w;
      }
      float xc[TPW];
#pragma unroll
      for (int t = 0; t < TPW; ++t)
        xc[t] = to_f(xr[t * kDC + kLaneStride * j]);
#pragma unroll
      for (int t = 0; t < TPW; ++t)
#pragma unroll
        for (int e = 0; e < EC; ++e)
          acc[t * EC + e] = term(acc[t * EC + e], xc[t], wv[e]);
    }
  }
  const long long t0 = tb + warp * TPW;
  reduce_store<TPW * EC>(acc, lane, [&](int i, float s) {
    const int t = i / EC, e = i % EC;
    if (t0 + t < T && e < ne) out[(t0 + t) * E + e0 + e] = s;
  });
}

// The instances: (tokens a warp, experts a block) of the many kernel and
// experts a warp of the few one.  `kernels/tuning.py` ROUTER_MANY_TILES and
// ROUTER_FEW_EXPERTS name the same sets.
#define R1_MANY_TILES(X)                                                    \
  X(1, 4) X(1, 8) X(1, 16) X(2, 4) X(2, 8) X(2, 16) X(4, 4) X(4, 8)         \
  X(4, 16) X(8, 4) X(8, 8) X(8, 16)
#define R1_FEW_EXPERTS(X) X(1) X(2)

template <typename Tx, typename Tw, int TPW, int EC>
int launch_many(const Tx* x, const Tw* w, float* out, int T, int d, int E,
                cudaStream_t s) {
  constexpr size_t smem = many_smem_bytes<Tx, TPW, EC>();
  static_assert(smem <= kSmemMax, "the many kernel's stages overflow");
  static std::atomic<bool> configured[kDevices];  // an instance a device
  const cudaError_t err = smem_opt_in(
      configured, router_many_kernel<Tx, Tw, TPW, EC>, smem);
  if (err != cudaSuccess) return err;
  const int xcopy = (d * sizeof(Tx)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int wcopy = std::is_same<Tw, float>::value && E % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  constexpr long long per_block = static_cast<long long>(TPW) * kManyWarps;
  const dim3 grid(static_cast<unsigned>((T + per_block - 1) / per_block),
                  (E + EC - 1) / EC);
  router_many_kernel<Tx, Tw, TPW, EC><<<grid, kManyThreads, smem, s>>>(
      x, w, out, T, d, E, xcopy, wcopy);
  return cudaGetLastError();
}

// `tokens`: tokens a warp (many) or warps, one token each, a block (few);
// `ec`: experts a block (the few kernel's warps each take all of them).
template <typename Tx, typename Tw>
int launch_typed(const void* xp, const void* wp, float* out, int T, int d,
                 int E, int staged, int tokens, int ec, cudaStream_t s) {
  const Tx* x = static_cast<const Tx*>(xp);
  const Tw* w = static_cast<const Tw*>(wp);
  if (!staged) {
    const int warps = tokens;
    if (warps < 1 || warps > kMaxWarps) return cudaErrorInvalidValue;
    if (E % ec != 0 || reinterpret_cast<uintptr_t>(wp) % (ec * sizeof(Tw)))
      ec = 1;                        // no aligned groups of ec: the same sums
    const dim3 grid((unsigned)(((long long)T + warps - 1) / warps),
                    (E + ec - 1) / ec);
#define R1_FEW(EF)                                                          \
  if (ec == EF) {                                                           \
    router_few_kernel<Tx, Tw, EF><<<grid, 32 * warps, 0, s>>>(x, w, out, T, \
                                                              d, E);        \
    return cudaGetLastError();                                              \
  }
    R1_FEW_EXPERTS(R1_FEW)
#undef R1_FEW
    return cudaErrorInvalidValue;
  }
#define R1_MANY(TPW, EC)                                                    \
  if (tokens == TPW && ec == EC)                                            \
    return launch_many<Tx, Tw, TPW, EC>(x, w, out, T, d, E, s);
  R1_MANY_TILES(R1_MANY)
#undef R1_MANY
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches R1 on `stream`; returns cudaGetLastError() after the launch (0 =
// launched).  x: contiguous (T, d) of `x_dtype`; w: contiguous (d, E) of
// `w_dtype` (0 = float32, 1 = bfloat16); out: (T, E) float32.  The tile:
// `staged` 1 = the many-token kernel, 8 warps a block of `tokens` tokens a
// warp and `experts` experts a block; 0 = the few-token kernel, `tokens`
// warps (1-8) a block of one token each, every warp taking the block's
// `experts` experts.  Any other tile is refused.
int router_launch(const void* x, const void* w, float* out, int T, int d,
                  int E, int x_dtype, int w_dtype, int staged, int tokens,
                  int experts, void* stream) {
  if (T < 1 || d < 1 || E < 1 || E > 65535 || tokens < 1 || experts < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBF16 && w_dtype == kF32)
    return launch_typed<__nv_bfloat16, float>(x, w, out, T, d, E, staged,
                                              tokens, experts, s);
  if (x_dtype == kF32 && w_dtype == kF32)
    return launch_typed<float, float>(x, w, out, T, d, E, staged, tokens,
                                      experts, s);
  if (x_dtype == kBF16 && w_dtype == kBF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        x, w, out, T, d, E, staged, tokens, experts, s);
  if (x_dtype == kF32 && w_dtype == kBF16)
    return launch_typed<float, __nv_bfloat16>(x, w, out, T, d, E, staged,
                                              tokens, experts, s);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
