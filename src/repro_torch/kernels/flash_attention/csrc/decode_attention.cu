// D1: one-token decode attention for Hopper (sm_90a), batch-invariant.
//
// No TPU kernel to replace: the reference computes `decode_attention`
// (src/repro/kernels/flash_attention/ops.py:212) as plain array code.  This
// kernel computes that function in the same order of operations:
//   qg  = cast_cache((q * D^-0.5) in q's dtype)
//   s_j = sum_d qg[d] k_j[d] in f32, for the visible j in
//         [lo, hi) = [max(0, kv_len - window), min(kv_len, S_cap))
//   m   = max_j s_j over ALL visible positions (the row's global max)
//   p_j = exp(s_j - m) in f32,  l = sum_j p_j in f32
//   out = (sum_j f32(cast_cache(p_j)) v_j in f32) / (l == 0 ? 1 : l),
//         cast to q's dtype.
// The narrow cast applies to the unnormalized p against the global max, as
// prefill's chunked attention casts it, so a split over positions has to
// find m first: a flash-decoding rescale of per-split maxima would cast
// other numbers.
//
// The law it exists for: a row's reduction order is a function of that
// row's kv_len, the window and D only -- never of B, the grid, the other
// rows or S_cap -- so a request decoded in a batch of any size gets the bits
// it gets alone.  The order (ref.decode_attention_ordered emulates it):
// - a score: lane l holds dims [l E, l E + E) (E = D / 32, or one dim on
//   lanes < 16 at D 16), sums its E products in index order (from the
//   first product), then a fixed xor-butterfly 16, 8, 4, 2, 1 over the 32
//   lanes;
// - the visible positions are cut into chunks of kChunk counted from lo;
//   chunk c belongs to CTA c mod kCtas of the row's cluster, which takes
//   its chunks in increasing c; position i of a chunk belongs to warp
//   i mod kWarps of that CTA;
// - m is the max over the cluster's maxima (exact in any order);
// - each warp sums p and f32(cast_cache(p)) v from zero over its positions,
//   chunk by chunk; a CTA adds its warps' sums in warp order 0 .. kWarps-1,
//   and the row adds its CTAs' sums in rank order 0 .. kCtas-1.
// Products and sums are __fmul_rn / __fadd_rn (no FMA contraction), exp is
// the full-precision expf, the division is IEEE.  kv_len is read on the
// device (a (B,) int64 tensor, or one int for every row), so the caller
// makes no host sync.  A row with no visible position (kv_len <= 0) gives
// zeros (the plain version, with its finite NEG_INF, gives the mean of V).
//
// Bound and design.  The work is the visible K and V, read once: 4 D Hkv
// (hi - lo) bytes a row at bf16.  At the 4 x 2048 decode step (B 4, 40/8,
// cache 2,064) that is 33.8 MB, 0.0101 ms at 3.35 TB/s: bytes bound it, and
// the card needs ~3.4 MB in flight to reach that rate.  At the 4 x 256 step
// (cache 272) the bytes take 0.00135 ms, less than a launch and the few
// dependent round trips any kernel makes: latency bounds it.  So:
// - one thread-block cluster of kCtas CTAs per (row, kv head), every CTA
//   holding the whole GQA group (g <= 8; larger groups in passes, below),
//   so each K / V byte is read once from device memory; the grid is B Hkv
//   kCtas CTAs whatever the card, two or three resident a SM, and a short
//   row still spreads over kCtas SMs;
// - each warp streams its rows of the CTA's chunks (4 of each 32) through
//   its own ring of kStages stages by 16-byte cp.async: pass 1's K rows,
//   then pass 2's V rows, so the first V rows are in flight before the
//   max exchange (V does not wait for m); at 256 CTAs of kStages - 1 = 3
//   chunks of 8 KB that is 6 MB in flight; no CTA barrier paces the warps
//   inside a pass;
// - a warp takes 4 positions of a chunk for the whole group: it sums all
//   its lanes' products first, then reduces 16 scores at once with a
//   transposed butterfly (transpose_sum: 16 shuffles where 16 butterflies
//   take 80, the same tree, so the same bits), and each lane keeps one
//   (position, head) score: one expf a lane in pass 2, read back by the
//   warp through shared memory for the PV sums;
// - pass 1 keeps each score in shared memory (g x its positions x 4 B, up
//   to kScoreBytes); where a row's CTAs would hold more (rows past ~13 K
//   positions at g 5), pass 2 streams each K tile again before its V tile
//   and recomputes the scores (own_score: a position's 8 heads at once by
//   transpose_sum8, 10 shuffles a position, the same tree, in the few
//   registers the PV sums leave); no global scratch;
// - the CTAs exchange their maxima and then their partial sums through
//   distributed shared memory (cluster.map_shared_rank) after a
//   cluster.sync(): three cluster barriers a launch, no second kernel;
// - 80 registers a thread and 71 KB of shared memory a CTA (bf16, D 128)
//   let three CTAs share a SM, so 45 clusters are resident at once: the
//   32 of the 4 x 2048 step run in one wave.  At D 256 (gemma3-12b) a lane
//   holds 8 dims and the ring doubles (64 KB bf16, 128 KB f32, plus the
//   32 KB of scores and 8 KB of q): two CTAs share a SM at bf16 (at most
//   128 registers a thread), one at f32; the order is the same function of
//   the row, E = 8.  At D 192 (nemotron-4-340b) a lane holds 6 dims, a
//   384-byte row is 24 16-byte copies and the bf16 ring (48 KB) is exactly
//   the warps' partial sums; two CTAs share a SM at bf16, E = 6;
// - a GQA group of more than kGroupMax heads (nemotron-4-340b's 12) is
//   taken in passes of at most kGroupMax heads (12 = 8 + 4), each pass a
//   cluster of its own in the one launch: the grid is (kv head x pass,
//   row), and pass j of kv head h takes heads h g + 8 j on.  A head's
//   order is the same function of its row in any pass (its score, max, p
//   and sums involve no other head), so the passes change no bit; K and V
//   are read once a pass (twice at g 12).
// What is left is arithmetic and latency: without FMA every product is a
// multiply and an add, a few hundred instructions a warp a chunk, so the
// SMs' issue, more than the bytes, paces the longer rows (the score
// products are the largest part), and a launch that finds almost nothing
// to do still waits on three cluster barriers (tools/compare_decode.py
// --ablate times each part).
//
// The split mode, for a decode cache whose sequence is split over ranks
// (the serving steps on a mesh): a rank holds positions [offset, offset +
// S) of every row, and the row's visible range [max(0, kv_len - window),
// kv_len) is the whole row's, so the shard's part of it is [lo, hi) =
// that range less the offset, clamped to [0, S).  Two launches give one
// device's arithmetic:
// - kMax: pass 1 only (K read once), and the cluster's max of each
//   (row, head) written as f32, -inf where the shard holds no visible
//   position;
// - kPartial: given m, the max merged over the ranks, pass 2 only (each K
//   tile read again before its V tile, the scores recomputed, as past the
//   score budget), and the unnormalized f32 sums acc = sum cast(p) v and
//   l = sum p written, zeros where the shard holds none.
// The order is D1's with lo and hi the shard's: chunks counted from the
// shard's lo, so a row's partials are a function of its length, the
// window, the offset, S and D, never of B.  The caller sums the ranks'
// partials in rank order and divides (ref.decode_merge): p is rounded as
// on one device, only the sums over shards are taken in another order.
// Bound: kMax reads the shard's visible K, kPartial its visible K and V.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kFull = 0;              // one launch: out = sum p v / l
constexpr int kMax = 1;               // split (a): the shard's max
constexpr int kPartial = 2;           // split (b): the shard's sums
constexpr int kChunk = 32;            // positions a chunk, counted from lo
constexpr int kCtas = 8;              // CTAs a cluster (the portable most)
constexpr int kWarps = 8;             // warps a CTA
constexpr int kScoreBytes = 32768;    // shared memory for a CTA's scores
constexpr int kThreads = 32 * kWarps;
constexpr int kGroupMax = 8;          // query heads a pass (a cluster)
constexpr int kGroupLimit = 16;       // query heads per kv head, in passes
constexpr int kStages = 4;            // ring stages, one tile each
constexpr int kPerWarp = kChunk / kWarps;   // a warp's positions a chunk
static_assert(kChunk % kWarps == 0, "a chunk splits evenly over the warps");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and read back as f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// The fixed butterfly, xor 16, 8, 4, 2, 1 (each level x + shfl_xor(x, o)),
// over N values at once.  One level: x[v] is this lane's partial sum of
// value v; at offset O a lane keeps the half of its values whose bit O
// matches its own and adds its partner's partials of them, in x[0 .. N /
// 2).  Each level adds the same two partials the butterfly adds at that
// offset (a + b == b + a), so the bits are the butterfly's.
template <int O, int N>
__device__ __forceinline__ void transpose_level(float* x, int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float send = up ? x[j] : x[j + N / 2];
    const float keep = up ? x[j + N / 2] : x[j];
    x[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));
  }
}
// 16 values: levels 16, 8, 4 and 2 transposed, then the two lanes left with
// a value add theirs, so lanes j and j ^ 1 end with value j / 2: the sum
// every lane of the butterfly of x[j / 2] would hold, after 16 shuffles.
__device__ __forceinline__ float transpose_sum(float (&x)[16], int lane) {
  transpose_level<16, 16>(x, lane);
  transpose_level<8, 8>(x, lane);
  transpose_level<4, 4>(x, lane);
  transpose_level<2, 2>(x, lane);
  return __fadd_rn(x[0], __shfl_xor_sync(0xffffffffu, x[0], 1));
}
// 8 values: levels 16, 8 and 4 transposed, then 2 and 1 plain, so
// lanes 4 j .. 4 j + 3 end with value j, after 9 shuffles.
__device__ __forceinline__ float transpose_sum8(float (&x)[8], int lane) {
  transpose_level<16, 8>(x, lane);
  transpose_level<8, 4>(x, lane);
  transpose_level<4, 2>(x, lane);
  const float s = __fadd_rn(x[0], __shfl_xor_sync(0xffffffffu, x[0], 2));
  return __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
}

// The score a lane ends with: position u of the warp's kPerWarp in a chunk
// (u = 0, 1 from the first transpose_sum on even lanes, u = 2, 3 from the
// second on odd lanes) and head h.
__device__ __forceinline__ int lane_u(int lane) {
  return (lane >> 4) + 2 * (lane & 1);
}
__device__ __forceinline__ int lane_h(int lane) { return (lane >> 1) & 7; }

__device__ __forceinline__ void cp_async16(unsigned smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem),
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

// N values of T read at once, aligned to the largest power of two that
// divides their bytes (a lane's E = 6 dims at D 192: 12 or 24 bytes).
constexpr int vec_align(int bytes) { return bytes & -bytes; }
template <typename T, int N>
struct alignas(vec_align(sizeof(T) * N)) Vec { T v[N]; };

// Dynamic shared memory: the ring, then the scores.  After pass 2 the ring
// holds the warps' partial sums (kWarps x kGroupMax x D f32) and the scores'
// place the CTA's (kGroupMax x D f32), which the cluster reads.
template <typename Tc, int D>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * kChunk * D * static_cast<int>(sizeof(Tc));
}
template <typename Tc, int D>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<Tc, D>() + kScoreBytes;
}

// The scores of warp `warp`'s positions p0 + warp + kWarps u of one K tile
// for the g heads: each product summed first, then a transpose_sum for
// positions u = 0, 1 and one for u = 2, 3; the lane keeps the score of
// (lane_u, lane_h) and stores it to scores[h * cap + base + i] where
// `store`.  Returns it, or -inf where that is not a visible position of a
// head of the group.
template <typename Tc, int D>
__device__ __forceinline__ float tile_scores(
    const Tc* tile, const float (*qg)[D], int p0, int hi, int g, int warp,
    int lane, float* scores, int cap, int base, bool store) {
  constexpr int E = D >= 32 ? D / 32 : 1;
  constexpr int kLanes = D >= 32 ? 32 : D;
  static_assert(kPerWarp == 4 && kGroupMax == 8, "two scores a lane pair");
  const bool holds = lane < kLanes;
  float half[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {          // positions u = 2 c, 2 c + 1
    float kf[2][E], x[16];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int i = warp + kWarps * (2 * c + a);
      if (holds && p0 + i < hi) {
        const Vec<Tc, E> kv =
            *reinterpret_cast<const Vec<Tc, E>*>(tile + (2 * c + a) * D +
                                                 lane * E);
#pragma unroll
        for (int e = 0; e < E; ++e) kf[a][e] = to_f(kv.v[e]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[a][e] = 0.f;  // no position: a zero
      }
    }
#pragma unroll
    for (int h = 0; h < kGroupMax; ++h) {
      x[h] = x[kGroupMax + h] = 0.f;
      if (h < g && holds) {
        float qh[E];
#pragma unroll
        for (int e = 0; e < E; ++e) qh[e] = qg[h][lane * E + e];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          float part = __fmul_rn(qh[0], kf[a][0]);
#pragma unroll
          for (int e = 1; e < E; ++e)
            part = __fadd_rn(part, __fmul_rn(qh[e], kf[a][e]));
          x[a * kGroupMax + h] = part;
        }
      }
    }
    half[c] = transpose_sum(x, lane);
  }
  const float s = lane & 1 ? half[1] : half[0];
  const int h = lane_h(lane), i = warp + kWarps * lane_u(lane);
  if (h >= g || p0 + i >= hi) return -INFINITY;
  if (store) scores[h * cap + base + i] = s;
  return s;
}

// The lane's score of one K tile again (pass 2, where the scores were not
// held), while the PV sums take most registers: a position at a time, its
// heads' products summed and reduced together by transpose_sum8 (the tree
// transpose_sum takes, so the same bits), then each lane takes its
// (lane_u, lane_h) from lane 4 lane_h.
template <typename Tc, int D>
__device__ __forceinline__ float own_score(const Tc* tile,
                                           const float (*qg)[D], int p0,
                                           int hi, int g, int warp,
                                           int lane) {
  constexpr int E = D >= 32 ? D / 32 : 1;
  constexpr int kLanes = D >= 32 ? 32 : D;
  const bool holds = lane < kLanes;
  float s = 0.f;
#pragma unroll 1
  for (int u = 0; u < kPerWarp; ++u) {
    const int i = warp + kWarps * u;
    if (p0 + i >= hi) break;                     // the same for the warp
    float kf[E];
    if (holds) {
      const Vec<Tc, E> kv =
          *reinterpret_cast<const Vec<Tc, E>*>(tile + u * D + lane * E);
#pragma unroll
      for (int e = 0; e < E; ++e) kf[e] = to_f(kv.v[e]);
    }
    float x[kGroupMax];
#pragma unroll
    for (int h = 0; h < kGroupMax; ++h) {
      x[h] = 0.f;
      if (h < g && holds) {
        x[h] = __fmul_rn(qg[h][lane * E], kf[0]);
#pragma unroll
        for (int e = 1; e < E; ++e)
          x[h] = __fadd_rn(x[h], __fmul_rn(qg[h][lane * E + e], kf[e]));
      }
    }
    const float sum = __shfl_sync(0xffffffffu, transpose_sum8(x, lane),
                                  lane_h(lane) << 2);
    if (u == lane_u(lane)) s = sum;
  }
  return s;
}

// Mode kFull writes out; kMax writes the max to f_out (B, Hq); kPartial
// reads the merged max from m_in (B, Hq) and writes acc to f_out (B, Hq,
// D) and l to l_out (B, Hq).
template <int Mode, typename Tq, typename Tc, int D>
__global__ void __cluster_dims__(kCtas, 1, 1)
    __launch_bounds__(kThreads, D <= 128 ? 3 : 2)
decode_attention_kernel(const Tq* __restrict__ q, const Tc* __restrict__ k,
                        const Tc* __restrict__ v, Tq* __restrict__ out,
                        const long long* __restrict__ kv_len, int kv_scalar,
                        int Hq, int Hkv, int S, int window, int offset,
                        float scale, const float* __restrict__ m_in,
                        float* __restrict__ f_out,
                        float* __restrict__ l_out) {
  constexpr int E = D >= 32 ? D / 32 : 1;     // dims a lane
  constexpr int kLanes = D >= 32 ? 32 : D;    // lanes holding dims
  constexpr int kTile = kPerWarp * D;         // elements of a warp's tile
  static_assert(kWarps * kGroupMax * D * 4 <= ring_bytes<Tc, D>() &&
                    kGroupMax * D * 4 <= kScoreBytes,
                "the partial sums fit the ring and the scores' place");
  extern __shared__ __align__(16) unsigned char smem[];
  Tc* ring = reinterpret_cast<Tc*>(smem);
  float* scores = reinterpret_cast<float*>(smem + ring_bytes<Tc, D>());
  __shared__ __align__(16) float qg[kGroupMax][D];
  __shared__ float part_m[kWarps][kGroupMax];
  __shared__ float part_l[kWarps][kGroupMax];
  __shared__ float maxima[kCtas][kGroupMax];
  __shared__ float p_buf[kWarps][2][32];
  __shared__ float cta_m[kGroupMax];
  __shared__ float cta_l[kGroupMax];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // the cluster's (kv head, pass) and the pass's g heads from h0 on
  const int group = Hq / Hkv, passes = (group + kGroupMax - 1) / kGroupMax;
  const int kvh = blockIdx.x / kCtas / passes, b = blockIdx.y;
  const int pass = blockIdx.x / kCtas % passes;
  const int h0 = kvh * group + pass * kGroupMax;
  const int g = min(kGroupMax, group - pass * kGroupMax);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool holds = lane < kLanes;
  // q's group read at once, beside the length (the tiles wait on that)
  constexpr int kQ = (kGroupMax * D + kThreads - 1) / kThreads;
  float qv[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int i = threadIdx.x + j * kThreads;
    qv[j] = i < g * D ? to_f(q[((long long)b * Hq + h0) * D + i]) : 0.f;
  }
  const long long len = kv_len ? kv_len[b] : (long long)kv_scalar;
  // the row's visible positions as this cache's slots [lo, hi): less the
  // offset, clamped to [0, S) (offset 0: hi = min(len, S))
  const long long top = len - offset;
  const long long bot =
      (window >= 0 && len - window > 0 ? len - window : 0) - offset;
  const int hi = (int)(top < 0 ? 0 : top < S ? top : (long long)S);
  const int lo = (int)(bot < 0 ? 0 : bot < S ? bot : (long long)S);
  const int chunks = hi > lo ? (hi - lo + kChunk - 1) / kChunk : 0;
  const int mine = chunks > rank ? (chunks - 1 - rank) / kCtas + 1 : 0;
  const int cap = kScoreBytes / (4 * g);      // scores held a head
  // Rank 0 has the most chunks; the row's CTAs all hold or all recompute
  // (the split mode's kPartial always recomputes: kMax holds none).
  const bool held =
      Mode == kFull && (chunks + kCtas - 1) / kCtas * kChunk <= cap;
  const int k1 = Mode == kPartial ? 0 : mine;   // pass 1's K tiles
  const int tiles = Mode == kMax ? mine : k1 + mine * (held ? 1 : 2);

  // Tile x of this CTA's stream: pass 1's K chunks, then pass 2's V chunks
  // (each after its K chunk again where the scores are not held).  A warp
  // copies its own rows of each (positions warp + kWarps u) into stage x
  // mod kStages of its own ring, lane by lane 16-byte pieces i = lane +
  // 32 j (row i / kPieces); one commit group a tile, empty past the
  // stream.  No CTA barrier paces the warps.
  constexpr int kPieces = D * static_cast<int>(sizeof(Tc)) / 16;  // a row
  constexpr int kCopies = (kPerWarp * kPieces + 31) / 32;         // a lane
  constexpr int kStride = kCtas * kChunk;       // positions from t to t + 1
  const int first = lo + rank * kChunk + warp;  // the warp's row 0, chunk 0
  const long long base = (((long long)b * Hkv + kvh) * S + first) * D;
  Tc* wring = ring + warp * kStages * kTile;
  const unsigned wring_s =
      static_cast<unsigned>(__cvta_generic_to_shared(wring));
  auto issue = [&](int x) {
    if (x < tiles) {
      int t = x;
      bool vt = false;
      if (x >= k1) {
        t = held ? x - k1 : (x - k1) >> 1;
        vt = held || ((x - k1) & 1);
      }
      const Tc* src = (vt ? v : k) + base + (long long)kStride * t * D;
      const int room = hi - first - kStride * t;  // rows u with 8 u < room
      const unsigned to = wring_s + (x % kStages) * kTile * sizeof(Tc);
#pragma unroll
      for (int j = 0; j < kCopies; ++j) {
        const int i = lane + 32 * j, u = i / kPieces;
        if (i < kPerWarp * kPieces && kWarps * u < room)
          cp_async16(to + 16 * i, src + kWarps * u * D +
                                      i % kPieces * (16 / sizeof(Tc)));
      }
    }
    cp_async_commit();
  };
  // Tile x is in shared memory for every lane of the warp, and the stage of
  // tile x - 1 is free again: it takes tile x + kStages - 1.
  auto acquire = [&](int x) {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    issue(x + kStages - 1);
    return static_cast<const Tc*>(wring + (x % kStages) * kTile);
  };

#pragma unroll
  for (int x = 0; x < kStages - 1; ++x) issue(x);
  // qg = cast_cache(round_q(q * scale)), as f32
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < g * D)
      qg[i / D][i % D] = round_to<Tc>(round_to<Tq>(__fmul_rn(qv[j], scale)));
  }
  __syncthreads();

  // pass 1: the scores of this CTA's chunks, and each lane's max of its
  // head's (lane_h); kPartial takes the merged max instead
  float m_lane = -INFINITY;
  if constexpr (Mode == kPartial) {
    if (lane_h(lane) < g) m_lane = m_in[(long long)b * Hq + h0 + lane_h(lane)];
  } else {
    for (int t = 0; t < mine; ++t) {
      const Tc* tile = acquire(t);
      m_lane = fmaxf(m_lane, tile_scores<Tc, D>(
          tile, qg, lo + (rank + kCtas * t) * kChunk, hi, g, warp, lane,
          scores, cap, t * kChunk, held));
    }
    m_lane = fmaxf(m_lane, __shfl_xor_sync(0xffffffffu, m_lane, 1));
    m_lane = fmaxf(m_lane, __shfl_xor_sync(0xffffffffu, m_lane, 16));
    if ((lane & 17) == 0) part_m[warp][lane_h(lane)] = m_lane;
    __syncthreads();
    if (threadIdx.x < kGroupMax) {
      float mm = part_m[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, part_m[w][threadIdx.x]);
      cta_m[threadIdx.x] = mm;
    }
    cluster.sync();                    // every CTA's max is visible
    if (threadIdx.x < kCtas * kGroupMax) {
      const int r = threadIdx.x / kGroupMax, h = threadIdx.x % kGroupMax;
      maxima[r][h] = cluster.map_shared_rank(cta_m, r)[h];
    }
    __syncthreads();
    m_lane = maxima[0][lane_h(lane)];            // the row's max, lane's head
#pragma unroll
    for (int r = 1; r < kCtas; ++r)
      m_lane = fmaxf(m_lane, maxima[r][lane_h(lane)]);
  }
  if constexpr (Mode == kMax) {
    if (rank == 0 && threadIdx.x < g) {
      float mm = maxima[0][threadIdx.x];
#pragma unroll
      for (int r = 1; r < kCtas; ++r) mm = fmaxf(mm, maxima[r][threadIdx.x]);
      f_out[(long long)b * Hq + h0 + threadIdx.x] = mm;
    }
    cp_async_wait<0>();
    cluster.sync();                    // no CTA leaves while its max is read
    return;
  }

  // pass 2: a lane takes p = exp(s - m) of its (lane_u, lane_h), and the
  // warp reads them back to sum the PV product (p cast to the cache type;
  // every lane, its dims) and l (p; lane h < g, head h) over its
  // positions, chunk by chunk
  float* pw = p_buf[warp][0];
  float* pnw = p_buf[warp][1];
  const int hl = lane % kGroupMax;               // the head of lane's l
  float l_lane = 0.f, acc[kGroupMax][E];
#pragma unroll
  for (int h = 0; h < kGroupMax; ++h) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.f;
  }
  for (int t = 0; t < mine; ++t) {
    const int p0 = lo + (rank + kCtas * t) * kChunk;
    const int own = warp + kWarps * lane_u(lane);        // lane's position
    const bool valid = lane_h(lane) < g && p0 + own < hi;
    float s = 0.f;
    if (!held)                         // this chunk's scores again
      s = own_score<Tc, D>(acquire(k1 + 2 * t), qg, p0, hi, g, warp, lane);
    else if (valid)
      s = scores[lane_h(lane) * cap + t * kChunk + own];
    const Tc* vt = acquire(held ? k1 + t : k1 + 2 * t + 1);
    // (acquire's __syncwarp: every lane has read the last chunk's p_buf)
    const float p = valid ? expf(__fsub_rn(s, m_lane)) : 0.f;
    pw[lane_u(lane) * kGroupMax + lane_h(lane)] = p;
    pnw[lane_u(lane) * kGroupMax + lane_h(lane)] = round_to<Tc>(p);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kPerWarp; ++u) {
      const int i = warp + kWarps * u;
      if (p0 + i >= hi) break;                   // the same for the warp
      float vf[E];
      if (holds) {
        const Vec<Tc, E> vv =
            *reinterpret_cast<const Vec<Tc, E>*>(vt + u * D + lane * E);
#pragma unroll
        for (int e = 0; e < E; ++e) vf[e] = to_f(vv.v[e]);
      }
      if (hl < g) l_lane = __fadd_rn(l_lane, pw[u * kGroupMax + hl]);
#pragma unroll
      for (int h = 0; h < kGroupMax; ++h) {
        if (h < g) {
          const float pn = pnw[u * kGroupMax + h];
          if (holds) {
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[h][e] = __fadd_rn(acc[h][e], __fmul_rn(pn, vf[e]));
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free

  // the warps' partials in warp order, then the CTAs' in rank order
  float* part_o = reinterpret_cast<float*>(smem);   // (kWarps, kGroupMax, D)
  float* cta_o = scores;                             // (kGroupMax, D)
#pragma unroll
  for (int h = 0; h < kGroupMax; ++h) {
    if (h >= g) break;
    if (holds) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        part_o[(warp * kGroupMax + h) * D + lane * E + e] = acc[h][e];
    }
  }
  if (lane < g) part_l[warp][lane] = l_lane;
  __syncthreads();
  for (int i = threadIdx.x; i < g * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float o = part_o[h * D + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      o = __fadd_rn(o, part_o[(w * kGroupMax + h) * D + d]);
    cta_o[h * D + d] = o;
  }
  if (threadIdx.x < g) {
    float l = part_l[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) l = __fadd_rn(l, part_l[w][threadIdx.x]);
    cta_l[threadIdx.x] = l;
  }
  cluster.sync();                      // every CTA's partials are visible
  for (int i = rank * kThreads + threadIdx.x; i < g * D;
       i += kCtas * kThreads) {
    const int h = i / D, d = i % D;
    float o = cluster.map_shared_rank(cta_o, 0)[h * D + d];
    float l = cluster.map_shared_rank(cta_l, 0)[h];
#pragma unroll
    for (int r = 1; r < kCtas; ++r) {
      o = __fadd_rn(o, cluster.map_shared_rank(cta_o, r)[h * D + d]);
      l = __fadd_rn(l, cluster.map_shared_rank(cta_l, r)[h]);
    }
    if constexpr (Mode == kPartial) {
      f_out[((long long)b * Hq + h0 + h) * D + d] = o;
      if (d == 0) l_out[(long long)b * Hq + h0 + h] = l;
    } else {
      out[((long long)b * Hq + h0 + h) * D + d] =
          from_f<Tq>(__fdiv_rn(o, l == 0.f ? 1.f : l));
    }
  }
  cluster.sync();                      // no CTA leaves while read
}

// The instance's dynamic shared memory allowed past 48 KB, once a device
// (the attribute is the current device's; two first calls at once both set
// it, which is harmless; a device past kDevices sets it every launch).
template <int Mode, typename Tq, typename Tc, int D>
cudaError_t configure() {
  constexpr int kDevices = 64;
  static std::atomic<bool> configured[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && configured[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(decode_attention_kernel<Mode, Tq, Tc, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<Tc, D>());
  if (err == cudaSuccess && dev < kDevices)
    configured[dev].store(true, std::memory_order_release);
  return err;
}

// A launch's arguments (the pointers a mode does not use are null).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const long long* kv_len;
  int kv_scalar, B, Hq, Hkv, S, window, offset;
  float scale;
  const float* m_in;
  float* f_out;
  float* l_out;
  cudaStream_t s;
};

template <int Mode, typename Tq, typename Tc, int D>
int launch_dim(const Args& a) {
  const cudaError_t err = configure<Mode, Tq, Tc, D>();
  if (err != cudaSuccess) return err;
  const int passes = (a.Hq / a.Hkv + kGroupMax - 1) / kGroupMax;
  const dim3 grid(kCtas * a.Hkv * passes, a.B);
  decode_attention_kernel<Mode, Tq, Tc, D>
      <<<grid, kThreads, smem_bytes<Tc, D>(), a.s>>>(
          static_cast<const Tq*>(a.q), static_cast<const Tc*>(a.k),
          static_cast<const Tc*>(a.v), static_cast<Tq*>(a.out), a.kv_len,
          a.kv_scalar, a.Hq, a.Hkv, a.S, a.window, a.offset, a.scale, a.m_in,
          a.f_out, a.l_out);
  return cudaGetLastError();
}

template <int Mode, typename Tq, typename Tc>
int launch_typed(int D, const Args& a) {
  switch (D) {
    case 16: return launch_dim<Mode, Tq, Tc, 16>(a);
    case 64: return launch_dim<Mode, Tq, Tc, 64>(a);
    case 128: return launch_dim<Mode, Tq, Tc, 128>(a);
    case 192: return launch_dim<Mode, Tq, Tc, 192>(a);
    case 256: return launch_dim<Mode, Tq, Tc, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int Mode>
int launch_mode(int D, int q_dtype, int cache_dtype, const Args& a) {
  if (q_dtype == kF32 && cache_dtype == kF32)
    return launch_typed<Mode, float, float>(D, a);
  if (q_dtype == kBF16 && cache_dtype == kBF16)
    return launch_typed<Mode, __nv_bfloat16, __nv_bfloat16>(D, a);
  if (q_dtype == kBF16 && cache_dtype == kF32)
    return launch_typed<Mode, __nv_bfloat16, float>(D, a);
  if (q_dtype == kF32 && cache_dtype == kBF16)
    return launch_typed<Mode, float, __nv_bfloat16>(D, a);
  return cudaErrorInvalidValue;
}

template <typename Tq, typename Tc, int D>
int info_dim(int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = configure<kFull, Tq, Tc, D>();
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr,
                                decode_attention_kernel<kFull, Tq, Tc, D>);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCtas);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem_bytes<Tc, D>();
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        &clusters, decode_attention_kernel<kFull, Tq, Tc, D>, &config);
  if (err != cudaSuccess) return err;
  info[0] = kCtas;
  info[1] = kChunk;
  info[2] = kThreads;
  info[3] = smem_bytes<Tc, D>();
  info[4] = static_cast<int>(attr.sharedSizeBytes);
  info[5] = attr.numRegs;
  info[6] = clusters;
  return cudaSuccess;
}

template <typename Tq, typename Tc>
int info_typed(int D, int* info) {
  switch (D) {
    case 16: return info_dim<Tq, Tc, 16>(info);
    case 64: return info_dim<Tq, Tc, 64>(info);
    case 128: return info_dim<Tq, Tc, 128>(info);
    case 192: return info_dim<Tq, Tc, 192>(info);
    case 256: return info_dim<Tq, Tc, 256>(info);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool valid(const Args& a) {
  return a.B >= 1 && a.B <= 65535 && a.Hkv >= 1 && a.Hkv <= 65535 &&
         a.Hq % a.Hkv == 0 && a.Hq / a.Hkv <= kGroupLimit && a.S >= 1 &&
         aligned16(a.k) && aligned16(a.v);
}

}  // namespace

extern "C" {

// Launches D1 on `stream`; returns cudaGetLastError() after the launch (0 =
// launched).  q: contiguous (B, Hq, 1, D) of `q_dtype`; k, v: contiguous
// (B, Hkv, S, D) of `cache_dtype` (0 = float32, 1 = bfloat16), 16-byte
// aligned; out: (B, Hq, 1, D) of `q_dtype`; kv_len: (B,) int64 on the
// device, or null for `kv_scalar` on every row; window < 0 for none.  D must
// be 16, 64, 128, 192 or 256 and Hq / Hkv at most 16 (past 8 in passes).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* out, const long long* kv_len,
                            int kv_scalar, int B, int Hq, int Hkv, int S,
                            int D, int window, float scale, int q_dtype,
                            int cache_dtype, void* stream) {
  const Args a{q, k, v, out, kv_len, kv_scalar, B, Hq, Hkv, S, window, 0,
               scale, nullptr, nullptr, nullptr,
               static_cast<cudaStream_t>(stream)};
  if (!valid(a)) return cudaErrorInvalidValue;
  return launch_mode<kFull>(D, q_dtype, cache_dtype, a);
}

// The split mode's (a): k a shard (B, Hkv, S, D) holding positions
// [offset, offset + S) of every row, kv_len and window the whole row's;
// writes m_out (B, Hq) f32, each (row, head)'s max over the shard's
// visible positions (-inf where none).  Other arguments as above.
int decode_attention_max_launch(const void* q, const void* k, float* m_out,
                                const long long* kv_len, int kv_scalar,
                                int B, int Hq, int Hkv, int S, int D,
                                int window, int offset, float scale,
                                int q_dtype, int cache_dtype, void* stream) {
  const Args a{q, k, k, nullptr, kv_len, kv_scalar, B, Hq, Hkv, S, window,
               offset, scale, nullptr, m_out, nullptr,
               static_cast<cudaStream_t>(stream)};
  if (!valid(a) || offset < 0) return cudaErrorInvalidValue;
  return launch_mode<kMax>(D, q_dtype, cache_dtype, a);
}

// The split mode's (b): given m (B, Hq) f32, the max merged over the
// shards, writes acc_out (B, Hq, D) = sum cast(p) v and l_out (B, Hq) =
// sum p, f32, p = exp(s - m) over the shard's visible positions (zeros
// where none).  Other arguments as decode_attention_max_launch.
int decode_attention_partial_launch(const void* q, const void* k,
                                    const void* v, const float* m,
                                    float* acc_out, float* l_out,
                                    const long long* kv_len, int kv_scalar,
                                    int B, int Hq, int Hkv, int S, int D,
                                    int window, int offset, float scale,
                                    int q_dtype, int cache_dtype,
                                    void* stream) {
  const Args a{q, k, v, nullptr, kv_len, kv_scalar, B, Hq, Hkv, S, window,
               offset, scale, m, acc_out, l_out,
               static_cast<cudaStream_t>(stream)};
  if (!valid(a) || offset < 0) return cudaErrorInvalidValue;
  return launch_mode<kPartial>(D, q_dtype, cache_dtype, a);
}

// The launch shape of one instance: info[0..6] = CTAs a cluster, positions
// a chunk, threads a CTA, dynamic and static shared memory a CTA (bytes),
// registers a thread, clusters the card holds at once.  Returns a
// cudaError_t (0 = filled).
int decode_attention_info(int D, int q_dtype, int cache_dtype, int* info) {
  if (q_dtype == kF32 && cache_dtype == kF32)
    return info_typed<float, float>(D, info);
  if (q_dtype == kBF16 && cache_dtype == kBF16)
    return info_typed<__nv_bfloat16, __nv_bfloat16>(D, info);
  if (q_dtype == kBF16 && cache_dtype == kF32)
    return info_typed<__nv_bfloat16, float>(D, info);
  if (q_dtype == kF32 && cache_dtype == kBF16)
    return info_typed<float, __nv_bfloat16>(D, info);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
