// K7: the RWKV-6 chunked WKV recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `wkv_pallas` / `_wkv_kernel` in
// src/repro/kernels/wkv/kernel.py.  Per (batch, head), over chunks of Q
// positions of r, k, v and the log-decay w (< 0), with an (hd, hd) f32
// state S carried from chunk to chunk:
//   cum  = inclusive cumsum of w over the chunk,  excl = the exclusive one,
//   mid  = cum[Q / 2],  last = cum[Q - 1]
//   ri_s = r exp(excl - mid),  kj_s = k exp(mid - cum)
//   att  = strictly-lower(ri_s kj_s^T)
//   y    = att v + ((r u) . k) v + ri_s Sm,      Sm = diag(exp(mid)) S
//   S'   = diag(exp(last - mid)) (Sm + kj_s^T v)
// This is the reference's y = ... + (r exp(excl)) S and
// S' = diag(exp(last)) S + (k exp(last - cum))^T v with the per-channel
// factors moved onto the (hd, hd) state, so that one rescaled pair
// (ri_s, kj_s) serves all four products.  The mid-chunk rescale is kept:
// each exponent spans at most half a chunk of decay, e^65 at the clamp
// (w >= -1), and exp(mid) >= e^-65, exp(last - mid) >= e^-64 stay in f32
// range too.  y is f32; the final state is written out when asked.
//
// Bound: bytes.  Reading r, k, v, w and writing y and the state once is
// 675 MB at B 4, T 2048, 64 heads of 64 (all f32): 0.202 ms at 3.35 TB/s.
// The dots need 16.85 GFLOP (the strictly lower triangle, r S on every chunk
// but the first, the state update); as 3xTF32 on the tensor cores that is
// 0.102 ms at the 495 TFLOP/s TF32 peak (0.251 ms for 16.85 GFLOP at the
// 67 TFLOP/s of f32 CUDA cores).  chip_smoke.py computes both from the run.
//
// Design:
// - Dots on the tensor cores at f32 accuracy (3xTF32, as CUTLASS's
//   OpMultiplyAddFastF32): every f32 operand is split in registers into
//   hi = x rounded to tf32 and lo = x - hi, and each product is lo hi +
//   hi lo + hi hi accumulated in f32 by mma.sync.m16n8k8 tf32 (~21 bits;
//   one TF32 pass misses the 2e-5 tolerance ~20x, tests/test_torch_wkv.py).
//   mma.sync, not wgmma: wgmma takes 32-bit operands K-major from shared
//   memory only, and kj_s is read along both axes (scores: K = channel;
//   update: K = position), so its hi and lo halves would need a shared tile
//   each way; mma.sync loads its fragments from one swizzled f32 tile and
//   splits them in registers.
// - The scores never leave registers.  Warp w owns a 16-row strip of the
//   chunk; it computes the strip's scores 16 columns at a time up to the
//   diagonal, masks them in the accumulator layout and feeds them straight
//   to att v as the A operand: the k index of those 8 columns is permuted
//   (logical t4 <-> column 2 t4, t4 + 4 <-> 2 t4 + 1) for att and for v's
//   rows alike, which turns the m16n8 accumulator layout into the tf32 A
//   layout.  The same permutation orders the channel index of ri_s.
// - Work by warp.  Warps w and w + 4 share an SM sub-partition and take
//   strips w and 7 - w.  The light warps 0-3 (strips 0-3) fetch the next
//   chunk by cp.async as soon as this one's ri_s is in registers and, after
//   their short strips, transform it in place (the cumsum of w log2(e) as a
//   parallel scan, ri_s, kj_s and (r u) k; exp2f throughout); the heavy
//   warps 4-7 take the state update meanwhile.  exp(mid) of the next chunk
//   is applied as S' is stored, so S holds the next chunk's Sm.
// - r, k, w and v are read from device memory once, r S and the update take
//   S from shared memory: one block per (batch, head) loops over its
//   chunks with S resident (the reference's VMEM scratch).  No atomics and a
//   fixed order, so two launches give the same bits.  Every tile is 64 f32
//   wide, unpadded, with an XOR swizzle of 8-column groups that keeps each
//   fragment load free of bank conflicts.
// Shared memory (tuning.wkv_smem_bytes): r and w, k and v twice, and S,
// 212,992 bytes, plus the scan's partials, the decay rows and u: 215,040
// bytes, one block per SM (256 blocks in two waves at the slice's shape).
// One chunk, Q = 128 = 16 rows x 8 warps: a chunk changes no result beyond
// rounding (the callers pad T to whole chunks with zeros).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kHD = 64;               // head dim, the only one any config uses
constexpr int kQ = 128;               // the chunk
constexpr int kWarps = kQ / 16;       // one 16-row strip each
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = kQ * kHD;       // floats in one (Q, hd) tile
constexpr int kLight = kThreads / 2;  // warps 0-3: the short strips
constexpr int kSegs = 4;              // scan segments per channel
constexpr int kSegLen = kQ / kSegs;
constexpr int kItems = kSegs * kHD / kLight;  // (channel, segment) a thread
static_assert(kWarps == 8 && kItems == 2 && (kQ / 2) % kSegLen == 0,
              "the strip pairing and the scan assume 8 warps, 4 segments");

__host__ __device__ constexpr size_t smem_floats() {
  return 6 * (size_t)kTile + kHD * kHD + kSegs * kHD + 4 * kHD;
}

// Element (row, col) of a 64-wide f32 tile.  Column groups of 8 are XORed
// with fsw(row) = (row & 3) ^ ((row >> 2) & 1), a bijection on rows {0..3},
// {4..7}, {0, 2, 4, 6} and {1, 3, 5, 7}: the fragment loads (8 rows x 4
// column pairs, 4 rows x 8 columns, 4 even-or-odd rows x 8 columns) hit 32
// distinct banks, and 16-byte groups stay whole for cp.async.
__host__ __device__ constexpr int fsw(int row) {
  return (row & 3) ^ ((row >> 2) & 1);
}
__device__ __forceinline__ int sw(int row, int col) {
  return row * kHD + (col ^ (fsw(row) << 3));
}

// x = hi + lo: hi = x rounded to tf32, half away from zero (what
// cvt.rna.tf32.f32 gives for a finite x, in two integer instructions where
// cvt takes four), lo = x - hi exactly, passed as f32 bits: the tensor
// cores read its top 19 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b at f32 accuracy: the two small products first, then hi hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// One chunk's (Q, hd) tile, rows `row` elements apart in device memory,
// into a swizzled f32 tile, by the kLight threads of the light warps: f32 by
// cp.async (waited for at the next cp_wait_all), bf16 widened through
// registers.  Thread tid moves the 16-byte group tid % 16 of rows tid / 16 +
// 8 n, all in one swizzle row class.
constexpr int kRowsPass = kLight / 16;
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t row, int tid) {
  const int i = tid >> 4, c = (tid & 15) << 2;
  dst += sw(i, c);
  src += i * row + c;
#pragma unroll
  for (int n = 0; n < kQ / kRowsPass; ++n)
    cp_async16(dst + kRowsPass * n * kHD, src + kRowsPass * n * row);
}
__device__ __forceinline__ void load_tile(float* dst,
                                          const __nv_bfloat16* src,
                                          size_t row, int tid) {
  const int i = tid >> 4, c = (tid & 15) << 2;
  dst += sw(i, c);
  src += i * row + c;
#pragma unroll
  for (int n = 0; n < kQ / kRowsPass; ++n) {
    const uint2 raw =
        *reinterpret_cast<const uint2*>(src + kRowsPass * n * row);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    *reinterpret_cast<float4*>(dst + kRowsPass * n * kHD) =
        make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                    __high2float(hi));
  }
}

// A barrier of the light warps alone.
__device__ __forceinline__ void light_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kLight) : "memory");
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Rows t0.. t0 + 15 of the state update Sm + kj_s^T v into sa, K = the
// chunk's positions in the permuted order (j = 8 ks + 2 t4 as k index t4,
// 2 t4 + 1 as t4 + 4).
__device__ __forceinline__ void update(float (&sa)[8][4], const float* S,
                                       const float* KS, const float* Vc,
                                       int t0, int g, int t4,
                                       const int (&pa)[4],
                                       const int (&pv)[2][4]) {
#pragma unroll
  for (int nd = 0; nd < 8; ++nd)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2 s2 =
          ld2(S + (t0 + 8 * hf) * kHD + pa[nd & 3] + 32 * (nd >> 2));
      sa[nd][2 * hf] = s2.x;
      sa[nd][2 * hf + 1] = s2.y;
    }
  // rows t0 + g (+ 8) of kj_s^T are columns t0 + g (+ 8) of KS
  int pk[2][2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int p = 0; p < 2; ++p)
      pk[e][p] = (2 * t4 + e) * kHD + g + 8 * ((t0 / 8 + p) ^ fsw(2 * t4 + e));
#pragma unroll 2
  for (int ks = 0; ks < kQ / 8; ++ks) {
    const float* kb = KS + 8 * ks * kHD;
    const float* vb = Vc + 8 * ks * kHD;
    uint32_t kh[4], kl[4];
    split(kb[pk[0][0]], kh[0], kl[0]);  // (t0 + g, j = 2 t4)
    split(kb[pk[0][1]], kh[1], kl[1]);  // (t0 + g + 8, 2 t4)
    split(kb[pk[1][0]], kh[2], kl[2]);  // (t0 + g, 2 t4 + 1)
    split(kb[pk[1][1]], kh[3], kl[3]);  // (t0 + g + 8, 2 t4 + 1)
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      uint32_t bh[2], bl[2];
      split(vb[pv[0][nd & 3] + 32 * (nd >> 2)], bh[0], bl[0]);
      split(vb[pv[1][nd & 3] + 32 * (nd >> 2)], bh[1], bl[1]);
      mma3(sa[nd], kh, kl, bh, bl);
    }
  }
}

// S' = diag(dec) sa on the same rows of S, times diag(em) (the next
// chunk's exp(mid), so that S holds its Sm) unless em is null.
__device__ __forceinline__ void store_state(float* S, const float (&sa)[8][4],
                                            const float* dec_s,
                                            const float* em_s, int t0, int g,
                                            const int (&pa)[4]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = t0 + g + 8 * hf;
    const float dec = dec_s[t], em = em_s ? em_s[t] : 1.f;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
      *reinterpret_cast<float2*>(S + (t0 + 8 * hf) * kHD + pa[nd & 3] +
                                 32 * (nd >> 2)) =
          make_float2(__fmul_rn(__fmul_rn(dec, sa[nd][2 * hf]), em),
                      __fmul_rn(__fmul_rn(dec, sa[nd][2 * hf + 1]), em));
  }
}

// The transform of one chunk, by the light warps (thread lt < kLight) once
// its r, k, w have landed: the cumsum of w log2(e) as a parallel scan
// (segments of kSegLen positions per channel, joined through their partial
// sums in a fixed order), so that every exponential is one exp2f; then in
// place ri_s = r exp(excl - mid) in R, kj_s = k exp(mid - cum) in Kn and
// (r u) k in W; exp(last - mid) into dec and exp(mid) into em.
constexpr float kLog2e = 1.44269504088896341f;
__device__ __forceinline__ void transform(float* R, float* Kn, float* W,
                                          float* part, const float* u_s,
                                          float* dec, float* em, int lt) {
  const int ch = lt & (kHD - 1), sg0 = lt / kHD;  // segments sg0 + 2 it
  int cx[4];  // the channel's column in row class q
#pragma unroll
  for (int q = 0; q < 4; ++q) cx[q] = ch ^ (q << 3);
  float cs[kItems][kSegLen];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const float* Wc = W + kSegLen * (sg0 + 2 * it) * kHD;
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < kSegLen; ++l) {
      acc = __fadd_rn(acc, __fmul_rn(Wc[l * kHD + cx[fsw(l)]], kLog2e));
      cs[it][l] = acc;
    }
    part[(sg0 + 2 * it) * kHD + ch] = acc;
  }
  const float w_mid = __fmul_rn(W[(kQ / 2) * kHD + cx[fsw(kQ / 2)]], kLog2e);
  light_sync();
  // the same sums in the same order for every segment of the channel, so
  // that mid equals the cumsum at Q / 2 and last the one at Q - 1
  float pre[kSegs + 1];  // pre[s]: the sum of segments 0 .. s - 1
  pre[0] = 0.f;
#pragma unroll
  for (int s = 0; s < kSegs; ++s)
    pre[s + 1] = __fadd_rn(pre[s], part[s * kHD + ch]);
  const float mid = __fadd_rn(pre[(kQ / 2) / kSegLen], w_mid);
  if (sg0 == 0) {
    dec[ch] = exp2f(__fsub_rn(pre[kSegs], mid));
    em[ch] = exp2f(mid);
  }
  const float uc = u_s[ch];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int sg = sg0 + 2 * it;
    float* Rc = R + kSegLen * sg * kHD;
    float* Kc = Kn + kSegLen * sg * kHD;
    float* Wc = W + kSegLen * sg * kHD;
    // the segment's r and k first: the stores below could alias them as
    // far as the compiler can tell, and would wait on each load in turn
    float rr[kSegLen], kr[kSegLen];
#pragma unroll
    for (int l = 0; l < kSegLen; ++l) {
      rr[l] = Rc[l * kHD + cx[fsw(l)]];
      kr[l] = Kc[l * kHD + cx[fsw(l)]];
    }
    const float off = sg0 == 0 ? pre[2 * it] : pre[1 + 2 * it];
    float excl = off;
#pragma unroll
    for (int l = 0; l < kSegLen; ++l) {
      const int o = l * kHD + cx[fsw(l)];
      const float cum = __fadd_rn(off, cs[it][l]);
      Rc[o] = __fmul_rn(rr[l], exp2f(__fsub_rn(excl, mid)));
      Kc[o] = __fmul_rn(kr[l], exp2f(__fsub_rn(mid, cum)));
      Wc[o] = __fmul_rn(__fmul_rn(rr[l], uc), kr[l]);
      excl = cum;
    }
  }
}

// grid (B * nh), block kThreads, dynamic shared memory smem_floats() floats.
// r, k, v: (B, T, nh, hd) in T_; w: the same shape in TW; u: (nh, hd) f32;
// y: (B, T, nh, hd) f32; s_out: (B, nh, hd, hd) f32 or null.
//
// Fragment addressing: a lane (g = lane / 4, t4 = lane % 4) reads rows whose
// swizzle class (row % 8) is fixed by its lane, so each fragment address is
// a per-lane offset plus a constant.  pa[q]: row class g, columns 8 c + 2 t4
// (and + 1) with c % 4 = q; pv[e][q]: row class 2 t4 + e, column 8 c + g
// with c % 4 = q.  Column groups c >= 4 add 32.
template <typename T_, typename TW>
__global__ void __launch_bounds__(kThreads, 1)
    wkv_kernel(const T_* __restrict__ r, const T_* __restrict__ k,
               const T_* __restrict__ v, const TW* __restrict__ w,
               const float* __restrict__ u, float* __restrict__ y,
               float* __restrict__ s_out, int T, int nh) {
  extern __shared__ __align__(16) float sm[];
  float* R = sm;                      // r, then ri_s
  float* W = R + kTile;               // w, then (r u) k
  float* KS0 = W + kTile;             // k, then kj_s: chunk c at (c & 1) kTile
  float* V0 = KS0 + 2 * kTile;        // v: chunk c at (c & 1) kTile
  float* S = V0 + 2 * kTile;          // (hd, hd): Sm of the chunk in flight
  float* part = S + kHD * kHD;        // (kSegs, hd) scan partials
  float* dec_s = part + kSegs * kHD;  // exp(last - mid): chunk c at (c & 1) hd
  float* em_s = dec_s + 2 * kHD;      // exp(mid) of the next chunk
  float* u_s = em_s + kHD;            // u of the head

  const int b = blockIdx.x / nh, h = blockIdx.x % nh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool light = warp < 4;
  const int strip = light ? warp : 11 - warp;
  const int i0 = 16 * strip;
  const size_t row = (size_t)nh * kHD;  // elements from a position to the next
  const size_t head = (size_t)b * T * row + (size_t)h * kHD;
  const int nc = T / kQ;

  int pa[4], pv[2][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    pa[q] = g * kHD + 2 * t4 + 8 * (q ^ fsw(g));
#pragma unroll
    for (int e = 0; e < 2; ++e)
      pv[e][q] = (2 * t4 + e) * kHD + g + 8 * (q ^ fsw(2 * t4 + e));
  }
  // The state update goes to the heavy warps, which have no transform:
  // warp 4 + m takes rows 16 m.. of S.
  const int t0 = 16 * (warp & 3);

  for (int e = tid; e < kHD * kHD; e += kThreads) S[e] = 0.f;
  if (light) {  // the first chunk: fetch it and transform it
    if (tid < kHD) u_s[tid] = u[h * kHD + tid];
    load_tile(R, r + head, row, tid);
    load_tile(W, w + head, row, tid);
    load_tile(KS0, k + head, row, tid);
    load_tile(V0, v + head, row, tid);
    cp_commit();
    cp_wait_all();
    light_sync();
    transform(R, KS0, W, part, u_s, dec_s, em_s, tid);
  }
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const bool more = c + 1 < nc;
    const size_t base = head + (size_t)c * kQ * row;
    const float* Vc = V0 + (c & 1) * kTile;
    const float* KSc = KS0 + (c & 1) * kTile;

    // this warp's strip of ri_s as tf32 A fragments (hi, lo) for k steps of
    // 8 channels, channel 8 kk + 2 t4 as k index t4 and 2 t4 + 1 as t4 + 4;
    // the bonus (r u) . k of rows g, g + 8
    uint32_t ah[8][4], al[8][4];
    float bonus[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int o = (i0 + 8 * hf) * kHD + pa[kk & 3] + 32 * (kk >> 2);
        const float2 ri = ld2(R + o), ruk = ld2(W + o);
        bonus[hf] = __fadd_rn(bonus[hf], __fadd_rn(ruk.x, ruk.y));
        split(ri.x, ah[kk][hf], al[kk][hf]);
        split(ri.y, ah[kk][2 + hf], al[kk][2 + hf]);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
        bonus[hf] =
            __fadd_rn(bonus[hf], __shfl_xor_sync(0xffffffffu, bonus[hf], o));
    __syncthreads();  // R and W are free
    if (light && more) {  // fetch the next chunk behind this one's products
      const size_t next = base + kQ * row;
      load_tile(R, r + next, row, tid);
      load_tile(W, w + next, row, tid);
      load_tile(KS0 + ((c + 1) & 1) * kTile, k + next, row, tid);
      load_tile(V0 + ((c + 1) & 1) * kTile, v + next, row, tid);
      cp_commit();
    }

    // y of the strip: att v, 16 columns of att at a time up to the diagonal
    float ya[8][4];
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[nd][e] = 0.f;
    for (int jb = 0; jb <= strip; ++jb) {
      const float* kb0 = KSc + 16 * jb * kHD;
      const float* vb0 = Vc + 16 * jb * kHD;
      // hi hi, lo hi and hi lo in accumulators of their own: six chains
      float sc[2][4], s1[2][4], s2[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = s1[nt][e] = s2[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float2 kv =
              ld2(kb0 + 8 * nt * kHD + pa[kk & 3] + 32 * (kk >> 2));
          uint32_t bh[2], bl[2];
          split(kv.x, bh[0], bl[0]);
          split(kv.y, bh[1], bl[1]);
          mma(s1[nt], al[kk], bh);
          mma(s2[nt], ah[kk], bl);
          mma(sc[nt], ah[kk], bh);
        }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] = __fadd_rn(__fadd_rn(s1[nt][e], s2[nt][e]), sc[nt][e]);
          // strictly lower: column j < row i, in the accumulator layout
          // (rows g, g + 8; columns 2 t4, 2 t4 + 1 of the n tile)
          if (jb == strip && 8 * nt + 2 * t4 + (e & 1) >= g + 8 * (e >> 1))
            sc[nt][e] = 0.f;
        }
        // the accumulator as the A operand: logical k t4 <-> column 2 t4,
        // t4 + 4 <-> 2 t4 + 1, so v's rows are taken in that order too
        uint32_t ph[4], pl[4];
        split(sc[nt][0], ph[0], pl[0]);
        split(sc[nt][2], ph[1], pl[1]);
        split(sc[nt][1], ph[2], pl[2]);
        split(sc[nt][3], ph[3], pl[3]);
        const float* vb = vb0 + 8 * nt * kHD;
#pragma unroll
        for (int nd = 0; nd < 8; ++nd) {
          uint32_t bh[2], bl[2];
          split(vb[pv[0][nd & 3] + 32 * (nd >> 2)], bh[0], bl[0]);
          split(vb[pv[1][nd & 3] + 32 * (nd >> 2)], bh[1], bl[1]);
          mma3(ya[nd], ph, pl, bh, bl);
        }
      }
    }
    if (c > 0) {  // + ri_s Sm, channels in the fragments' order
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float* sb = S + 8 * kk * kHD;
#pragma unroll
        for (int nd = 0; nd < 8; ++nd) {
          uint32_t bh[2], bl[2];
          split(sb[pv[0][nd & 3] + 32 * (nd >> 2)], bh[0], bl[0]);
          split(sb[pv[1][nd & 3] + 32 * (nd >> 2)], bh[1], bl[1]);
          mma3(ya[nd], ah[kk], al[kk], bh, bl);
        }
      }
    }
    // + the bonus, and y out: rows g, g + 8, columns 8 nd + 2 t4 (+ 1)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float* yr = y + base + (i0 + g + 8 * hf) * row + 2 * t4;
      const float* vr = Vc + (i0 + 8 * hf) * kHD;
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        const float2 vv = ld2(vr + pa[nd & 3] + 32 * (nd >> 2));
        *reinterpret_cast<float2*>(yr + 8 * nd) = make_float2(
            __fadd_rn(ya[nd][2 * hf], __fmul_rn(bonus[hf], vv.x)),
            __fadd_rn(ya[nd][2 * hf + 1], __fmul_rn(bonus[hf], vv.y)));
      }
    }

    if (light && more) {  // the next chunk's transform
      cp_wait_all();
      light_sync();
      transform(R, KS0 + ((c + 1) & 1) * kTile, W, part, u_s,
                dec_s + ((c + 1) & 1) * kHD, em_s, tid);
    }
    // the state update on this warp's part of S
    float sa[8][4];
    if (!light) update(sa, S, KSc, Vc, t0, g, t4, pa, pv);
    __syncthreads();  // every warp has read Sm; the next chunk is transformed
    if (!light)
      store_state(S, sa, dec_s + (c & 1) * kHD, more ? em_s : nullptr, t0, g,
                  pa);
    __syncthreads();
  }

  if (s_out != nullptr) {
    float* dst = s_out + ((size_t)b * nh + h) * kHD * kHD;
    for (int e = tid; e < kHD * kHD; e += kThreads)
      dst[e] = S[sw(e / kHD, e % kHD)];
  }
}

template <typename T_, typename TW>
int launch_typed(const void* r, const void* k, const void* v, const void* w,
                 const float* u, float* y, float* s_out, int B, int T, int nh,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats();
  cudaError_t e = cudaFuncSetAttribute(
      wkv_kernel<T_, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  wkv_kernel<T_, TW><<<B * nh, kThreads, smem, stream>>>(
      static_cast<const T_*>(r), static_cast<const T_*>(k),
      static_cast<const T_*>(v), static_cast<const TW*>(w), u, y, s_out, T,
      nh);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Launches K7 on `stream`; returns cudaGetLastError() after the launch (0 =
// launched).  r, k, v: contiguous (B, T, nh, hd) of `dtype` (0 = float32,
// 1 = bfloat16); w: the same shape of `w_dtype`, float32 or `dtype` (bf16
// r, k, v with an f32 decay is the reference's mixed case); u: (nh, hd)
// float32; y: (B, T, nh, hd) float32; s_out: (B, nh, hd, hd) float32, or
// null for no state.  hd must be 64, chunk 128, T a positive multiple of
// chunk, and r, k, v, w and y 16-byte aligned.
int wkv_launch(const void* r, const void* k, const void* v, const void* w,
               const float* u, float* y, float* s_out, int B, int T, int nh,
               int hd, int chunk, int dtype, int w_dtype, void* stream) {
  if (hd != kHD || chunk != kQ || T < chunk || T % chunk || B < 1 || nh < 1 ||
      (long long)B * nh > 0x7fffffffLL || !aligned16(r) || !aligned16(k) ||
      !aligned16(v) || !aligned16(w) || !aligned16(y))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && w_dtype == kF32)
    return launch_typed<float, float>(r, k, v, w, u, y, s_out, B, T, nh, s);
  if (dtype == kBF16 && w_dtype == kF32)
    return launch_typed<__nv_bfloat16, float>(r, k, v, w, u, y, s_out, B, T,
                                              nh, s);
  if (dtype == kBF16 && w_dtype == kBF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, y, s_out,
                                                      B, T, nh, s);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
