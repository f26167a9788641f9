// Paged decode attention: one query token per slot over the paged KV
// pools, for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/decode_attention.py
// (`paged_attention`, pallas_call at :124).  The contract is
// paddle_tpu/incubate/nn/functional.py `_attend_dense_gqa` over
// `_paged_gather_dense`: slot b's q heads attend pool positions
// [0, lens[b]) through the slot's block table, scores and softmax in f32,
// scale 1/sqrt(D) by default, GQA without repeating KV.  As in the TPU
// kernel, a slot with lens == 0 writes exact zeros, a masked score is
// -1e30 (not -inf), positions past the table (lens > MB * page) are not
// attended, no table entry past the last live page (lens - 1) / page --
// the out-of-range sentinel the scheduler pads with -- is ever read, and
// ids are clamped into [0, NB) all the same.
//
// Bound on an H100: bytes.  Each slot's live K/V rows are read once per
// kv head, shared by the G q heads of that head, at ~4 G operations per
// KV element: the least time is the live KV bytes, 2 * sum(min(lens,
// MB * page)) * H_kv * D * itemsize, over 3.35 TB/s (0.0152 ms at the
// gpt3-6.7b decode row of chip_smoke.py: B 8, 32 kv heads of 128, lens up
// to 512).
//
// Design.  One block of 4 warps per (slot, kv head, tile of q rows, span
// of positions).  The plan (ops/cuda/paged_plan.py) cuts the positions
// into `splits` spans of `per` stages from the shapes alone, never from
// lens or the tables, so a call never waits on the host: the grid holds
// about four blocks per SM when the tables are full, and a block whose
// span starts past its slot's last live position exits at once.
// - Table: a block reads its span's table entries once per page, into
//   shared memory, before its copies start; every copy address then
//   comes from shared memory, not from a dependent global load.
// - Loads: K and V rows by 16-byte cp.async (16 copies a row in bf16 at
//   D 128) into a two-stage shared ring of padded rows: the next stage is
//   in flight while this one is computed.  Positions past the span's last
//   visible one are zero-filled, not read.
// - bf16 and f16 (`tc::`): the G q heads of one kv head form a 16-row
//   tile (zero rows past G; G > 16 takes several tiles).  The 4 warps
//   take a stage's 16-position chunks in turn, S = Q K^T and P V on
//   mma.sync m16n8k16 with f32 sums, operands by ldmatrix, the softmax
//   in registers in the log2 domain (csrc/attn_mma.cuh, shared with the
//   ragged kernel); the warps' states are merged in a fixed order.
// - f32 (`simt::`): tiles of 8 q rows, the same table and ring with
//   stages of 32 positions, SIMT products from the staged rows: a thread
//   per (row, position) score, a warp per row's softmax, a thread per
//   (row, dim) of the accumulator.  (The same SIMT kernel in bf16 ran 14%
//   slower than the 16-row mma tile even at G 1, where 15 of the tile's
//   rows are idle: the kernel waits on memory, and the SIMT path's three
//   barriers a stage cost more than the idle rows.)
// - Spans merged inside the launch.  A slot whose live positions fit in
//   one span is finished by that span's block.  Otherwise each span's
//   block writes f32 partials (m, l, acc) and takes a ticket on its
//   (slot, kv head, tile) counter after a memory fence; the block that
//   draws the last ticket merges the spans in span order (m = max,
//   w = 2^(m_s - m), l = sum w l_s, acc = sum w acc_s) and writes the
//   rows, then resets the counter to 0 for the next call.  One call is
//   one launch; the merge's order never depends on which block finishes
//   last, so two calls give equal bits.  Every span holds a live
//   position, and a warp that saw none carries (-1e30, 0, 0), whose
//   weight is exactly 0.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (chip_smoke.py, compare_paged, device time): 0.0250-0.0259 ms at the
// gpt3-6.7b decode row (59% of its bound; the previous one-block-per-head
// SIMT kernel 0.0375), 0.0140 ms at the llama2-70b GQA row (bound 0.0039;
// previously 0.0490).
#include "attn_mma.cuh"
#include "common.cuh"
#include "sm90.cuh"

#include <cstdint>

namespace {

using attn::kNegInf;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// The shape of one launch, as the plan gives it.
struct Geo {
  int h, nb, page, hkv, mb, g, tiles, trows, splits, per, tslots;
};

// Which positions a block's span covers.
struct Span {
  int nlive;             // spans of the slot holding a live position
  int s_lo, s_hi;        // this span's stages
  int pos_lo, pos_hi;    // its positions (pos_hi: one past the last live)
};

__device__ __forceinline__ Span span_of(const Geo& G, int len, int split,
                                        int stage) {
  Span s;
  const int end = max(0, min(len, G.mb * G.page));
  const int stages = (end + stage - 1) / stage;
  s.nlive = (stages + G.per - 1) / G.per;
  s.s_lo = split * G.per;
  s.s_hi = min(stages, s.s_lo + G.per);
  s.pos_lo = s.s_lo * stage;
  s.pos_hi = min(s.s_hi * stage, end);
  return s;
}

// The span's table entries, clamped, into tbl; returns the first page.
__device__ __forceinline__ int load_table(const Geo& G, const Span& sp,
                                          const int* __restrict__ tables,
                                          int b, int* tbl) {
  const int pf = sp.pos_lo / G.page;
  const int np = (sp.pos_hi - 1) / G.page - pf + 1;
  const int* row = tables + (size_t)b * G.mb + pf;
  for (int i = threadIdx.x; i < np; i += kThreads)
    tbl[i] = min(max(row[i], 0), G.nb - 1);
  return pf;
}

// Pool offset (elements) of position pos's row of kv head hk.
template <int D>
__device__ __forceinline__ size_t pool_row(const Geo& G, const int* tbl,
                                           int pf, int pos, int hk) {
  const int pg = pos / G.page;
  return (((size_t)tbl[pg - pf] * G.page + (pos - pg * G.page)) * G.hkv +
          hk) * D;
}

// The zeros of a slot with no live position (split 0's block).
template <typename T, int D>
__device__ __forceinline__ void write_zeros(T* orow, int nrow) {
  const float z[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int e = threadIdx.x; e < nrow * (D / 8); e += kThreads)
    attn::store8(orow + (size_t)(e / (D / 8)) * D + (e % (D / 8)) * 8, z);
}

// The block's state of its tile's nrow rows -- acc [nrow][D] f32, m and l
// per row, in shared memory -- to the output rows at orow: directly where
// the slot has one span, else through the partials (this span's rows at
// prow + split * trows) and the last block's merge of all nlive spans.
template <typename T, int D>
__device__ void finish(const float* acc, const float* m, const float* l,
                       int nrow, T* orow, float* __restrict__ pacc,
                       float* __restrict__ pml, int* __restrict__ counter,
                       size_t prow, int split, int nlive, int trows) {
  constexpr int C8 = D / 8;
  if (nlive == 1) {
    for (int e = threadIdx.x; e < nrow * C8; e += kThreads) {
      const int r = e / C8, c = e % C8;
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = acc[r * D + c * 8 + i] / l[r];
      attn::store8(orow + (size_t)r * D + c * 8, v);
    }
    return;
  }
  for (int e = threadIdx.x; e < nrow * C8; e += kThreads) {
    const int r = e / C8, c = e % C8;
    const size_t row = prow + (size_t)split * trows + r;
    const float* a = acc + r * D + c * 8;
    __stcg(reinterpret_cast<float4*>(pacc + row * D + c * 8),
           make_float4(a[0], a[1], a[2], a[3]));
    __stcg(reinterpret_cast<float4*>(pacc + row * D + c * 8 + 4),
           make_float4(a[4], a[5], a[6], a[7]));
    if (c == 0)
      __stcg(reinterpret_cast<float2*>(pml + 2 * row),
             make_float2(m[r], l[r]));
  }
  __threadfence();               // the partials before the ticket
  __syncthreads();
  __shared__ int last;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == nlive - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();               // the other spans' partials after it
  for (int e = threadIdx.x; e < nrow * C8; e += kThreads) {
    const int r = e / C8, c = e % C8;
    float mm = kNegInf;
    for (int s = 0; s < nlive; ++s)
      mm = fmaxf(mm, __ldcg(pml + 2 * (prow + (size_t)s * trows + r)));
    float ll = 0.f, v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < nlive; ++s) {
      const size_t row = prow + (size_t)s * trows + r;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(pml + 2 * row));
      const float w = exp2f(ml.x - mm);
      ll += w * ml.y;
      const float4 x0 =
          __ldcg(reinterpret_cast<const float4*>(pacc + row * D + c * 8));
      const float4 x1 =
          __ldcg(reinterpret_cast<const float4*>(pacc + row * D + c * 8 + 4));
      v[0] += w * x0.x; v[1] += w * x0.y; v[2] += w * x0.z; v[3] += w * x0.w;
      v[4] += w * x1.x; v[5] += w * x1.y; v[6] += w * x1.z; v[7] += w * x1.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] /= ll;
    attn::store8(orow + (size_t)r * D + c * 8, v);
  }
  if (threadIdx.x == 0) *counter = 0;       // ready for the next call
}

namespace tc {

constexpr int kStage = 64;     // positions per ring stage
constexpr int kRing = 2;       // stages in the ring
constexpr int kChunk = 16;     // positions per warp product
constexpr int kTile = 16;      // q rows per tile

template <int D>
__host__ __device__ constexpr int ld() {    // padded row, elements
  return D + 8;
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes(int tslots) {
  // the q tile, the ring (kRing stages of K and V), the span's table;
  // the epilogue reuses the ring for each warp's (acc, m, l)
  return (size_t)2 * ld<D>() * (kTile + 2 * kRing * kStage) +
         (size_t)16 * ((tslots + 3) / 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_tc_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                const T* __restrict__ vp, const int* __restrict__ tables,
                const int* __restrict__ lens, T* __restrict__ out,
                float* __restrict__ pacc, float* __restrict__ pml,
                int* __restrict__ counters, Geo G, float scale_log2) {
  constexpr int LD = ld<D>();
  constexpr int CH = D / 8;                  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);                  // [16][LD]
  T* ring = qs + kTile * LD;                  // [kRing][K, V][kStage][LD]
  int* tbl = reinterpret_cast<int*>(ring + 2 * kRing * kStage * LD);

  const int tile = blockIdx.x % G.tiles, split = blockIdx.x / G.tiles;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = tile * kTile, nrow = min(kTile, G.g - r0);
  T* orow = out + ((size_t)b * G.h + hk * G.g + r0) * D;
  const Span sp = span_of(G, lens[b], split, kStage);
  if (sp.nlive == 0) {
    if (split == 0) write_zeros<T, D>(orow, nrow);
    return;
  }
  if (split >= sp.nlive) return;             // past the live positions

  // the tile's q rows (zero rows past the group), then the span's table
  const T* qrow = q + ((size_t)b * G.h + hk * G.g + r0) * D;
  for (int e = tid; e < kTile * CH; e += kThreads) {
    const int r = e / CH, c = e % CH;
    const bool ok = r < nrow;
    sm90::cp_async16(sm90::smem_addr(qs + r * LD + c * 8),
                     ok ? qrow + r * D + c * 8 : q, ok ? 16 : 0);
  }
  const int pf = load_table(G, sp, tables, b, tbl);
  __syncthreads();
  auto load_stage = [&](int st, int buf) {
    T* ks = ring + buf * 2 * kStage * LD;
    T* vs = ks + kStage * LD;
    for (int e = tid; e < kStage * CH; e += kThreads) {
      const int i = e / CH, c = e % CH, pos = st * kStage + i;
      const bool ok = pos < sp.pos_hi;
      const size_t off = ok ? pool_row<D>(G, tbl, pf, pos, hk) + c * 8 : 0;
      sm90::cp_async16(sm90::smem_addr(ks + i * LD + c * 8), kp + off,
                       ok ? 16 : 0);
      sm90::cp_async16(sm90::smem_addr(vs + i * LD + c * 8), vp + off,
                       ok ? 16 : 0);
    }
  };

  // this warp: chunks warp, warp + 4, ... of every stage
  const int gi = lane / 4, ci = lane % 4;
  const int tlim = sp.pos_hi - 1;            // the span's last live position
  const int lim[2] = {gi < nrow ? tlim : -1, gi + 8 < nrow ? tlim : -1};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const uint32_t q_lane = attn::q_lane<LD>(qs, lane);

  // stages s_lo .. s_lo + kRing - 2 in flight, then one more per stage
  // computed; the q tile rides in the first group
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (sp.s_lo + i < sp.s_hi) load_stage(sp.s_lo + i, i);
    sm90::cp_async_commit();
  }
  constexpr int kPer = kStage / kChunk;      // chunks per stage
  for (int st = sp.s_lo; st < sp.s_hi; ++st) {
    const int j = st - sp.s_lo;
    if (st + kRing - 1 < sp.s_hi)
      load_stage(st + kRing - 1, (j + kRing - 1) % kRing);
    sm90::cp_async_commit();
    sm90::cp_async_wait<kRing - 1>();
    __syncthreads();
    const T* ks = ring + (j % kRing) * 2 * kStage * LD;
    const T* vs = ks + kStage * LD;
    // the span's chunks go to the warps in turn
    for (int ch = (warp - j * kPer % kWarps + kWarps) % kWarps; ch < kPer;
         ch += kWarps) {
      const int p0 = st * kStage + ch * kChunk;
      if (p0 > tlim) break;
      attn::chunk<T, D, LD>(acc, m_run, l_run, q_lane, ks + ch * kChunk * LD,
                            vs + ch * kChunk * LD, lane, D, p0, lim,
                            scale_log2);
    }
    __syncthreads();             // the stage's buffer may be refilled
  }
  sm90::cp_async_wait<0>();

  // each warp's state into the ring: acc [warp][16][D], then m, l; the
  // merged state of the 4 warps then goes to warp 0's acc and fm, fl
  float* red = reinterpret_cast<float*>(ring);
  float* mred = red + kWarps * kTile * D;
  float* lred = mred + kWarps * kTile;
  float* fm = lred + kWarps * kTile;
  float* fl = fm + kTile;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(
          red + (warp * kTile + gi + 8 * i) * D + 8 * n + 2 * ci) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  if (ci == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mred[warp * kTile + gi + 8 * i] = m_run[i];
      lred[warp * kTile + gi + 8 * i] = l_run[i];
    }
  __syncthreads();
  for (int e = tid; e < nrow * CH; e += kThreads) {
    const int r = e / CH, c = e % CH;
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, mred[w * kTile + r]);
    float ll = 0.f, v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < kWarps; ++w) {
      const int row = w * kTile + r;
      const float wt = exp2f(mred[row] - mm);
      ll += wt * lred[row];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += wt * red[row * D + c * 8 + i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) red[r * D + c * 8 + i] = v[i];
    if (c == 0) {
      fm[r] = mm;
      fl[r] = ll;
    }
  }
  __syncthreads();
  const size_t prow =
      ((size_t)(b * G.hkv + hk) * G.tiles + tile) * G.splits * G.trows;
  finish<T, D>(red, fm, fl, nrow, orow, pacc, pml,
               counters + (b * G.hkv + hk) * G.tiles + tile, prow, split,
               sp.nlive, G.trows);
}

}  // namespace tc

namespace simt {

constexpr int kRows = 8;       // q rows per tile
constexpr int kRing = 2;       // stages in the ring

constexpr int kStage = 32;     // positions per ring stage

template <int D>
__host__ __device__ constexpr int ld() {      // padded row, elements
  return D + 4;
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes(int tslots) {
  // q [8][D], scores [8][kStage], (m, l, alpha) [8], the ring (kRing
  // stages of K and V), the span's table; the epilogue reuses the ring
  // for the accumulator
  return (size_t)4 * (kRows * D + kRows * kStage + 3 * kRows) +
         (size_t)4 * 2 * kRing * kStage * ld<D>() +
         (size_t)16 * ((tslots + 3) / 4);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_simt_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                  const float* __restrict__ vp,
                  const int* __restrict__ tables,
                  const int* __restrict__ lens, float* __restrict__ out,
                  float* __restrict__ pacc, float* __restrict__ pml,
                  int* __restrict__ counters, Geo G, float scale_log2) {
  constexpr int S = kStage, LD = ld<D>();
  constexpr int CH = D / 4;                  // 16-byte copies per row
  constexpr int PAIRS = kRows * D / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);          // [8][D]
  float* ss = qs + kRows * D;                          // [8][S]
  float* sm_m = ss + kRows * S;                        // [8]
  float* sm_l = sm_m + kRows;                          // [8]
  float* sm_a = sm_l + kRows;                          // [8]
  float* ring = sm_a + kRows;                // [kRing][K, V][S][LD]
  int* tbl = reinterpret_cast<int*>(ring + 2 * kRing * S * LD);

  const int tile = blockIdx.x % G.tiles, split = blockIdx.x / G.tiles;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = tile * kRows, nrow = min(kRows, G.g - r0);
  float* orow = out + ((size_t)b * G.h + hk * G.g + r0) * D;
  const Span sp = span_of(G, lens[b], split, S);
  if (sp.nlive == 0) {
    if (split == 0) write_zeros<float, D>(orow, nrow);
    return;
  }
  if (split >= sp.nlive) return;             // past the live positions

  const float* qrow = q + ((size_t)b * G.h + hk * G.g + r0) * D;
  for (int e = tid; e < nrow * D; e += kThreads) qs[e] = qrow[e];
  for (int r = tid; r < kRows; r += kThreads) {
    sm_m[r] = kNegInf;
    sm_l[r] = 0.f;
  }
  const int pf = load_table(G, sp, tables, b, tbl);
  __syncthreads();
  auto load_stage = [&](int st, int buf) {
    float* ks = ring + buf * 2 * S * LD;
    float* vs = ks + S * LD;
    for (int e = tid; e < S * CH; e += kThreads) {
      const int i = e / CH, c = e % CH, pos = st * S + i;
      const bool ok = pos < sp.pos_hi;
      const size_t off = ok ? pool_row<D>(G, tbl, pf, pos, hk) + c * 4 : 0;
      sm90::cp_async16(sm90::smem_addr(ks + i * LD + c * 4), kp + off,
                       ok ? 16 : 0);
      sm90::cp_async16(sm90::smem_addr(vs + i * LD + c * 4), vp + off,
                       ok ? 16 : 0);
    }
  };

  float acc[PAIRS];
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) acc[k] = 0.f;
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (sp.s_lo + i < sp.s_hi) load_stage(sp.s_lo + i, i);
    sm90::cp_async_commit();
  }
  for (int st = sp.s_lo; st < sp.s_hi; ++st) {
    const int j = st - sp.s_lo;
    if (st + kRing - 1 < sp.s_hi)
      load_stage(st + kRing - 1, (j + kRing - 1) % kRing);
    sm90::cp_async_commit();
    sm90::cp_async_wait<kRing - 1>();
    __syncthreads();
    const float* ks = ring + (j % kRing) * 2 * S * LD;
    const float* vs = ks + S * LD;
    // scores: a thread per (row, position)
    for (int e = tid; e < nrow * S; e += kThreads) {
      const int r = e / S, i = e % S;
      float s = kNegInf;
      if (st * S + i < sp.pos_hi) {
        const float4* qr = reinterpret_cast<const float4*>(qs + r * D);
        const float4* kr = reinterpret_cast<const float4*>(ks + i * LD);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float4 a = qr[c], k = kr[c];
          dot += a.x * k.x;
          dot += a.y * k.y;
          dot += a.z * k.z;
          dot += a.w * k.w;
        }
        s = dot * scale_log2;
      }
      ss[r * S + i] = s;
    }
    __syncthreads();
    // online softmax: a warp per row
    for (int r = warp; r < nrow; r += kWarps) {
      float mx = kNegInf;
      for (int i = lane; i < S; i += 32) mx = fmaxf(mx, ss[r * S + i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm_m[r], m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int i = lane; i < S; i += 32) {
        const float s = ss[r * S + i];
        const float p = s == kNegInf ? 0.f : exp2f(s - m_new);
        ss[r * S + i] = p;
        psum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        sm_l[r] = sm_l[r] * alpha + psum;
        sm_m[r] = m_new;
        sm_a[r] = alpha;
      }
    }
    __syncthreads();
    // P V: a thread per (row, dim)
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const int e = tid + k * kThreads, r = e / D, dd = e % D;
      if (r < nrow) {
        float a = acc[k] * sm_a[r];
        for (int i = 0; i < S; ++i) a += ss[r * S + i] * vs[i * LD + dd];
        acc[k] = a;
      }
    }
    __syncthreads();             // the stage's buffer may be refilled
  }
  sm90::cp_async_wait<0>();

  float* fin = ring;                                   // [8][D]
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) {
    const int e = tid + k * kThreads;
    if (e / D < nrow) fin[e] = acc[k];
  }
  __syncthreads();
  const size_t prow =
      ((size_t)(b * G.hkv + hk) * G.tiles + tile) * G.splits * G.trows;
  finish<float, D>(fin, sm_m, sm_l, nrow, orow, pacc, pml,
               counters + (b * G.hkv + hk) * G.tiles + tile, prow, split,
               sp.nlive, G.trows);
}

}  // namespace simt

// One launch: the tensor-core kernel for 16-bit T, the SIMT one for f32.
template <typename T, int D>
int run(const Geo& G, int b, const void* q, const void* kp, const void* vp,
        const int* tables, const int* lens, void* out, float* pacc,
        float* pml, int* counters, float scale_log2, cudaStream_t stream) {
  const dim3 grid(G.tiles * G.splits, G.hkv, b);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(kp);
  const T* vv = static_cast<const T*>(vp);
  T* oo = static_cast<T*>(out);
  if constexpr (sizeof(T) == 2) {
    const size_t smem = tc::smem_bytes<D>(G.tslots);
    const cudaError_t e =
        pt::allow_smem_once<tc::paged_tc_kernel<T, D>>(smem);
    if (e != cudaSuccess) return (int)e;
    tc::paged_tc_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        qq, kk, vv, tables, lens, oo, pacc, pml, counters, G, scale_log2);
  } else {
    const size_t smem = simt::smem_bytes<D>(G.tslots);
    const cudaError_t e =
        pt::allow_smem_once<simt::paged_simt_kernel<D>>(smem);
    if (e != cudaSuccess) return (int)e;
    simt::paged_simt_kernel<D><<<grid, kThreads, smem, stream>>>(
        qq, kk, vv, tables, lens, oo, pacc, pml, counters, G, scale_log2);
  }
  return 0;
}

template <typename T>
int dispatch(int d, const Geo& G, int b, const void* q, const void* kp,
             const void* vp, const int* tables, const int* lens, void* out,
             float* pacc, float* pml, int* counters, float scale_log2,
             cudaStream_t s) {
  switch (d) {
    case 32:
      return run<T, 32>(G, b, q, kp, vp, tables, lens, out, pacc, pml,
                        counters, scale_log2, s);
    case 64:
      return run<T, 64>(G, b, q, kp, vp, tables, lens, out, pacc, pml,
                        counters, scale_log2, s);
    case 96:
      return run<T, 96>(G, b, q, kp, vp, tables, lens, out, pacc, pml,
                        counters, scale_log2, s);
    case 128:
      return run<T, 128>(G, b, q, kp, vp, tables, lens, out, pacc, pml,
                         counters, scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The plan's checks (ops/cuda/paged_plan.py `check_plan`).
bool plan_ok(const Geo& G, int b, int stage) {
  const int stages = (G.mb * G.page + stage - 1) / stage;
  return G.splits >= 1 && G.per >= 1 && (G.splits - 1) * G.per < stages &&
         G.splits * G.per >= stages && b <= 65535 && G.hkv <= 65535 &&
         (long long)G.tiles * G.splits < (1ll << 31);
}

}  // namespace

// q (b, h, d); pools (nb, page, hkv, d); tables (b, mb) int32; lens (b,)
// int32 -> out (b, h, d).  h % hkv == 0; d in {32, 64, 96, 128}; bf16
// and f16 run the tensor cores, f32 the SIMT kernel.  The plan: positions
// in `splits` spans of `per` stages (64 positions a stage in 16-bit
// types, 32 in f32).  Where splits > 1: the f32 partials pacc (b, hkv,
// tiles, splits, trows, d) and pml (the same rows, (m, l) each) and the
// int32 counters (b, hkv, tiles), zero before the first call and left
// zero by each; trows = min(16 or 8, h / hkv).
extern "C" int pt_paged_attention(const void* q, const void* kp,
                                  const void* vp, const void* tables,
                                  const void* lens, void* out, void* pacc,
                                  void* pml, void* counters, int b, int h,
                                  int nb, int page, int hkv, int d, int mb,
                                  int splits, int per, float scale,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  float* pa = static_cast<float*>(pacc);
  float* pm = static_cast<float*>(pml);
  int* cnt = static_cast<int*>(counters);
  const bool f32 = dtype == PT_F32;
  const int stage = f32 ? simt::kStage : tc::kStage;
  const int rows = f32 ? simt::kRows : tc::kTile;
  if (b < 1 || hkv < 1 || h % hkv || page < 1 || mb < 1 || nb < 1)
    return (int)cudaErrorInvalidValue;
  const int g = h / hkv;
  const Geo G{h, nb, page, hkv, mb, g, (g + rows - 1) / rows,
              g < rows ? g : rows, splits, per,
              (per * stage + page - 1) / page + 1};
  if (!plan_ok(G, b, stage) || (splits > 1 && (!pa || !pm || !cnt)))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  int rc;
  if (f32) {
    rc = dispatch<float>(d, G, b, q, kp, vp, tb, ln, out, pa, pm, cnt,
                         scale_log2, s);
  } else if (dtype == PT_BF16) {
    rc = dispatch<__nv_bfloat16>(d, G, b, q, kp, vp, tb, ln, out, pa, pm,
                                 cnt, scale_log2, s);
  } else if (dtype == PT_F16) {
    rc = dispatch<__half>(d, G, b, q, kp, vp, tb, ln, out, pa, pm, cnt,
                          scale_log2, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
