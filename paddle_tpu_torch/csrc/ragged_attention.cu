// Ragged paged attention over the serving step's (B, C) spans, for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/ragged_attention.py
// (`ragged_paged_attention`, pallas_call at :137).  The contract is
// paddle_tpu/incubate/nn/functional.py `_ragged_attend_dense` over
// `_paged_gather_dense`: slot b's query row j (pool position
// starts[b] + j) attends pool positions [0, starts[b] + j] through the
// slot's block table, softmax in f32, scale 1/sqrt(D).  Rows
// j >= lens[b] are dead: the contract leaves them unspecified and this
// kernel writes zeros there.
//
// Bound on an H100: bytes.  Each live slot's K/V pages are read once per
// kv head (the q rows of all GQA groups of that head share the read) and
// the arithmetic per byte is small, so the least time is the live KV
// bytes over the memory rate.
//
// The rows of a kv head are its span rows times its GQA group (row =
// j * G + gq), so KV is never repeated across groups.  The TPU kernel's
// sequential page grid axis becomes a loop over positions inside a block,
// carrying the online-softmax state (m, l, acc) in f32.  Every block
// reads its own slot's table, start and len and stops at the last
// position its rows can see, so a table entry past the slot's last live
// page -- the out-of-range sentinel the scheduler pads with -- is never
// read; an entry is clamped into [0, NB) all the same.  -1e30 (not -inf)
// stands for a masked score, as in the TPU kernel, and a masked score's
// weight is set to exactly 0.
//
// bf16, head dim a multiple of 8 up to 256 (`tc::`): tensor cores.
// - Work unit, one block of 4 warps: (slot, kv head, row tile of 16 q
//   rows, span of positions).  The 4 warps take the 16-position chunks
//   of every stage in turn, each with its own online-softmax state.  A
//   tile with no live row does no work, so a decode slot (lens 1) costs
//   one row tile per kv head.  (Four tiles sharing a block's K/V stages,
//   a warp each, measured slower at both main shapes than one tile with
//   four warps: each warp then walks every chunk in turn.)
// - Positions come in stages of 64 on a two-stage ring of 16-byte
//   cp.async copies (the next stage is in flight while this one is
//   computed), each position's pool row found through the block table;
//   positions past the last visible one are zero-filled, not read.
// - S = Q K^T and P V run as mma.sync m16n8k16 in bf16 with f32 sums,
//   operands by ldmatrix from padded rows (no bank conflicts):
//   csrc/attn_mma.cuh's `attn::chunk`, which the paged decode kernel
//   shares.  The softmax runs in registers in the log2 domain, row maxima
//   by quad shuffles.  P is rounded to bf16 in registers before P V (l
//   sums the unrounded weights), as csrc/flash_attention.cu does; the
//   bf16 tolerance (2e-2) covers it.
// - The positions of a slot are cut into `splits` spans of `per` stages
//   (ops/cuda/ragged_plan.py chooses them from the shapes alone, never
//   from starts or lens, so a call never waits on the host).  A block
//   whose span starts past the last position its rows can see exits at
//   once.  The 4 warps of a tile are merged, then the splits, in a fixed
//   order (m = max, w = 2^(m_s - m), l = sum w l_s, acc = sum w acc_s),
//   so two calls give equal bits: a slot whose positions fit in one span
//   is finished by that block; otherwise every span writes f32 partials
//   (m, l, acc) and a combine kernel, launched as a programmatic
//   dependent launch, merges them.
// f32, and bf16 head dims the tensor-core path does not take (`simt::`):
// one block per (slot, kv head, 64-row tile), one page at a time through
// f32 shared memory, SIMT products.
#include "attn_mma.cuh"
#include "common.cuh"
#include "mlp_gemm.cuh"
#include "sm90.cuh"

#include <cstdint>

namespace {

using attn::kNegInf;

namespace simt {

constexpr int kRT = 64;        // q rows per block
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ kp,
                              const T* __restrict__ vp,
                              const int* __restrict__ tables,
                              const int* __restrict__ starts,
                              const int* __restrict__ lens,
                              T* __restrict__ out, int c, int h, int nb,
                              int page, int hkv, int d, int mb,
                              float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;                        // padded row stride
  float* qs = smem;                            // [kRT][dp]
  float* acc = qs + kRT * dp;                  // [kRT][d]
  float* ks = acc + kRT * d;                   // [page][dp]
  float* vs = ks + page * dp;                  // [page][d]
  float* ss = vs + page * d;                   // [kRT][page]
  float* m = ss + kRT * page;                  // [kRT]
  float* l = m + kRT;                          // [kRT]
  float* alpha = l + kRT;                      // [kRT]

  const int b = blockIdx.x, hk = blockIdx.y;
  const int g = h / hkv;
  const int rows = c * g;
  const int r0 = blockIdx.z * kRT;
  const int nrows = min(kRT, rows - r0);
  const int tid = threadIdx.x;
  const int start = starts[b], len = lens[b];

  // row i of this block: span index j = (r0 + i) / g, q head hk*g + gq
  auto out_at = [&](int i) {
    const int r = r0 + i, j = r / g, gq = r % g;
    return ((size_t)(b * c + j) * h + hk * g + gq) * d;
  };
  auto live = [&](int i) { return (r0 + i) / g < len; };

  for (int e = tid; e < nrows * d; e += kThreads) {
    const int i = e / d, dd = e % d;
    qs[i * dp + dd] = live(i) ? pt::to_f(q[out_at(i) + dd]) : 0.f;
    acc[i * d + dd] = 0.f;
  }
  for (int i = tid; i < nrows; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  __syncthreads();

  if (r0 / g < len) {            // this tile holds a live row
    const int last = min((start + len - 1) / page, mb - 1);
    for (int p = 0; p <= last; ++p) {
      const int blk = min(max(tables[(size_t)b * mb + p], 0), nb - 1);
      for (int e = tid; e < page * d; e += kThreads) {
        const int jj = e / d, dd = e % d;
        const size_t off = (((size_t)blk * page + jj) * hkv + hk) * d + dd;
        ks[jj * dp + dd] = pt::to_f(kp[off]);
        vs[jj * d + dd] = pt::to_f(vp[off]);
      }
      __syncthreads();
      // scores, causal against the pool position
      for (int e = tid; e < nrows * page; e += kThreads) {
        const int i = e / page, jj = e % page;
        float s = kNegInf;
        const int pos = p * page + jj;
        if (live(i) && pos <= start + (r0 + i) / g) {
          float dot = 0.f;
          for (int dd = 0; dd < d; ++dd) dot += qs[i * dp + dd] * ks[jj * dp + dd];
          s = dot * scale;
        }
        ss[i * page + jj] = s;
      }
      __syncthreads();
      // online-softmax state, one thread per row
      for (int i = tid; i < nrows; i += kThreads) {
        if (!live(i)) continue;
        const float m_prev = m[i];
        float m_cur = kNegInf;
        for (int jj = 0; jj < page; ++jj) m_cur = fmaxf(m_cur, ss[i * page + jj]);
        const float m_new = fmaxf(m_prev, m_cur);
        const float a = expf(m_prev - m_new);
        float psum = 0.f;
        for (int jj = 0; jj < page; ++jj) {
          const float pv = expf(ss[i * page + jj] - m_new);
          ss[i * page + jj] = pv;
          psum += pv;
        }
        l[i] = l[i] * a + psum;
        m[i] = m_new;
        alpha[i] = a;
      }
      __syncthreads();
      for (int e = tid; e < nrows * d; e += kThreads) {
        const int i = e / d, dd = e % d;
        if (!live(i)) continue;
        float v = acc[i * d + dd] * alpha[i];
        for (int jj = 0; jj < page; ++jj) v += ss[i * page + jj] * vs[jj * d + dd];
        acc[i * d + dd] = v;
      }
      __syncthreads();
    }
  }

  for (int e = tid; e < nrows * d; e += kThreads) {
    const int i = e / d, dd = e % d;
    const float o = live(i) ? acc[i * d + dd] / fmaxf(l[i], 1e-30f) : 0.f;
    out[out_at(i) + dd] = pt::from_f<T>(o);
  }
}

size_t smem_bytes(int page, int d) {
  const int dp = d + 1;
  return sizeof(float) * ((size_t)kRT * dp + (size_t)kRT * d +
                          (size_t)page * dp + (size_t)page * d +
                          (size_t)kRT * page + 3 * kRT);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* starts, const int* lens, void* out, int b, int c,
           int h, int nb, int page, int hkv, int d, int mb, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(page, d);
  cudaError_t e =
      pt::allow_smem_once<ragged_paged_attention_kernel<T>>(smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = c * (h / hkv);
  dim3 grid(b, hkv, (rows + kRT - 1) / kRT);
  ragged_paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, starts, lens, static_cast<T*>(out),
      c, h, nb, page, hkv, d, mb, scale);
  return 0;
}

}  // namespace simt

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStage = 64;     // positions per ring stage
constexpr int kChunk = 16;     // positions per warp product
constexpr int kTile = 16;      // q rows per row tile

// The shape of one launch, as the plan gives it.
struct Geo {
  int c, h, nb, page, hkv, d, mb, g, rows, tiles, splits, per;
};

__host__ __device__ inline Geo make_geo(int c, int h, int nb, int page,
                                        int hkv, int d, int mb, int splits,
                                        int per) {
  const int g = h / hkv, rows = c * g;
  return Geo{c, h, nb, page, hkv, d, mb, g, rows,
             (rows + kTile - 1) / kTile, splits, per};
}

// What a row tile of one slot needs: the rows [r0, r1) it holds, the
// first `end` positions its live rows can see, and how many splits hold
// some of them (0: no live row).
struct Span {
  int r0, r1, end, nlive;
};

__device__ __forceinline__ Span span_of(const Geo& G, int tile, int start,
                                        int len) {
  Span s;
  s.r0 = tile * kTile;
  s.r1 = min(G.rows, s.r0 + kTile);
  s.end = 0;
  s.nlive = 0;
  if (len > 0 && s.r0 / G.g < len) {
    const int jmax = min(len - 1, (s.r1 - 1) / G.g);
    s.end = min(start + jmax + 1, G.mb * G.page);
    const int stages = (s.end + kStage - 1) / kStage;
    s.nlive = (stages + G.per - 1) / G.per;
  }
  return s;
}

template <int DP>
__host__ __device__ constexpr int ld() {    // padded row, elements
  return DP + 8;
}

template <int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  // the q tile, then the ring (2 stages of K and V); the epilogue reuses
  // the ring for each warp's (acc, m, l)
  return (size_t)kTile * ld<DP>() * 2 + 2 * 2 * kStage * ld<DP>() * 2;
}

// out row R (a row of kv head hk: j * G + gq) of slot b, element 0
__device__ __forceinline__ size_t out_row(const Geo& G, int b, int hk,
                                          int R) {
  const int j = R / G.g, gq = R % G.g;
  return ((size_t)(b * G.c + j) * G.h + hk * G.g + gq) * G.d;
}

using attn::store8;

template <int DP>
__global__ void __launch_bounds__(kThreads)
ragged_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                 const bf16* __restrict__ vp, const int* __restrict__ tables,
                 const int* __restrict__ starts,
                 const int* __restrict__ lens, bf16* __restrict__ out,
                 float* __restrict__ pacc, float* __restrict__ pml, Geo G,
                 float scale_log2) {
  constexpr int LD = ld<DP>();
  constexpr int CH = DP / 8;                 // 16-byte chunks of a row
  sm90::launch_dependents();                 // the combine may launch
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);            // [16][LD]
  bf16* ring = qs + kTile * LD;                        // [2][K, V][64][LD]

  const int tile = blockIdx.x % G.tiles, split = blockIdx.x / G.tiles;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int start = starts[b], len = lens[b];
  const Span sp = span_of(G, tile, start, len);
  const int nrow = sp.r1 - sp.r0;

  if (sp.nlive == 0) {           // no live row: split 0 writes the zeros
    if (split == 0) {
      const float z[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int e = tid; e < nrow * (G.d / 8); e += kThreads) {
        const int r = e / (G.d / 8), ch = e % (G.d / 8);
        store8(out + out_row(G, b, hk, sp.r0 + r) + ch * 8, z);
      }
    }
    return;
  }
  if (split >= sp.nlive) return;             // past the visible positions
  const int s_lo = split * G.per;
  const int s_hi = min((sp.end + kStage - 1) / kStage, s_lo + G.per);

  // the tile's q rows, zero-filled past the rows, dead rows and head dim
  for (int e = tid; e < kTile * CH; e += kThreads) {
    const int r = e / CH, ch = e % CH, R = sp.r0 + r;
    const bool ok = R < sp.r1 && R / G.g < len && ch * 8 < G.d;
    sm90::cp_async16(sm90::smem_addr(qs + r * LD + ch * 8),
                     ok ? q + out_row(G, b, hk, R) + ch * 8 : q, ok ? 16 : 0);
  }
  auto load_stage = [&](int st, int buf) {
    bf16* ks = ring + buf * 2 * kStage * LD;
    bf16* vs = ks + kStage * LD;
    for (int e = tid; e < kStage * CH; e += kThreads) {
      const int i = e / CH, ch = e % CH, pos = st * kStage + i;
      const bool ok = pos < sp.end && ch * 8 < G.d;
      size_t off = 0;
      if (ok) {
        const int blk =
            min(max(tables[(size_t)b * G.mb + pos / G.page], 0), G.nb - 1);
        off = (((size_t)blk * G.page + pos % G.page) * G.hkv + hk) * G.d +
              ch * 8;
      }
      sm90::cp_async16(sm90::smem_addr(ks + i * LD + ch * 8), kp + off,
                       ok ? 16 : 0);
      sm90::cp_async16(sm90::smem_addr(vs + i * LD + ch * 8), vp + off,
                       ok ? 16 : 0);
    }
  };

  // this warp: chunks warp, warp + 4, ... of every stage
  const int gi = lane / 4, ci = lane % 4;
  int lim[2];                    // last visible position of rows g, g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = sp.r0 + gi + 8 * i;
    lim[i] = (R < sp.r1 && R / G.g < len) ? start + R / G.g : -1;
  }
  const int tlim = sp.end - 1;   // the last position any row can see
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const uint32_t q_lane = attn::q_lane<LD>(qs, lane);

  load_stage(s_lo, 0);
  sm90::cp_async_commit();
  for (int st = s_lo; st < s_hi; ++st) {
    const int buf = (st - s_lo) & 1;
    if (st + 1 < s_hi) load_stage(st + 1, buf ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = ring + buf * 2 * kStage * LD;
    const bf16* vs = ks + kStage * LD;
    for (int ch = warp; ch < kStage / kChunk; ch += kWarps) {
      const int p0 = st * kStage + ch * kChunk;
      if (p0 > tlim) break;                  // past every row's last position
      attn::chunk<bf16, DP, LD>(acc, m_run, l_run, q_lane,
                                ks + ch * kChunk * LD, vs + ch * kChunk * LD,
                                lane, G.d, p0, lim, scale_log2);
    }
    __syncthreads();             // the stage's buffer may be refilled
  }
  sm90::cp_async_wait<0>();

  // each warp's state into the ring: acc [warp][16][DP], then m, l
  float* red = reinterpret_cast<float*>(ring);
  float* mred = red + kWarps * kTile * DP;
  float* lred = mred + kWarps * kTile;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(
          red + (warp * kTile + gi + 8 * i) * DP + 8 * n + 2 * ci) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  if (ci == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mred[warp * kTile + gi + 8 * i] = m_run[i];
      lred[warp * kTile + gi + 8 * i] = l_run[i];
    }
  __syncthreads();

  // merge the warps in order; finish the rows or write the split's
  // partials
  const bool final_out = sp.nlive == 1;
  const size_t prow = ((size_t)(b * G.hkv + hk) * G.splits + split) *
                      G.tiles * kTile;
  for (int e = tid; e < nrow * (G.d / 8); e += kThreads) {
    const int r = e / (G.d / 8), ch = e % (G.d / 8);
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, mred[w * kTile + r]);
    float ll = 0.f, v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < kWarps; ++w) {
      const int row = w * kTile + r;
      const float wt = exp2f(mred[row] - mm);
      ll += wt * lred[row];
      const float4 x0 = *reinterpret_cast<const float4*>(red + row * DP + ch * 8);
      const float4 x1 =
          *reinterpret_cast<const float4*>(red + row * DP + ch * 8 + 4);
      v[0] += wt * x0.x; v[1] += wt * x0.y; v[2] += wt * x0.z; v[3] += wt * x0.w;
      v[4] += wt * x1.x; v[5] += wt * x1.y; v[6] += wt * x1.z; v[7] += wt * x1.w;
    }
    const int R = sp.r0 + r;
    if (final_out) {
      const float inv = ll > 0.f ? 1.f / ll : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= inv;
      store8(out + out_row(G, b, hk, R) + ch * 8, v);
    } else {
      float* dst = pacc + (prow + R) * G.d + ch * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
      if (ch == 0) {
        pml[2 * (prow + R)] = mm;
        pml[2 * (prow + R) + 1] = ll;
      }
    }
  }
}

// Merges the splits' partials of every row tile that has more than one,
// in split order, and writes its rows.
__global__ void __launch_bounds__(kThreads)
ragged_combine_kernel(const float* __restrict__ pacc,
                      const float* __restrict__ pml,
                      const int* __restrict__ starts,
                      const int* __restrict__ lens, bf16* __restrict__ out,
                      Geo G) {
  // every block waits, so the launch ends after the attention kernel
  sm90::grid_dependency_wait();
  const int hk = blockIdx.y, b = blockIdx.z;
  const Span sp = span_of(G, blockIdx.x, starts[b], lens[b]);
  if (sp.nlive <= 1) return;
  const size_t pitch = (size_t)G.tiles * kTile;   // rows per split
  const size_t base = (size_t)(b * G.hkv + hk) * G.splits * pitch;
  for (int e = threadIdx.x; e < (sp.r1 - sp.r0) * (G.d / 8); e += kThreads) {
    const int R = sp.r0 + e / (G.d / 8), ch = e % (G.d / 8);
    float mm = kNegInf;
    for (int s = 0; s < sp.nlive; ++s)
      mm = fmaxf(mm, pml[2 * (base + s * pitch + R)]);
    float ll = 0.f, v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < sp.nlive; ++s) {
      const size_t row = base + s * pitch + R;
      const float wt = exp2f(pml[2 * row] - mm);
      ll += wt * pml[2 * row + 1];
      const float4 x0 = *reinterpret_cast<const float4*>(pacc + row * G.d + ch * 8);
      const float4 x1 =
          *reinterpret_cast<const float4*>(pacc + row * G.d + ch * 8 + 4);
      v[0] += wt * x0.x; v[1] += wt * x0.y; v[2] += wt * x0.z; v[3] += wt * x0.w;
      v[4] += wt * x1.x; v[5] += wt * x1.y; v[6] += wt * x1.z; v[7] += wt * x1.w;
    }
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] *= inv;
    store8(out + out_row(G, b, hk, R) + ch * 8, v);
  }
}

template <int DP>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* starts, const int* lens, void* out, float* pacc,
           float* pml, int b, const Geo& G, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t e = pt::allow_smem_once<ragged_tc_kernel<DP>>(smem);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = scale * 1.4426950408889634f;
  ragged_tc_kernel<DP><<<dim3(G.tiles * G.splits, G.hkv, b), kThreads, smem,
                         stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), tables, starts, lens,
      static_cast<bf16*>(out), pacc, pml, G, scale_log2);
  if (G.splits == 1) return 0;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)mlp::launch_dependent(ragged_combine_kernel,
                                    dim3(G.tiles, G.hkv, b), kThreads, 0,
                                    stream, pacc, pml, starts, lens,
                                    static_cast<bf16*>(out), G);
}

// The plan's checks (ops/cuda/ragged_plan.py `check_plan`).
bool plan_ok(const Geo& G) {
  const int stages = (G.mb * G.page + kStage - 1) / kStage;
  return G.splits >= 1 && G.per >= 1 && (G.splits - 1) * G.per < stages &&
         G.splits * G.per >= stages && G.hkv <= 65535;
}

}  // namespace tc

// Whether (dtype, d) runs on the tensor cores.
bool tensor_core_path(int dtype, int d) {
  return dtype == PT_BF16 && d % 8 == 0 && d >= 8 && d <= 256;
}

}  // namespace

// q (b, c, h, d); pools (nb, page, hkv, d); tables (b, mb) int32;
// starts/lens (b,) int32 -> out (b, c, h, d).  h % hkv == 0.  bf16 with
// d % 8 == 0, d <= 256 takes the plan (`splits` spans of `per`
// 64-position stages) and, where splits > 1, the f32 partials pacc (b,
// hkv, splits, tiles * 16, d) and pml (the same rows, (m, l) each); other
// shapes ignore them.
extern "C" int pt_ragged_paged_attention(
    const void* q, const void* kp, const void* vp, const void* tables,
    const void* starts, const void* lens, void* out, void* pacc, void* pml,
    int b, int c, int h, int nb, int page, int hkv, int d, int mb,
    int splits, int per, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* st = static_cast<const int*>(starts);
  const int* ln = static_cast<const int*>(lens);
  int rc;
  if (tensor_core_path(dtype, d)) {
    const tc::Geo G = tc::make_geo(c, h, nb, page, hkv, d, mb, splits, per);
    float* pa = static_cast<float*>(pacc);
    float* pm = static_cast<float*>(pml);
    if (!tc::plan_ok(G) || (splits > 1 && (!pa || !pm)) || b > 65535) {
      rc = (int)cudaErrorInvalidValue;
    } else if (d <= 64) {
      rc = tc::launch<64>(q, kp, vp, tb, st, ln, out, pa, pm, b, G, scale, s);
    } else if (d <= 128) {
      rc = tc::launch<128>(q, kp, vp, tb, st, ln, out, pa, pm, b, G, scale,
                           s);
    } else {
      rc = tc::launch<256>(q, kp, vp, tb, st, ln, out, pa, pm, b, G, scale,
                           s);
    }
  } else if (dtype == PT_F32) {
    rc = simt::launch<float>(q, kp, vp, tb, st, ln, out, b, c, h, nb, page,
                             hkv, d, mb, scale, s);
  } else if (dtype == PT_BF16) {
    rc = simt::launch<__nv_bfloat16>(q, kp, vp, tb, st, ln, out, b, c, h, nb,
                                     page, hkv, d, mb, scale, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
