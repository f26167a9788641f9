// Decode megakernel: one decoder layer's whole ragged attention block --
// RMSNorm -> Q/K/V -> rotate-half RoPE -> attention over the paged prefix
// and the span's own keys -> O-projection + residual -- in ONE launch,
// for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/mega_decode.py
// (`mega_decode`, pallas_call at :261).  The numerical contract is
// paddle_tpu/incubate/nn/functional.py `_mega_decode_layer_ref`: the
// fused QKV entry, the span write, ragged paged attention, the O
// projection accumulated in f32 and rounded to the storage type, then
// the residual add in the storage type.  The kernel returns the span's
// roped k and its v; the caller writes them into the pools with the one
// shared `_paged_span_write`, so the kernel never writes a pool.
//
// Bound on an H100: at the serving step (T = B*C = 128 token rows) the
// layer's four weight matrices are read once (134 MB at llama2-7b in
// bf16) and the products are ~64 operations per weight byte, below the
// card's ~295, so the weight read bounds it, plus the live prefix pages.
//
// Design.  The TPU grid (slot, page) keeps all four weights of a slot in
// VMEM; at 7B widths that is 128 MB per slot, so the card gets a new
// design: a cooperative launch of as many 256-thread blocks as are
// co-resident (two per SM), walking phases of work items separated by
// grid barriers (cooperative_groups::this_grid().sync(), which orders the
// global writes of one phase before the reads of the next).  bf16:
//  0. Norm: one item per token row writes nx = round(norm(x) * g) into a
//     (T, H) scratch (qkv_gemm.cuh `norm_row`, the fused QKV kernel's
//     norm).
//  1. Q/K/V: items of 128 token rows by 128 columns of [q | k | v] and a
//     contraction range, on mlp_gemm.cuh's `gemm_tiles` (wgmma from a
//     3-stage cp.async ring; qkv_gemm.cuh `gemm_tile`, the fused QKV
//     kernel's device code).  The tiles are fewer than the blocks (96 at
//     llama2-7b, 80 at 70b GQA), so the contraction is split as the
//     fused kernel splits it (ops/cuda/mega_plan.py: qkv_plan's rule) into
//     f32 partials, and a sum phase after a barrier adds them in split
//     order, rounds, applies RoPE and rounds again (`sum_pair`); with one
//     split RoPE runs on the accumulator in registers.  A head dim of 256
//     always takes the partial path (its halves lie in two tiles).  q
//     goes to a scratch buffer, span k and v to the two outputs.
//  2. Attention, one item per (slot, kv head, tile of up to 64 q rows):
//     the rows of a kv head are its span rows times its GQA group (row =
//     j * G + gq), so KV is read once per kv head.  An online softmax
//     (m, l, acc in f32 shared memory) runs first over the slot's cached
//     prefix only -- pool positions < starts[b], pages read through the
//     block table, which is never read past the last prefix page -- then
//     over the span's own k/v from phase 1, causal within the span (row
//     j sees span columns <= j).  Dead rows (j >= lens[b]) and idle slots
//     are skipped and write zeros, so the O projection gives them x
//     itself: bounded, and never read.  -1e30 masks a score.
//  3. O projection: items of 128 token rows by 128 columns of H and a
//     contraction range over Nq, on `gemm_tiles`, split so the items fill
//     the grid (32 tiles at llama2-7b); each writes its f32 sum to a
//     partial.
//  4. Sum and residual: the partials added in split order, rounded, x
//     added, rounded to the storage type; 8 columns a thread.
// f32 keeps three phases on the SIMT units (full f32 products): Q/K/V
// tiles of 64 token rows by one head (norm_qkv_tile.cuh `qkv_tile`), the
// same attention, and O-projection tiles of 64 x 64 with the residual in
// their epilogue.  Scratch rows written by another block in the same
// launch are read through L2 only: `__ldcg`, or the 16-byte cp.async.cg
// of `gemm_tiles`.
//
// What bounds it now (PERF.md sections 6 and 7): the attention phase, f32
// on the SIMT units with one thread per row for the softmax, takes about
// two thirds of the bf16 kernel at llama2-7b and four fifths at 70b GQA
// (whose 8 x 8 kv heads give 128 items for 264 blocks); the Q/K/V phase
// most of the rest.
#include "norm_qkv_tile.cuh"
#include "qkv_gemm.cuh"

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using pt_tile::kBT;

constexpr int kThreads = 256;
static_assert(pt_tile::kThreads == kThreads && mlp::kThreads == kThreads,
              "one block size for every phase");
constexpr int kRT = 64;        // attention q rows per work item, at most
constexpr int kBN = 64;        // f32 O-projection columns per tile
constexpr int kGN = 128;       // bf16 GEMM tile columns (Q/K/V and O)
constexpr float kNegInf = -1e30f;

template <typename T>
struct Params {
  const T* x;        // (t, h) layer input, the residual stream
  const T* g;        // (h,) input-norm weight
  const T* wq;       // (h, nq)
  const T* wk;       // (h, nk)
  const T* wv;       // (h, nk)
  const T* wo;       // (nq, h)
  const T* cos;      // (t, d)
  const T* sin;      // (t, d)
  const T* kp;       // (nb, page, hkv, d)
  const T* vp;
  const int* tables;  // (b, mb)
  const int* starts;  // (b,)
  const int* lens;    // (b,)
  T* out;            // (t, h)
  T* span_k;         // (t, nk)
  T* span_v;         // (t, nk)
  T* q_scr;          // (t, nq)
  T* att_scr;        // (t, nq)
  T* nx;             // (t, h) normed x (bf16 only)
  float* partial;    // f32 split partials (bf16 only)
  int b, c, h, nq, nk, nb, page, hkv, d, mb;
  int qkv_splits, o_splits;   // contraction splits (bf16 only)
  float eps, scale;
};

// q rows of one attention item: min(kRT, C * G)
__host__ __device__ inline int attn_rows(int c, int g) {
  return c * g < kRT ? c * g : kRT;
}

__host__ __device__ inline size_t attn_smem_bytes(int rt, int page, int d) {
  const int dp = d + 1;
  return sizeof(float) * ((size_t)rt * dp + (size_t)rt * d +
                          (size_t)page * dp + (size_t)page * d +
                          (size_t)rt * page + 3 * (size_t)rt);
}

// Dynamic shared memory of a block: the largest phase's (bf16: the
// gemm_tiles ring or, past its 1024-byte alignment, the attention tiles)
template <typename T, int HD>
size_t smem_total(int c, int g, int page, int d) {
  const size_t a = attn_smem_bytes(attn_rows(c, g), page, d);
  size_t s;
  if constexpr (sizeof(T) == 2) {
    s = mlp::smem_bytes<1, kGN>();
    if (1024 + a > s) s = 1024 + a;
  } else {
    s = pt_tile::smem_bytes<T, HD>();
    const size_t o = pt_tile::smem_bytes<T, kBN>();
    if (o > s) s = o;
    if (a > s) s = a;
  }
  return s;
}

// One online-softmax step over `cols` key columns staged in ks/vs: the
// scores of the live rows (vis(i, jj) says which columns a row sees),
// then m, l and acc rescaled and accumulated, one thread per row for the
// softmax state.
template <typename Live, typename Vis>
__device__ void online_step(const float* qs, float* acc, const float* ks,
                            const float* vs, float* ss, float* m, float* l,
                            float* alpha, int nrows, int cols, int d,
                            float scale, Live live, Vis vis) {
  const int dp = d + 1, tid = threadIdx.x;
  for (int e = tid; e < nrows * cols; e += kThreads) {
    const int i = e / cols, jj = e % cols;
    float s = kNegInf;
    if (live(i) && vis(i, jj)) {
      float dot = 0.f;
      for (int dd = 0; dd < d; ++dd) dot += qs[i * dp + dd] * ks[jj * dp + dd];
      s = dot * scale;
    }
    ss[i * cols + jj] = s;
  }
  __syncthreads();
  for (int i = tid; i < nrows; i += kThreads) {
    if (!live(i)) continue;
    const float m_prev = m[i];
    float m_cur = kNegInf;
    for (int jj = 0; jj < cols; ++jj) m_cur = fmaxf(m_cur, ss[i * cols + jj]);
    const float m_new = fmaxf(m_prev, m_cur);
    const float a = expf(m_prev - m_new);
    float psum = 0.f;
    for (int jj = 0; jj < cols; ++jj) {
      const float pv = expf(ss[i * cols + jj] - m_new);
      ss[i * cols + jj] = pv;
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
    for (int jj = 0; jj < cols; ++jj) v += ss[i * cols + jj] * vs[jj * d + dd];
    acc[i * d + dd] = v;
  }
  __syncthreads();
}

// Phase 2, one item: slot b, kv head hk, q-row tile z.
template <typename T>
__device__ void attend_item(const Params<T>& p, int item, float* smem) {
  const int d = p.d, dp = d + 1, page = p.page, c = p.c;
  const int g = (p.nq / d) / p.hkv;
  const int rows = c * g, rt = attn_rows(c, g);
  const int ntile = (rows + rt - 1) / rt;
  const int z = item % ntile;
  const int hk = (item / ntile) % p.hkv;
  const int b = item / (ntile * p.hkv);
  float* qs = smem;                            // [rt][dp]
  float* acc = qs + rt * dp;                   // [rt][d]
  float* ks = acc + rt * d;                    // [page][dp]
  float* vs = ks + page * dp;                  // [page][d]
  float* ss = vs + page * d;                   // [rt][page]
  float* m = ss + rt * page;                   // [rt]
  float* l = m + rt;                           // [rt]
  float* alpha = l + rt;                       // [rt]

  const int r0 = z * rt;
  const int nrows = min(rt, rows - r0);
  const int tid = threadIdx.x;
  const int start = p.starts[b], len = p.lens[b];
  // row i: span index j = (r0 + i) / g, q head hk * g + (r0 + i) % g
  auto span_j = [&](int i) { return (r0 + i) / g; };
  auto q_at = [&](int i) {
    const int r = r0 + i;
    return (size_t)(b * c + r / g) * p.nq + (size_t)(hk * g + r % g) * d;
  };
  auto live = [&](int i) { return span_j(i) < len; };

  for (int e = tid; e < nrows * d; e += kThreads) {
    const int i = e / d, dd = e % d;
    qs[i * dp + dd] = live(i) ? pt::to_f(__ldcg(p.q_scr + q_at(i) + dd))
                              : 0.f;
    acc[i * d + dd] = 0.f;
  }
  for (int i = tid; i < nrows; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  __syncthreads();

  if (span_j(0) < len) {         // this tile holds a live row
    // the cached prefix: pool positions [0, start), every live row
    // sees all of it
    if (start > 0) {
      const int last = min((start - 1) / page, p.mb - 1);
      for (int pg = 0; pg <= last; ++pg) {
        const int blk = min(max(p.tables[(size_t)b * p.mb + pg], 0), p.nb - 1);
        for (int e = tid; e < page * d; e += kThreads) {
          const int jj = e / d, dd = e % d;
          const size_t off =
              (((size_t)blk * page + jj) * p.hkv + hk) * d + dd;
          ks[jj * dp + dd] = pt::to_f(p.kp[off]);
          vs[jj * d + dd] = pt::to_f(p.vp[off]);
        }
        __syncthreads();
        const int pos0 = pg * page;
        online_step(qs, acc, ks, vs, ss, m, l, alpha, nrows, page, d,
                    p.scale, live,
                    [&](int, int jj) { return pos0 + jj < start; });
      }
    }
    // the span's own keys, causal within the span; columns >= len are
    // seen by no live row
    const int span_end = min(c, len);
    for (int j0 = 0; j0 < span_end; j0 += page) {
      const int cols = min(page, span_end - j0);
      for (int e = tid; e < cols * d; e += kThreads) {
        const int jj = e / d, dd = e % d;
        const size_t off = (size_t)(b * c + j0 + jj) * p.nk + hk * d + dd;
        ks[jj * dp + dd] = pt::to_f(__ldcg(p.span_k + off));
        vs[jj * d + dd] = pt::to_f(__ldcg(p.span_v + off));
      }
      __syncthreads();
      online_step(qs, acc, ks, vs, ss, m, l, alpha, nrows, cols, d,
                  p.scale, live,
                  [&](int i, int jj) { return j0 + jj <= span_j(i); });
    }
  }

  for (int e = tid; e < nrows * d; e += kThreads) {
    const int i = e / d, dd = e % d;
    const float o = live(i) ? acc[i * d + dd] / fmaxf(l[i], 1e-30f) : 0.f;
    p.att_scr[q_at(i) + dd] = pt::from_f<T>(o);
  }
  __syncthreads();
}

// f32 phase 3, one item: token rows [t0, t0 + kBT), columns [col0,
// col0 + kBN), x added in the epilogue.
__device__ void oproj_item(const Params<float>& p, int t, int t0, int col0,
                           unsigned char* smem) {
  unsigned char* stage = smem + kBT * sizeof(float);
  float* cs = reinterpret_cast<float*>(stage);
  pt_tile::mainloop_simt<kBN, false>(p.att_scr, nullptr, p.wo, p.h, col0, t,
                                     p.nq, t0, nullptr, stage, cs);
  __syncthreads();
  for (int e = threadIdx.x; e < kBT * kBN; e += kThreads) {
    const int r = e / kBN, cc = e % kBN;
    const int row = t0 + r;
    if (row >= t) continue;
    const size_t off = (size_t)row * p.h + col0 + cc;
    p.out[off] = p.x[off] + cs[r * pt_tile::kLdc<kBN> + cc];
  }
  __syncthreads();
}

template <int HD>
__global__ void __launch_bounds__(kThreads) mega32_kernel(Params<float> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int t = p.b * p.c;
  const int nrt = (t + kBT - 1) / kBT;

  const int n1 = nrt * (p.nq / HD + 2 * (p.nk / HD));
  for (int it = blockIdx.x; it < n1; it += gridDim.x) {
    pt_tile::qkv_tile<float, HD>(p.x, p.g, p.wq, p.wk, p.wv, p.cos, p.sin,
                                 p.q_scr, p.span_k, p.span_v, t, p.h, p.nq,
                                 p.nk, p.eps, (it % nrt) * kBT, it / nrt,
                                 smem);
    __syncthreads();
  }
  grid.sync();

  const int g = (p.nq / p.d) / p.hkv;
  const int rt = attn_rows(p.c, g);
  const int n2 = p.b * p.hkv * ((p.c * g + rt - 1) / rt);
  for (int it = blockIdx.x; it < n2; it += gridDim.x)
    attend_item<float>(p, it, reinterpret_cast<float*>(smem));
  grid.sync();

  const int ncol = p.h / kBN;
  const int n3 = nrt * ncol;
  for (int it = blockIdx.x; it < n3; it += gridDim.x)
    oproj_item(p, t, (it / ncol) * kBT, (it % ncol) * kBN, smem);
}

// bf16: the five phases of the source note.  Two blocks per SM: the
// registers stay within 128 a thread.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2) mega16_kernel(Params<bf16> p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float warp_sums[kThreads / 32];
  unsigned char* sm = mlp::align1024(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int t = p.b * p.c, nrt = (t + mlp::kBM - 1) / mlp::kBM;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x,
               nthreads = (size_t)gridDim.x * kThreads;

  // 0. nx, one row an item
  for (int r = blockIdx.x; r < t; r += gridDim.x) {
    qkv::norm_row<kThreads>(p.x, p.g, p.nx, p.h, p.eps, r, warp_sums);
    __syncthreads();
  }
  grid.sync();

  // 1. Q/K/V tiles by split: item = (split, column tile, row tile)
  const int ct = (p.nq + kGN - 1) / kGN + 2 * ((p.nk + kGN - 1) / kGN);
  const int steps1 = p.h / mlp::kBK;
  const int kps1 = (steps1 + p.qkv_splits - 1) / p.qkv_splits;
  const bool qpart = p.qkv_splits > 1 || HD > qkv::kBN;
  const int n1 = nrt * ct * p.qkv_splits;
  for (int it = blockIdx.x; it < n1; it += gridDim.x) {
    const int z = it / (nrt * ct), rem = it % (nrt * ct);
    qkv::gemm_tile<HD, false>(sm, p.nx, p.wq, p.wk, p.wv, p.cos, p.sin,
                              p.q_scr, p.span_k, p.span_v, p.partial, t,
                              p.h, p.nq, p.nk, (rem % nrt) * mlp::kBM,
                              rem / nrt, z * kps1,
                              min(steps1, (z + 1) * kps1), z, qpart);
    __syncthreads();
  }
  grid.sync();
  if (qpart) {   // 1b. the partials in split order, round, RoPE, round
    const size_t pairs = (size_t)t * ((p.nq + 2 * p.nk) / 2);
    for (size_t i = tid; i < pairs; i += nthreads)
      qkv::sum_pair<HD>(p.partial, p.cos, p.sin, p.q_scr, p.span_k,
                        p.span_v, t, p.nq, p.nk, p.qkv_splits, i);
    grid.sync();
  }

  // 2. attention
  const int g = (p.nq / p.d) / p.hkv;
  const int rt = attn_rows(p.c, g);
  const int n2 = p.b * p.hkv * ((p.c * g + rt - 1) / rt);
  for (int it = blockIdx.x; it < n2; it += gridDim.x)
    attend_item<bf16>(p, it, reinterpret_cast<float*>(sm));
  grid.sync();

  // 3. O projection by split into f32 partials
  const int ot = (p.h + kGN - 1) / kGN, steps3 = p.nq / mlp::kBK;
  const int kps3 = (steps3 + p.o_splits - 1) / p.o_splits;
  const int n3 = nrt * ot * p.o_splits;
  for (int it = blockIdx.x; it < n3; it += gridDim.x) {
    const int z = it / (nrt * ot), rem = it % (nrt * ot);
    const int m0 = (rem % nrt) * mlp::kBM, n0 = (rem / nrt) * kGN;
    const int ncols = min(kGN, p.h - n0);
    float acc[1][kGN / 2];
#pragma unroll
    for (int i = 0; i < kGN / 2; ++i) acc[0][i] = 0.f;
    const bf16* const ws[1] = {p.wo};
    mlp::gemm_tiles<1, kGN, false, true>(sm, p.att_scr, p.nq, t, m0, ws,
                                         p.h, n0, z * kps3,
                                         min(steps3, (z + 1) * kps3), acc,
                                         p.nq, ncols);
    float* dst = p.partial + (size_t)z * t * p.h + n0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + mlp::acc_row(i);
      if (r >= t) continue;
#pragma unroll
      for (int j = 0; j < kGN / 8; ++j) {
        const int c = mlp::acc_col(j, 0);
        if (c < ncols)
          *reinterpret_cast<float2*>(dst + (size_t)r * p.h + c) =
              make_float2(acc[0][4 * j + 2 * i], acc[0][4 * j + 2 * i + 1]);
      }
    }
    __syncthreads();
  }
  grid.sync();

  // 4. out = round(x + round(sum of the partials in split order))
  const size_t plane = (size_t)t * p.h, groups = plane / 8;
  for (size_t i = tid; i < groups; i += nthreads) {
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int z = 0; z < p.o_splits; ++z) {
      const float4* src =
          reinterpret_cast<const float4*>(p.partial + z * plane + 8 * i);
      const float4 a = __ldcg(src), b = __ldcg(src + 1);
      s[0] += a.x; s[1] += a.y; s[2] += a.z; s[3] += a.w;
      s[4] += b.x; s[5] += b.y; s[6] += b.z; s[7] += b.w;
    }
    const uint4 xv = *reinterpret_cast<const uint4*>(p.x + 8 * i);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    uint32_t o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      o[q] = sm90::pack2<bf16>(
          pt::to_f(xe[2 * q]) + pt::round_to<bf16>(s[2 * q]),
          pt::to_f(xe[2 * q + 1]) + pt::round_to<bf16>(s[2 * q + 1]));
    *reinterpret_cast<uint4*>(p.out + 8 * i) = make_uint4(o[0], o[1], o[2],
                                                         o[3]);
  }
}

template <typename T>
using KernelFn = void (*)(Params<T>);

// The kernel of a dtype and head dim.
template <typename T, int HD>
KernelFn<T> kernel_of() {
  if constexpr (sizeof(T) == 2)
    return mega16_kernel<HD>;
  else
    return mega32_kernel<HD>;
}

// The most work items of any phase (elementwise phases count 256-thread
// items).
template <typename T, int HD>
int work_items(const Params<T>& p) {
  const int t = p.b * p.c;
  const int g = (p.nq / p.d) / p.hkv, rt = attn_rows(p.c, g);
  const int n2 = p.b * p.hkv * ((p.c * g + rt - 1) / rt);
  int most = n2;
  auto take = [&](long long n) { if (n > most) most = (int)n; };
  if constexpr (sizeof(T) == 2) {
    const int nrt = (t + mlp::kBM - 1) / mlp::kBM;
    const int ct = (p.nq + kGN - 1) / kGN + 2 * ((p.nk + kGN - 1) / kGN);
    take(t);
    take((long long)nrt * ct * p.qkv_splits);
    take(((long long)t * ((p.nq + 2 * p.nk) / 2) + kThreads - 1) / kThreads);
    take((long long)nrt * ((p.h + kGN - 1) / kGN) * p.o_splits);
    take(((long long)t * p.h / 8 + kThreads - 1) / kThreads);
  } else {
    const int nrt = (t + kBT - 1) / kBT;
    take((long long)nrt * (p.nq / HD + 2 * (p.nk / HD)));
    take((long long)nrt * (p.h / kBN));
  }
  return most;
}

// The co-resident grid for this geometry (0: none fits), and its
// shared memory.
template <typename T, int HD>
int grid_for(const Params<T>& p, size_t* smem_out) {
  const size_t smem = smem_total<T, HD>(p.c, (p.nq / p.d) / p.hkv, p.page,
                                        p.d);
  *smem_out = smem;
  if (cudaFuncSetAttribute(kernel_of<T, HD>(),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel_of<T, HD>(), kThreads, smem) != cudaSuccess)
    return 0;
  const int resident = per_sm * sms;
  const int work = work_items<T, HD>(p);
  return resident < work ? resident : work;
}

// Contraction splits of `steps` 64-deep steps that the kernel can run:
// none left empty.
inline bool splits_ok(int steps, int splits) {
  if (splits < 1 || steps < 1) return false;
  const int per = (steps + splits - 1) / splits;
  return (splits - 1) * per < steps;
}

template <typename T, int HD>
int launch(Params<T> p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (p.nx == nullptr || p.partial == nullptr ||
        !splits_ok(p.h / mlp::kBK, p.qkv_splits) ||
        !splits_ok(p.nq / mlp::kBK, p.o_splits))
      return (int)cudaErrorInvalidValue;
  } else {
    if (p.qkv_splits != 1 || p.o_splits != 1)
      return (int)cudaErrorInvalidValue;
  }
  size_t smem = 0;
  const int grid = grid_for<T, HD>(p, &smem);
  if (grid < 1) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorCooperativeLaunchTooLarge);
  }
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel_of<T, HD>()), dim3(grid),
      dim3(kThreads), args, smem, stream);
}

template <typename T>
Params<T> make_params(const void* x, const void* g, const void* wq,
                      const void* wk, const void* wv, const void* wo,
                      const void* cos, const void* sin, const void* kp,
                      const void* vp, const void* tables, const void* starts,
                      const void* lens, void* out, void* span_k, void* span_v,
                      void* q_scr, void* att_scr, void* nx, void* partial,
                      int b, int c, int h, int nq, int nk, int nb, int page,
                      int hkv, int d, int mb, int qkv_splits, int o_splits,
                      float eps, float scale) {
  Params<T> p;
  p.x = static_cast<const T*>(x);
  p.g = static_cast<const T*>(g);
  p.wq = static_cast<const T*>(wq);
  p.wk = static_cast<const T*>(wk);
  p.wv = static_cast<const T*>(wv);
  p.wo = static_cast<const T*>(wo);
  p.cos = static_cast<const T*>(cos);
  p.sin = static_cast<const T*>(sin);
  p.kp = static_cast<const T*>(kp);
  p.vp = static_cast<const T*>(vp);
  p.tables = static_cast<const int*>(tables);
  p.starts = static_cast<const int*>(starts);
  p.lens = static_cast<const int*>(lens);
  p.out = static_cast<T*>(out);
  p.span_k = static_cast<T*>(span_k);
  p.span_v = static_cast<T*>(span_v);
  p.q_scr = static_cast<T*>(q_scr);
  p.att_scr = static_cast<T*>(att_scr);
  p.nx = static_cast<T*>(nx);
  p.partial = static_cast<float*>(partial);
  p.b = b; p.c = c; p.h = h; p.nq = nq; p.nk = nk; p.nb = nb;
  p.page = page; p.hkv = hkv; p.d = d; p.mb = mb;
  p.qkv_splits = qkv_splits; p.o_splits = o_splits;
  p.eps = eps; p.scale = scale;
  return p;
}

template <typename T>
int dispatch(const Params<T>& p, cudaStream_t s, bool grid_only,
             int* grid_out) {
  size_t smem = 0;
  switch (p.d) {
    case 64:
      if (grid_only) { *grid_out = grid_for<T, 64>(p, &smem); return 0; }
      return launch<T, 64>(p, s);
    case 128:
      if (grid_only) { *grid_out = grid_for<T, 128>(p, &smem); return 0; }
      return launch<T, 128>(p, s);
    case 256:
      if (grid_only) { *grid_out = grid_for<T, 256>(p, &smem); return 0; }
      return launch<T, 256>(p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (b*c, h); g (h,); wq (h, nq); wk/wv (h, nk); wo (nq, h); cos/sin
// (b*c, d); pools (nb, page, hkv, d); tables (b, mb), starts/lens (b,)
// int32 -> out (b*c, h), span_k/span_v (b*c, nk).  q_scr and att_scr are
// (b*c, nq) scratch.  All row-major, of one dtype (f32 or bf16), 16-byte
// aligned; d in {64, 128, 256} is the head dim, h a multiple of 64,
// nq = hkv * G * d, nk = hkv * d.  The plan (ops/cuda/mega_plan.py): bf16
// takes nx, a (b*c, h) bf16 scratch, `partial`, f32 scratch for the
// larger of the Q/K/V and O-projection split partials, and their split
// counts qkv_splits over h / 64 and o_splits over nq / 64 steps (none
// left empty); f32 takes splits of 1 and no scratch.  A plan this source
// cannot run returns cudaErrorInvalidValue before any launch.
extern "C" int pt_mega_decode(const void* x, const void* g, const void* wq,
                              const void* wk, const void* wv, const void* wo,
                              const void* cos, const void* sin,
                              const void* kp, const void* vp,
                              const void* tables, const void* starts,
                              const void* lens, void* out, void* span_k,
                              void* span_v, void* q_scr, void* att_scr,
                              void* nx, void* partial, int b, int c, int h,
                              int nq, int nk, int nb, int page, int hkv,
                              int d, int mb, int qkv_splits, int o_splits,
                              float eps, float scale, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == PT_F32) {
    rc = dispatch(make_params<float>(x, g, wq, wk, wv, wo, cos, sin, kp, vp,
                                     tables, starts, lens, out, span_k,
                                     span_v, q_scr, att_scr, nx, partial, b,
                                     c, h, nq, nk, nb, page, hkv, d, mb,
                                     qkv_splits, o_splits, eps, scale),
                  s, false, nullptr);
  } else if (dtype == PT_BF16) {
    rc = dispatch(make_params<bf16>(x, g, wq, wk, wv, wo, cos, sin, kp, vp,
                                    tables, starts, lens, out, span_k, span_v,
                                    q_scr, att_scr, nx, partial, b, c, h, nq,
                                    nk, nb, page, hkv, d, mb, qkv_splits,
                                    o_splits, eps, scale),
                  s, false, nullptr);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// The cooperative grid the kernel would launch for this geometry and
// split plan: the co-resident block count (capped at the largest phase's
// work items); 0 when not one block fits; -1 for a dtype or head dim it
// does not take.
extern "C" int pt_mega_decode_grid(int b, int c, int h, int nq, int nk,
                                   int page, int hkv, int d, int qkv_splits,
                                   int o_splits, int dtype) {
  int grid = 0, rc;
  if (dtype == PT_F32) {
    rc = dispatch(make_params<float>(nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, nullptr, b,
                                     c, h, nq, nk, 1, page, hkv, d, 1,
                                     qkv_splits, o_splits, 0.f, 0.f),
                  nullptr, true, &grid);
  } else if (dtype == PT_BF16) {
    rc = dispatch(make_params<bf16>(nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, nullptr, b, c,
                                    h, nq, nk, 1, page, hkv, d, 1,
                                    qkv_splits, o_splits, 0.f, 0.f),
                  nullptr, true, &grid);
  } else {
    return -1;
  }
  cudaGetLastError();
  return rc ? -1 : grid;
}
