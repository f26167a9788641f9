// Paged decode attention: one query token per slot over the paged KV
// pools, for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/decode_attention.py
// (`paged_attention`, pallas_call at :124).  The contract is
// paddle_tpu/incubate/nn/functional.py `_attend_dense_gqa` over
// `_paged_gather_dense`: slot b's q heads attend pool positions
// [0, lens[b]) through the slot's block table, scores and softmax in f32,
// scale 1/sqrt(D) by default, GQA without repeating KV.  As in the TPU
// kernel, a slot with lens == 0 writes zeros (acc / max(l, 1e-30)), a
// masked score is -1e30 (not -inf), and positions past the table
// (lens > MB * page) are not attended.
//
// Bound on an H100: bytes.  Each slot's live K/V pages are read once per
// kv head, shared by the G q heads of that head, and a decode step does
// ~4 * G operations per KV element, so the least time is the live KV
// bytes over the memory rate.
//
// Design: one block per (slot, kv head, group of up to 8 q heads; 1 or
// 4 where the GQA group is that small), 8 warps.  The context is cut
// into tiles of 8 positions and warp w takes tiles w, w + 8, ...: a lane
// holds D/32 consecutive dims of each of the
// tile's K and V rows and of each q row, so a score is a lane-local
// partial dot product and one butterfly of shuffles, and each warp keeps
// its own online-softmax state (m, l, acc) in registers with no block
// barrier in the loop.  The TPU kernel's sequential page grid axis is that
// loop.  At the end the 8 warps' states are merged through shared memory
// in a fixed order.  A position's block id is read from the table only for
// positions < lens, so no entry past the last live page (lens - 1) / page
// -- the out-of-range sentinel the scheduler pads with -- is ever read;
// ids are clamped into [0, NB) all the same.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 8;       // positions per warp iteration
constexpr int kMaxG = 8;       // q heads per block, at most
constexpr float kNegInf = -1e30f;

// GM: q heads per block (1, 4 or 8), the register arrays' height
template <typename T, int DL, int GM>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens, T* __restrict__ out,
                       int h, int nb, int page, int hkv, int mb, float scale) {
  constexpr int D = DL * 32;
  __shared__ float sm_m[kWarps][GM];
  __shared__ float sm_l[kWarps][GM];
  __shared__ float sm_acc[kWarps][GM][D];

  const int b = blockIdx.x, hk = blockIdx.y;
  const int g = h / hkv;
  const int g0 = blockIdx.z * GM;
  const int ng = min(GM, g - g0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = max(0, min(lens[b], mb * page));
  const int* table = tables + (size_t)b * mb;
  const size_t qrow0 = (size_t)b * h + (size_t)hk * g + g0;

  float qr[GM][DL], acc[GM][DL], m[GM], l[GM];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      qr[gi][i] = gi < ng ? pt::to_f(q[(qrow0 + gi) * D + lane * DL + i])
                          : 0.f;
      acc[gi][i] = 0.f;
    }
  }

  const int ntiles = (len + kTile - 1) / kTile;
  for (int tile = warp; tile < ntiles; tile += kWarps) {
    const int p0 = tile * kTile;
    size_t off[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int pos = p0 + j;
      off[j] = 0;
      if (pos < len) {
        const int blk = min(max(table[pos / page], 0), nb - 1);
        off[j] = (((size_t)blk * page + pos % page) * hkv + hk) * D +
                 lane * DL;
      }
    }
    float kr[kTile][DL];
#pragma unroll
    for (int j = 0; j < kTile; ++j)
#pragma unroll
      for (int i = 0; i < DL; ++i)
        kr[j][i] = p0 + j < len ? pt::to_f(kp[off[j] + i]) : 0.f;
    float s[GM][kTile];
#pragma unroll
    for (int gi = 0; gi < GM; ++gi)
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DL; ++i) dot += qr[gi][i] * kr[j][i];
        s[gi][j] = dot;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int gi = 0; gi < GM; ++gi)
#pragma unroll
        for (int j = 0; j < kTile; ++j)
          s[gi][j] += __shfl_xor_sync(0xffffffffu, s[gi][j], o);
    float vr[kTile][DL];
#pragma unroll
    for (int j = 0; j < kTile; ++j)
#pragma unroll
      for (int i = 0; i < DL; ++i)
        vr[j][i] = p0 + j < len ? pt::to_f(vp[off[j] + i]) : 0.f;
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi >= ng) break;
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        s[gi][j] = p0 + j < len ? s[gi][j] * scale : kNegInf;
        m_cur = fmaxf(m_cur, s[gi][j]);
      }
      const float m_new = fmaxf(m[gi], m_cur);
      const float alpha = expf(m[gi] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[gi][i] *= alpha;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float p = expf(s[gi][j] - m_new);
        psum += p;
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[gi][i] += p * vr[j][i];
      }
      l[gi] = l[gi] * alpha + psum;
      m[gi] = m_new;
    }
  }

  // merge the warps' states in a fixed order
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) {
    if (gi >= ng) break;
    if (lane == 0) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = l[gi];
    }
#pragma unroll
    for (int i = 0; i < DL; ++i) sm_acc[warp][gi][lane * DL + i] = acc[gi][i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ng * D; e += kThreads) {
    const int gi = e / D, dd = e % D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][gi]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][gi] - mx);
      den += sm_l[w][gi] * c;
      num += sm_acc[w][gi][dd] * c;
    }
    out[(qrow0 + gi) * D + dd] = pt::from_f<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int DL, int GM>
void launch_gm(const void* q, const void* kp, const void* vp,
               const int* tables, const int* lens, void* out, int b, int h,
               int nb, int page, int hkv, int mb, float scale,
               cudaStream_t stream) {
  const int g = h / hkv;
  dim3 grid(b, hkv, (g + GM - 1) / GM);
  paged_attention_kernel<T, DL, GM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lens, static_cast<T*>(out), h, nb,
      page, hkv, mb, scale);
}

// the smallest register height of 1, 4, 8 that holds the group (larger
// groups take several blocks of 8)
template <typename T, int DL>
void launch(const void* q, const void* kp, const void* vp, const int* tables,
            const int* lens, void* out, int b, int h, int nb, int page,
            int hkv, int mb, float scale, cudaStream_t stream) {
  const int g = h / hkv;
  if (g == 1)
    launch_gm<T, DL, 1>(q, kp, vp, tables, lens, out, b, h, nb, page, hkv,
                        mb, scale, stream);
  else if (g <= 4)
    launch_gm<T, DL, 4>(q, kp, vp, tables, lens, out, b, h, nb, page, hkv,
                        mb, scale, stream);
  else
    launch_gm<T, DL, kMaxG>(q, kp, vp, tables, lens, out, b, h, nb, page,
                            hkv, mb, scale, stream);
}

template <typename T>
int dispatch(int d, const void* q, const void* kp, const void* vp,
             const int* tables, const int* lens, void* out, int b, int h,
             int nb, int page, int hkv, int mb, float scale,
             cudaStream_t s) {
  switch (d) {
    case 32:
      launch<T, 1>(q, kp, vp, tables, lens, out, b, h, nb, page, hkv, mb,
                   scale, s);
      return 0;
    case 64:
      launch<T, 2>(q, kp, vp, tables, lens, out, b, h, nb, page, hkv, mb,
                   scale, s);
      return 0;
    case 96:
      launch<T, 3>(q, kp, vp, tables, lens, out, b, h, nb, page, hkv, mb,
                   scale, s);
      return 0;
    case 128:
      launch<T, 4>(q, kp, vp, tables, lens, out, b, h, nb, page, hkv, mb,
                   scale, s);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, h, d); pools (nb, page, hkv, d); tables (b, mb) int32; lens (b,)
// int32 -> out (b, h, d).  h % hkv == 0; d in {32, 64, 96, 128}.
extern "C" int pt_paged_attention(const void* q, const void* kp,
                                  const void* vp, const void* tables,
                                  const void* lens, void* out, int b, int h,
                                  int nb, int page, int hkv, int d, int mb,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  int rc;
  if (dtype == PT_F32) {
    rc = dispatch<float>(d, q, kp, vp, tb, ln, out, b, h, nb, page, hkv, mb,
                         scale, s);
  } else if (dtype == PT_BF16) {
    rc = dispatch<__nv_bfloat16>(d, q, kp, vp, tb, ln, out, b, h, nb, page,
                                 hkv, mb, scale, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
