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
// Design: one block per (slot, kv head, tile of up to 64 q rows).  The
// rows of a kv head are its span rows times its GQA group (row =
// j * G + gq), so KV is never repeated across groups.  The TPU kernel's
// sequential page grid axis becomes a loop over pages inside the block,
// carrying the online-softmax state (m, l, acc) in f32 shared memory.
// The block reads its own slot's table, start and len; the loop stops at
// the last live page (starts + lens - 1) / page, so a table entry past it
// -- the out-of-range sentinel the scheduler pads with -- is never read,
// and a slot with lens == 0 reads nothing and writes zeros.  -1e30 (not
// -inf) masks a score, as in the TPU kernel.
#include "common.cuh"

namespace {

constexpr int kRT = 64;        // q rows per block
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

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
  cudaError_t e = cudaFuncSetAttribute(
      ragged_paged_attention_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = c * (h / hkv);
  dim3 grid(b, hkv, (rows + kRT - 1) / kRT);
  ragged_paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, starts, lens, static_cast<T*>(out),
      c, h, nb, page, hkv, d, mb, scale);
  return 0;
}

}  // namespace

// q (b, c, h, d); pools (nb, page, hkv, d); tables (b, mb) int32;
// starts/lens (b,) int32 -> out (b, c, h, d).  h % hkv == 0.
extern "C" int pt_ragged_paged_attention(const void* q, const void* kp,
                                         const void* vp, const void* tables,
                                         const void* starts,
                                         const void* lens, void* out, int b,
                                         int c, int h, int nb, int page,
                                         int hkv, int d, int mb, float scale,
                                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* st = static_cast<const int*>(starts);
  const int* ln = static_cast<const int*>(lens);
  int rc;
  if (dtype == PT_F32) {
    rc = launch<float>(q, kp, vp, tb, st, ln, out, b, c, h, nb, page, hkv, d,
                       mb, scale, s);
  } else if (dtype == PT_BF16) {
    rc = launch<__nv_bfloat16>(q, kp, vp, tb, st, ln, out, b, c, h, nb, page,
                               hkv, d, mb, scale, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// Dynamic shared memory the kernel needs for this page size and head dim.
extern "C" long long pt_ragged_paged_attention_smem(int page, int d) {
  return (long long)smem_bytes(page, d);
}
