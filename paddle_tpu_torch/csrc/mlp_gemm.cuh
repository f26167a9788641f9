// Device code shared by the fused MLP kernels (csrc/fused_mlp.cu, SwiGLU,
// and csrc/fused_gelu_mlp.cu, GELU): the GEMM main loops (bf16 on the
// tensor cores, f32 on the SIMT units), the down projection with its
// split-K epilogue, the fixed-order sum of the splits and the check of the
// plan that the Python wrapper chose (paddle_tpu_torch/ops/cuda/mlp_plan.py).
// The fused QKV kernel (csrc/fused_norm_qkv.cu, through
// csrc/qkv_gemm.cuh) and the decode megakernel's Q/K/V and O-projection
// phases (csrc/mega_decode.cu) run their products on `gemm_tiles` too
// (with EDGE: a contraction tail and half-width column tiles) and store
// through `store_rows`; the int8 and int4 GEMMs (csrc/dequant_gemm.cuh,
// csrc/dequant_swap.cuh) borrow the accumulator layout, the ring's
// alignment and the dependent launch.
//
// Both MLPs run as two GEMMs over one intermediate h in device memory:
//   up:   h = act(x @ W1 [+ b1]) -> (T, I) in x's dtype, rounded once;
//   down: out = h @ W2 [+ b2]    -> (T, H), rounded once,
// with the down projection's contraction split across blocks only where
// its output tiles are too few to fill the card.  With more than one
// split each split writes an f32 (T, H) partial and a third kernel adds
// them in split order (then b2), so the sum order is the same every run.
//
// bf16 tiles.  A block is two warpgroups (256 threads) and owns kBM = 128
// rows, 64 per warpgroup, each an m64 wgmma accumulator.  The contraction
// runs in kBK = 64 steps through a ring of 16-byte cp.async copies into
// 128-byte-swizzled tiles (csrc/sm90.cuh): the activation
// tile is K-major (A, desc_k), the row-major weight tiles are MN-major
// (B, desc_mn).  Rows past T are zero-filled by the copy itself
// (src_bytes 0).  A ring of 3 stages (at most 32 KB each) lets two blocks
// share an SM, so one block's barrier and epilogue overlap the other's
// products (a fourth stage, where it fit, was slower on an H100).
//
// Launches.  The down projection and the split sum are programmatic
// dependent launches: each may start while the kernel before it
// finishes, and the down kernel loads its first weight stages before it
// waits for h (grid_dependency_wait, sm90.cuh).
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace mlp {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // two warpgroups
constexpr int kBM = 128;        // token rows per block
constexpr int kBK = 64;         // contraction step (the split-K unit too)
constexpr int kStages = 3;      // cp.async ring depth
constexpr int kDownBN = 128;    // output columns per down block
constexpr int kMinBlocks = 2;   // blocks per SM the registers must allow

template <int NW, int BN>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)kStages * (kBM * kBK * 2 + NW * kBK * BN * 2);
}

// dynamic shared memory of a kernel over that ring (+ 1024 to align it)
template <int NW, int BN>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + ring_bytes<NW, BN>();
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (sm90::smem_addr(p) & 1023u)) & 1023u);
}

// acc[w] += A[m0 : m0 + kBM, K] . B_w[K, n0 : n0 + BN] for every weight w,
// K the contraction steps [kb, ke) of kBK.  A is (t, lda) row-major, rows
// >= t read as zeros; each B_w is row-major with row stride ldb.  Each
// warpgroup accumulates its 64 rows (sm90.cuh gives the layout).  With
// WAIT_A, A is the previous kernel's output: the first weight stages are
// requested before grid_dependency_wait, A only after it.  Ends with
// every product retired; the ring may then be reused after a block
// barrier.  With EDGE, contraction indices >= kdim (a multiple of 8) and
// weight columns >= n0 + ncols (a multiple of 8) are zero-filled by the
// copies instead of read.
template <int NW, int BN, bool WAIT_A = false, bool EDGE = false>
__device__ __forceinline__ void gemm_tiles(unsigned char* sm,
                                           const bf16* __restrict__ a,
                                           int lda, int t, int m0,
                                           const bf16* const (&b)[NW],
                                           int ldb, int n0, int kb, int ke,
                                           float (&acc)[NW][BN / 2],
                                           int kdim = 0, int ncols = BN) {
  constexpr int ST = kStages;
  constexpr uint32_t AB = kBM * kBK * 2, BB = kBK * BN * 2,
                     SB = AB + NW * BB;
  const uint32_t s0 = sm90::smem_addr(sm);
  const int wg = threadIdx.x / 128;
  // A: 8 chunks of 16 bytes per row, a thread's 4 chunks 32 rows apart
  // (one swizzle); B: BN / 8 chunks per row, RSTEP rows apart
  const int ca = threadIdx.x % 8 * 8, ra = threadIdx.x / 8;
  const uint32_t da = sm90::swz<kBM>(ra, ca);
  constexpr int CPR = BN / 8, RSTEP = kThreads / CPR;
  static_assert(RSTEP % 8 == 0 && kBK % RSTEP == 0, "chunk walk");
  const int cb = threadIdx.x % CPR * 8, rb = threadIdx.x / CPR;
  const uint32_t db = sm90::swz<kBK>(rb, cb);
  const bf16* pa = a + (size_t)(m0 + ra) * lda + ca;
  const size_t bofs = (size_t)rb * ldb + n0 + cb;

  // contraction step kb + j into slot j % ST: the activation, the weights
  auto load_a = [&](int j) {
    const uint32_t st = s0 + (j % ST) * SB;
    const int k0 = (kb + j) * kBK;
#pragma unroll
    for (int i = 0; i < kBM / 32; ++i) {
      const bool in =
          m0 + ra + 32 * i < t && (!EDGE || k0 + ca < kdim);
      sm90::cp_async16(st + da + i * 32 * 128,
                       in ? pa + (size_t)i * 32 * lda + k0 : a, in ? 16 : 0);
    }
  };
  auto load_b = [&](int j) {
    const uint32_t st = s0 + (j % ST) * SB;
    const int k0 = (kb + j) * kBK;
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < kBK / RSTEP; ++i) {
        const bool in =
            !EDGE || (k0 + i * RSTEP + rb < kdim && cb < ncols);
        sm90::cp_async16(st + AB + w * BB + db + i * RSTEP * 128,
                         in ? b[w] + bofs + (size_t)(k0 + i * RSTEP) * ldb
                            : b[w],
                         in ? 16 : 0);
      }
  };

  // Steps 0 .. ST - 2 in flight, one commit group each (group 0 also
  // holds the later steps' weights).
  const int n = ke - kb;
#pragma unroll
  for (int j = 0; j < ST - 1; ++j)
    if (j < n) load_b(j);
  if (WAIT_A) sm90::grid_dependency_wait();
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) {
    if (j < n) load_a(j);
    sm90::cp_async_commit();
  }
  for (int j = 0; j < n; ++j) {
    // step j has landed (later ones may be in flight); every warpgroup
    // has retired step j - 1's products, so its slot takes step j + ST - 1
    sm90::cp_async_wait<ST - 2>();
    sm90::fence_proxy_async();
    __syncthreads();
    if (j + ST - 1 < n) {
      load_a(j + ST - 1);
      load_b(j + ST - 1);
    }
    sm90::cp_async_commit();
    const uint32_t st = s0 + (j % ST) * SB;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da_k = sm90::desc_k<kBM>(st, 64 * wg, kk);
#pragma unroll
      for (int w = 0; w < NW; ++w)
        sm90::mma_ss_mn<bf16, BN>(acc[w], da_k,
                                  sm90::desc_mn<kBK>(st + AB + w * BB, 0, kk),
                                  1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int w = 0; w < NW; ++w) sm90::fence_regs(acc[w]);
  }
  sm90::cp_async_wait<0>();
}

// Element i of a bias of f32 or (bias_bf16) bf16 values.
__device__ __forceinline__ float bias_at(const void* b, int bias_bf16, int i) {
  return bias_bf16 ? pt::to_f(static_cast<const bf16*>(b)[i])
                   : static_cast<const float*>(b)[i];
}

// Column (within the block's BN) of accumulator element 4 j + 2 i + e and
// its row (within the block's kBM).
__device__ __forceinline__ int acc_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x % 4) + e;
}
__device__ __forceinline__ int acc_row(int i) {
  return 64 * (threadIdx.x / 128) + 16 * (threadIdx.x / 32 % 4) +
         threadIdx.x % 32 / 4 + 8 * i;
}

// The block's kBM x BN values v (the accumulator layout), rounded to bf16,
// into rows [m0, min(m0 + kBM, t)) and columns [n0, n0 + ncols) of dst
// (row stride ld; ncols a multiple of 8), through a swizzled tile at sm
// and 16-byte stores.  Called by every thread after the ring's last use.
template <int BN>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, int ld,
                                           int t, int m0, int n0,
                                           unsigned char* sm,
                                           const float (&v)[BN / 2],
                                           int ncols = BN) {
  __syncthreads();   // every warpgroup is done with the ring
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(sm +
                                   sm90::swz<kBM>(acc_row(i), acc_col(j, 0))) =
          sm90::pack2<bf16>(v[4 * j + 2 * i], v[4 * j + 2 * i + 1]);
  __syncthreads();
  for (int e = threadIdx.x; e < kBM * BN / 8; e += kThreads) {
    const int r = e / (BN / 8), c = e % (BN / 8) * 8;
    if (m0 + r < t && c < ncols)
      *reinterpret_cast<uint4*>(dst + (size_t)(m0 + r) * ld + n0 + c) =
          *reinterpret_cast<const uint4*>(sm + sm90::swz<kBM>(r, c));
  }
}

// out (t, h) = h_in (t, inter) @ wd (inter, h) [+ b2], or with splits
// (gridDim.z > 1) split z's f32 product over contraction steps
// [z kps, (z + 1) kps) into partial + z t h.  Grid (row tiles, h / 128,
// splits).  Launched after the up kernel as a dependent launch: h is read
// only after grid_dependency_wait.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
down16_kernel(const bf16* __restrict__ hin, const bf16* __restrict__ wd,
              const void* __restrict__ b2, int b2_bf16,
              bf16* __restrict__ out, float* __restrict__ partial, int t,
              int h, int inter, int kps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  sm90::launch_dependents();   // the split sum may start its launch
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kDownBN;
  const int kb = blockIdx.z * kps, ke = min(inter / kBK, kb + kps);
  float acc[1][kDownBN / 2];
#pragma unroll
  for (int i = 0; i < kDownBN / 2; ++i) acc[0][i] = 0.f;
  const bf16* const w[1] = {wd};
  gemm_tiles<1, kDownBN, true>(sm, hin, inter, t, m0, w, h, n0, kb, ke,
                               acc);
  if (gridDim.z == 1) {
    if (b2 != nullptr) {
#pragma unroll
      for (int j = 0; j < kDownBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bias = bias_at(b2, b2_bf16, n0 + acc_col(j, e));
          acc[0][4 * j + e] += bias;
          acc[0][4 * j + 2 + e] += bias;
        }
    }
    store_rows<kDownBN>(out, h, t, m0, n0, sm, acc[0]);
    return;
  }
  float* p = partial + (size_t)blockIdx.z * t * h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + acc_row(i);
    if (r >= t) continue;
#pragma unroll
    for (int j = 0; j < kDownBN / 8; ++j)
      *reinterpret_cast<float2*>(p + (size_t)r * h + n0 + acc_col(j, 0)) =
          make_float2(acc[0][4 * j + 2 * i], acc[0][4 * j + 2 * i + 1]);
  }
}

// ---- f32: SIMT units, 16 x 16 threads, each 4 rows x 8 columns ------------

namespace simt {

constexpr int kBM = 64, kBN = 128, kBK = 16, kTX = 16, kRM = kBM / 16;

__device__ __forceinline__ int col_of(int tx, int c) {
  // four columns in each half of a 128-wide tile: conflict-free loads
  return (c < 4) ? tx * 4 + c : 64 + tx * 4 + (c - 4);
}

// shared floats of gemm<NW>'s stages
template <int NW>
__host__ __device__ constexpr int smem_floats() {
  return kBK * kBM + NW * kBK * kBN;
}

// acc[w] += A[m0 : m0 + kBM, k0 : k1] . B_w[k0 : k1, n0 : n0 + kBN]: A is
// (t, lda) row-major, rows >= t read as zeros; each B_w row-major with
// stride ldb; k1 - k0 a multiple of 64.  Thread (tx, ty) holds rows
// ty kRM + r, columns col_of(tx, c).  The sum runs in two levels: each
// 64-deep step sums from zero, then joins acc, so no thread adds
// thousands of terms into one running float (the f32 error then stays
// near a blocked sum's, as in cuBLAS, at H = 8192 and I = 28672).
template <int NW>
__device__ __forceinline__ void gemm(float* sm, const float* __restrict__ a,
                                     int lda, int t, int m0,
                                     const float* const (&b)[NW], int ldb,
                                     int n0, int k0, int k1,
                                     float (&acc)[NW][kRM][8]) {
  float* as = sm;                 // [kBK][kBM]
  float* bs = sm + kBK * kBM;     // [NW][kBK][kBN]
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  for (int k64 = k0; k64 < k1; k64 += mlp::kBK) {
    float part[NW][kRM][8] = {};
    for (int k = k64; k < k64 + mlp::kBK; k += kBK) {
      for (int e = tid; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK, kk = e % kBK, row = m0 + r;
        as[kk * kBM + r] = row < t ? a[(size_t)row * lda + k + kk] : 0.f;
      }
#pragma unroll
      for (int w = 0; w < NW; ++w)
        for (int e = tid; e < kBK * kBN; e += kThreads)
          bs[w * kBK * kBN + e] =
              b[w][(size_t)(k + e / kBN) * ldb + n0 + e % kBN];
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[kRM];
#pragma unroll
        for (int r = 0; r < kRM; ++r) av[r] = as[kk * kBM + ty * kRM + r];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          float bv[8];
#pragma unroll
          for (int c = 0; c < 8; ++c)
            bv[c] = bs[(w * kBK + kk) * kBN + col_of(tx, c)];
#pragma unroll
          for (int r = 0; r < kRM; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) part[w][r][c] += av[r] * bv[c];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[w][r][c] += part[w][r][c];
  }
}

// The f32 down projection: grid (row tiles of kBM, h / kBN, splits), the
// same split rule and partial layout as down16_kernel.
__global__ void __launch_bounds__(kThreads)
down32_kernel(const float* __restrict__ hin, const float* __restrict__ wd,
              const void* __restrict__ b2, int b2_bf16,
              float* __restrict__ out, float* __restrict__ partial, int t,
              int h, int inter, int kps) {
  __shared__ float sm[smem_floats<1>()];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kb = blockIdx.z * kps, ke = min(inter / mlp::kBK, kb + kps);
  float acc[1][kRM][8] = {};
  const float* const w[1] = {wd};
  gemm<1>(sm, hin, inter, t, m0, w, h, n0, kb * mlp::kBK, ke * mlp::kBK, acc);
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const bool one = gridDim.z == 1;
  float* dst = one ? out : partial + (size_t)blockIdx.z * t * h;
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int row = m0 + ty * kRM + r;
    if (row >= t) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n0 + col_of(tx, c);
      dst[(size_t)row * h + col] =
          acc[0][r][c] +
          (one && b2 != nullptr ? bias_at(b2, b2_bf16, col) : 0.f);
    }
  }
}

}  // namespace simt

// ---- the fixed-order sum of the splits, + b2 (if any), rounded once ---------

// A dependent launch after the down kernel: reads the partials only after
// grid_dependency_wait.
template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  const void* __restrict__ bias,
                                  int bias_bf16, T* __restrict__ out,
                                  int splits, int h, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  sm90::grid_dependency_wait();
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(size_t)p * n + i];
  if (bias != nullptr) s += bias_at(bias, bias_bf16, (int)(i % h));
  out[i] = pt::from_f<T>(s);
}

// ---- the plan -----------------------------------------------------------------

// Contraction steps of kBK over `inter` per split, or 0 where the plan
// cannot run: T >= 1, H and I multiples of 128, 1 <= splits, and no
// split left empty (mlp_plan.py makes the same choice).
inline int steps_per_split(int t, int h, int inter, int splits) {
  if (t < 1 || h < 128 || inter < 128 || h % 128 || inter % 128 ||
      splits < 1)
    return 0;
  const int nk = inter / kBK, kps = (nk + splits - 1) / splits;
  return (splits - 1) * kps < nk ? kps : 0;
}

// kern<<<grid, block, smem, s>>>(args...) as a programmatic dependent
// launch: it may start while the kernel before it on s finishes, and
// waits for that kernel (grid_dependency_wait) before reading its output.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kern)(Params...), dim3 grid, int block,
                             size_t smem, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The down projection of h (t, inter) into out (t, h) [+ b2, f32 or
// (b2_bf16) bf16] by the plan's splits, then (splits > 1) the sum of the
// partials.  T is float or bf16.
template <typename T>
int down(const void* hin, const void* wd, const void* b2, int b2_bf16,
         void* partial, void* out, int t, int h, int inter, int splits,
         int kps, cudaStream_t s) {
  float* part = static_cast<float*>(partial);
  if (splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if constexpr (sizeof(T) == 2) {
    constexpr size_t smem = smem_bytes<1, kDownBN>();
    e = allow_smem(down16_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((t + kBM - 1) / kBM, h / kDownBN, splits);
    e = launch_dependent(down16_kernel, grid, kThreads, smem, s,
                         static_cast<const bf16*>(hin),
                         static_cast<const bf16*>(wd), b2, b2_bf16,
                         static_cast<bf16*>(out), part, t, h, inter, kps);
  } else {
    dim3 grid((t + simt::kBM - 1) / simt::kBM, h / simt::kBN, splits);
    simt::down32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(hin), static_cast<const float*>(wd), b2,
        b2_bf16, static_cast<float*>(out), part, t, h, inter, kps);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t n = (size_t)t * h;
  e = launch_dependent(sum_splits_kernel<T>,
                       dim3((unsigned)((n + 255) / 256)), 256, 0, s,
                       static_cast<const float*>(part), b2, b2_bf16,
                       static_cast<T*>(out), splits, h, n);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace mlp
