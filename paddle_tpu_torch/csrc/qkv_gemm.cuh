// Device code of the bf16 RMSNorm -> Q/K/V -> rotate-half RoPE product,
// shared by csrc/fused_norm_qkv.cu (each piece a kernel of its own) and
// csrc/mega_decode.cu (each piece a phase of work items), so the two run
// the same arithmetic:
//   norm_row   one row of nx = round(x * rsqrt(mean(x^2) + eps) * g), the
//              contract's rounding point, 16-byte vectors (h % 8 == 0);
//   gemm_tile  y = nx @ W over one 128-row by 128-column tile of [q | k |
//              v] on mlp_gemm.cuh's `gemm_tiles` (wgmma, a cp.async ring),
//              a contraction range [kb, ke) of 64-deep steps; then either
//              round, RoPE in registers (q and k), round, 16-byte stores,
//              or the f32 sum into split z's partial;
//   sum_pair   the partials of columns j and j + HD/2 of one head of one
//              row added in split order, rounded, RoPE on q and k,
//              rounded again.
// RoPE pairs column c with c + HD/2.  In the m64n128 accumulator those
// belong to one thread (column blocks j and j + HD/16) for HD <= 128; a
// wider head takes the partial path.  Explicit __fmul_rn/__fadd_rn keep
// y*c + rot*s unfused, as in the reference.  The partials are read with
// __ldcg (L2): in the megakernel other blocks of the same launch wrote
// them.
#pragma once

#include "common.cuh"
#include "mlp_gemm.cuh"
#include "sm90.cuh"

namespace qkv {

using bf16 = __nv_bfloat16;

constexpr int kBN = 128;   // output columns per GEMM tile

// nx[row] = round(x[row] * rsqrt(mean(x[row]^2) + eps) * g) by the NT
// threads of the block; warp_sums: NT / 32 floats of shared memory.  Ends
// with the block's reads of warp_sums done only after a barrier, so the
// caller runs __syncthreads() before reusing it.
template <int NT>
__device__ __forceinline__ void norm_row(const bf16* __restrict__ x,
                                         const bf16* __restrict__ g,
                                         bf16* __restrict__ nx, int h,
                                         float eps, int row,
                                         float* warp_sums) {
  const bf16* xr = x + (size_t)row * h;
  float s = 0.f;
  for (int c = threadIdx.x * 8; c < h; c += NT * 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = pt::to_f(e[i]);
      s += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) total += warp_sums[w];
  const float rstd = rsqrtf(total / (float)h + eps);
  bf16* out = nx + (size_t)row * h;
  for (int c = threadIdx.x * 8; c < h; c += NT * 8) {
    const uint4 ux = *reinterpret_cast<const uint4*>(xr + c);
    const uint4 ug = *reinterpret_cast<const uint4*>(g + c);
    const bf16* ex = reinterpret_cast<const bf16*>(&ux);
    const bf16* eg = reinterpret_cast<const bf16*>(&ug);
    uint32_t p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = sm90::pack2<bf16>(pt::to_f(ex[2 * i]) * rstd * pt::to_f(eg[2 * i]),
                               pt::to_f(ex[2 * i + 1]) * rstd *
                                   pt::to_f(eg[2 * i + 1]));
    *reinterpret_cast<uint4*>(out + c) = make_uint4(p[0], p[1], p[2], p[3]);
  }
}

// lo, hi = round(lo), round(hi) rotated by cos/sin (c_lo, s_lo of column
// j, c_hi, s_hi of column j + HD/2), in f32 with explicit roundings so
// y*c + rot*s stays unfused.
__device__ __forceinline__ void rope_pair(float& lo, float& hi, float c_lo,
                                          float s_lo, float c_hi,
                                          float s_hi) {
  const float a = pt::round_to<bf16>(lo), b = pt::round_to<bf16>(hi);
  lo = __fadd_rn(__fmul_rn(a, c_lo), __fmul_rn(-b, s_lo));
  hi = __fadd_rn(__fmul_rn(b, c_hi), __fmul_rn(a, s_hi));
}

// RoPE on the block's m64n128 accumulator in place (sm90.cuh gives the
// layout): column block j (8 columns) of a head pairs with j + HD/16.
template <int HD>
__device__ __forceinline__ void rope_regs(float (&d)[kBN / 2],
                                          const bf16* __restrict__ cos,
                                          const bf16* __restrict__ sin,
                                          int t, int m0) {
  static_assert(HD <= kBN, "a head's halves in one tile");
  constexpr int HALF = HD / 2, PJ = HALF / 8;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    if ((8 * j) % HD >= HALF) continue;
    const int c = mlp::acc_col(j, 0) % HD;   // even, < HALF
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + mlp::acc_row(i);
      if (r >= t) continue;
      const size_t o = (size_t)r * HD + c;
      const __nv_bfloat162 cl = *reinterpret_cast<const __nv_bfloat162*>(cos + o);
      const __nv_bfloat162 ch =
          *reinterpret_cast<const __nv_bfloat162*>(cos + o + HALF);
      const __nv_bfloat162 sl = *reinterpret_cast<const __nv_bfloat162*>(sin + o);
      const __nv_bfloat162 sh =
          *reinterpret_cast<const __nv_bfloat162*>(sin + o + HALF);
      rope_pair(d[4 * j + 2 * i], d[4 * (j + PJ) + 2 * i],
                __low2float(cl), __low2float(sl), __low2float(ch),
                __low2float(sh));
      rope_pair(d[4 * j + 2 * i + 1], d[4 * (j + PJ) + 2 * i + 1],
                __high2float(cl), __high2float(sl), __high2float(ch),
                __high2float(sh));
    }
  }
}

// Tile `tile` of the column tiles [q | k | v] (ceil(nq / 128) of q, then
// ceil(nk / 128) each of k and v), token rows [m0, m0 + 128), contraction
// steps [kb, ke).  to_partial false (HD <= 128 only): round, RoPE on q
// and k, round, store into q, k or v.  to_partial true: the f32 sum into
// partial + z t (nq + 2 nk), columns in [q | k | v] order.  `sm` holds the gemm_tiles ring;
// called by all threads; the ring is free again after a block barrier.
// WAIT_A: nx is the previous kernel's output (a dependent launch).
template <int HD, bool WAIT_A>
__device__ __forceinline__ void gemm_tile(
    unsigned char* sm, const bf16* __restrict__ nx,
    const bf16* __restrict__ wq, const bf16* __restrict__ wk,
    const bf16* __restrict__ wv, const bf16* __restrict__ cos,
    const bf16* __restrict__ sin, bf16* q, bf16* k, bf16* v,
    float* partial, int t, int h, int nq, int nk, int m0, int tile, int kb,
    int ke, int z, bool to_partial) {
  const int tq = (nq + kBN - 1) / kBN, tk = (nk + kBN - 1) / kBN;
  int kind, nw, coff;
  const bf16* w;
  bf16* out;
  if (tile < tq) {
    kind = 0; w = wq; out = q; nw = nq; coff = 0;
  } else if (tile < tq + tk) {
    tile -= tq; kind = 1; w = wk; out = k; nw = nk; coff = nq;
  } else {
    tile -= tq + tk; kind = 2; w = wv; out = v; nw = nk; coff = nq + nk;
  }
  const int n0 = tile * kBN, ncols = min(kBN, nw - n0);
  float acc[1][kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[0][i] = 0.f;
  const bf16* const ws[1] = {w};
  mlp::gemm_tiles<1, kBN, WAIT_A, true>(sm, nx, h, t, m0, ws, nw, n0, kb, ke,
                                        acc, h, ncols);
  if (!to_partial) {
    if constexpr (HD <= kBN) {
      if (kind != 2) rope_regs<HD>(acc[0], cos, sin, t, m0);
      mlp::store_rows<kBN>(out, nw, t, m0, n0, sm, acc[0], ncols);
    }
    return;
  }
  const int ntot = nq + 2 * nk;
  float* p = partial + (size_t)z * t * ntot + coff + n0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + mlp::acc_row(i);
    if (r >= t) continue;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = mlp::acc_col(j, 0);
      if (c < ncols)
        *reinterpret_cast<float2*>(p + (size_t)r * ntot + c) =
            make_float2(acc[0][4 * j + 2 * i], acc[0][4 * j + 2 * i + 1]);
    }
  }
}

// Pair idx of the t x (nq + 2 nk) / 2 pairs: the splits' partials added
// in split order for columns j and j + HD/2 of one head of one row,
// rounded, RoPE on q and k, rounded again.
template <int HD>
__device__ __forceinline__ void sum_pair(const float* partial,
                                         const bf16* __restrict__ cos,
                                         const bf16* __restrict__ sin,
                                         bf16* q, bf16* k, bf16* v, int t,
                                         int nq, int nk, int splits,
                                         size_t idx) {
  constexpr int HALF = HD / 2;
  const int half_cols = (nq + 2 * nk) / 2;
  if (idx >= (size_t)t * half_cols) return;
  const int r = (int)(idx / half_cols), u = (int)(idx % half_cols);
  const int col = u / HALF * HD + u % HALF, j = u % HALF;
  const size_t plane = (size_t)t * 2 * half_cols;
  const float* p = partial + (size_t)r * 2 * half_cols + col;
  float lo = 0.f, hi = 0.f;
  for (int s = 0; s < splits; ++s) {
    lo += __ldcg(p + s * plane);
    hi += __ldcg(p + s * plane + HALF);
  }
  bf16* out;
  int ld, oc;
  if (col < nq) {
    out = q; ld = nq; oc = col;
  } else if (col < nq + nk) {
    out = k; ld = nk; oc = col - nq;
  } else {
    out = v; ld = nk; oc = col - nq - nk;
  }
  if (col < nq + nk) {   // q or k
    const bf16* cr = cos + (size_t)r * HD;
    const bf16* sr = sin + (size_t)r * HD;
    rope_pair(lo, hi, pt::to_f(cr[j]), pt::to_f(sr[j]),
              pt::to_f(cr[HALF + j]), pt::to_f(sr[HALF + j]));
  }
  out[(size_t)r * ld + oc] = pt::from_f<bf16>(lo);
  out[(size_t)r * ld + oc + HALF] = pt::from_f<bf16>(hi);
}

}  // namespace qkv
