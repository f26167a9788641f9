// Tensor-core pieces shared by the attention kernels
// (csrc/ragged_attention.cu, csrc/paged_attention.cu): one warp's step of
// the online softmax over 16 positions for a 16-row q tile, S = Q K^T and
// P V on mma.sync m16n8k16 with f32 sums, operands by ldmatrix from padded
// shared rows; and 8 values stored as one 16-byte vector.
//
// The tile's state, per lane (g = lane / 4, c = lane % 4): rows g and
// g + 8 of the f32 accumulator (acc[n] holds columns 8n + 2c, 8n + 2c + 1
// of both rows, sm90::mma_16816's d layout) and their running max and sum
// (m_run, l_run, each lane's quarter of the row's sum; the caller adds
// the quad's four at the end).  Scores live in the log2 domain (scaled by
// scale * log2(e)); -1e30 stands for a masked score, whose weight is set
// to exactly 0, so a state that saw no position, (-1e30, 0, 0), drops out
// of a later merge (weight 2^(-1e30 - m) = 0) bit for bit.  P is rounded
// to the 16-bit type before P V (l sums the unrounded weights).
#pragma once

#include "sm90.cuh"

#include <cstdint>

namespace attn {

constexpr float kNegInf = -1e30f;

// 8 floats rounded to T and stored as one 16-byte vector (f32: two).
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[8]) {
  uint4 u;
  u.x = sm90::pack2<T>(v[0], v[1]);
  u.y = sm90::pack2<T>(v[2], v[3]);
  u.z = sm90::pack2<T>(v[4], v[5]);
  u.w = sm90::pack2<T>(v[6], v[7]);
  *reinterpret_cast<uint4*>(dst) = u;
}
template <>
__device__ __forceinline__ void store8<float>(float* dst,
                                              const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The lane's ldmatrix address into a 16-row q tile of row stride LD.
template <int LD, typename T>
__device__ __forceinline__ uint32_t q_lane(const T* qs, int lane) {
  return sm90::smem_addr(qs + (8 * ((lane / 8) % 2) + lane % 8) * LD +
                         8 * (lane / 16));
}

// One warp's 16 positions p0 .. p0 + 15: their K rows from kc and V rows
// from vc (shared, row stride LD), against the q tile at q_lane.  Column
// steps past the head dim d (< DP) are skipped.  Position p is visible to
// the lane's row i (g + 8 i) where p <= lim[i].
template <typename T, int DP, int LD>
__device__ __forceinline__ void chunk(float (&acc)[DP / 8][4],
                                      float (&m_run)[2], float (&l_run)[2],
                                      uint32_t q_lane, const T* kc,
                                      const T* vc, int lane, int d, int p0,
                                      const int (&lim)[2],
                                      float scale_log2) {
  const int ci = lane % 4;
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const uint32_t k_lane = sm90::smem_addr(
      kc + (8 * (lane / 16) + lane % 8) * LD + 8 * ((lane / 8) % 2));
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (kk * 16 >= d) break;
    uint32_t a[4], bk[4];
    sm90::ldmatrix_x4(a, q_lane + kk * 32);
    sm90::ldmatrix_x4(bk, k_lane + kk * 32);
    sm90::mma_16816<T>(s[0], a, bk[0], bk[1]);
    sm90::mma_16816<T>(s[1], a, bk[2], bk[3]);
  }
  // mask, scale into the log2 domain, row maxima over the quad
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pos = p0 + 8 * n + 2 * ci + (e & 1);
      s[n][e] = pos <= lim[e >> 1] ? s[n][e] * scale_log2 : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_run[i], mx[i]);
    alpha[i] = exp2f(m_run[i] - m_new);
    m_run[i] = m_new;
    l_run[i] *= alpha[i];
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = s[n][e] == kNegInf
                          ? 0.f : exp2f(s[n][e] - m_run[e >> 1]);
      s[n][e] = p;
      l_run[e >> 1] += p;
    }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
  // P (rounded to T) . V
  const uint32_t pa[4] = {sm90::pack2<T>(s[0][0], s[0][1]),
                          sm90::pack2<T>(s[0][2], s[0][3]),
                          sm90::pack2<T>(s[1][0], s[1][1]),
                          sm90::pack2<T>(s[1][2], s[1][3])};
  const uint32_t v_lane = sm90::smem_addr(
      vc + (8 * ((lane / 8) % 2) + lane % 8) * LD + 8 * (lane / 16));
#pragma unroll
  for (int n2 = 0; n2 < DP / 16; ++n2) {
    if (n2 * 16 >= d) break;
    uint32_t bv[4];
    sm90::ldmatrix_x4_trans(bv, v_lane + n2 * 32);
    sm90::mma_16816<T>(acc[2 * n2], pa, bv[0], bv[1]);
    sm90::mma_16816<T>(acc[2 * n2 + 1], pa, bv[2], bv[3]);
  }
}

}  // namespace attn
