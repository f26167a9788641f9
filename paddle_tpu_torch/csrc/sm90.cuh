// Hopper (sm_90a) building blocks of the port's hand-written kernels, in
// raw PTX: asynchronous copies, the 128-byte-swizzled shared tiles that
// `wgmma` reads, its matrix descriptors, the warpgroup products and the
// fences between them.  No library code: a source that includes this
// header still builds in seconds.
//
// Shared tiles.  A tile of R rows by C columns of 16-bit values is kept
// as C / 64 panels, one after another, each R rows of 128 bytes (64
// values).  Inside a panel the 16-byte chunk j of row r sits at chunk
// j ^ (r % 8): the 128-byte swizzle, so the 8 rows of a 1024-byte atom
// spread one column over all 32 banks.  Panels must start on 1024 bytes.
// wgmma reads such a tile either way round:
//   K-major   (the contraction runs along a row): rows are the M or N
//             index; one 16-wide contraction step is 32 bytes into the
//             row, which the descriptor's start address carries (the
//             hardware applies the swizzle to the address it computes);
//   MN-major  (the contraction runs down the rows, as for V in P.V): a
//             16-row step is 2048 bytes down the panel; the next 64
//             columns are the next panel (the descriptor's leading
//             offset), the next 8 rows the next atom (its stride offset).
//
// Fences.  cp.async and st.shared write through the generic proxy and
// wgmma reads through the async proxy, so a writer runs
// fence_proxy_async() after its writes land and before the barrier that
// releases them to wgmma.  wgmma runs asynchronously on registers the
// compiler thinks it owns: fence_regs() after wgmma_wait pins the
// accumulators, and keep_regs() keeps a register A operand alive (and
// unchanged) until the wait has retired the product that reads it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- asynchronous copies ---------------------------------------------------

// 16 bytes global -> shared; the bytes past `src_bytes` (0 for a row past
// the end) are zero-filled and not read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, zero-filled the same way.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch: a kernel launched with the
// programmatic-serialization attribute may start before the previous
// kernel on its stream has finished; grid_dependency_wait() blocks until
// that kernel has completed and its writes are visible (a no-op without
// the attribute), and launch_dependents() lets the next such kernel start
// once every block of this one has called it or exited.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Four 8 x 8 matrices of 16-bit elements from shared memory, transposed:
// lanes 8i .. 8i + 7 give the addresses of matrix i's eight 16-byte rows,
// and lane l receives in r[i] matrix i's elements (row 2 (l % 4), column
// l / 4) in its low half and (row 2 (l % 4) + 1, column l / 4) in its
// high half.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same without the transpose: lane l receives in r[i] matrix i's
// elements (row l / 4, columns 2 (l % 4), 2 (l % 4) + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ---- warp-level products (mma.sync) ----------------------------------------
//
// d (+)= A (16 x 16, bf16) . B (16 x 8, bf16) in f32, one warp.  Lane l,
// g = l / 4, c = l % 4, holds
//   a = {A[g][2c, 2c+1], A[g+8][2c, 2c+1], A[g][2c+8, 2c+9],
//        A[g+8][2c+8, 2c+9]},   b = {B[2c, 2c+1][g], B[2c+8, 2c+9][g]},
//   d = {D[g][2c], D[g][2c+1], D[g+8][2c], D[g+8][2c+1]}
// (pairs packed low half first).  ldmatrix_x4 of a row-major 16 x 16
// tile, lane l addressing row 8 ((l / 8) % 2) + l % 8 at column
// 8 (l / 16), gives a; ldmatrix_x4_trans of a row-major (K, N) tile, lane
// l addressing row 8 ((l / 8) % 2) + l % 8 at column n0 + 8 (l / 16),
// gives b for columns n0 .. n0 + 7 in r[0], r[1] and n0 + 8 .. n0 + 15 in
// r[2], r[3]; ldmatrix_x4 of an (N, K) tile (B's transpose), lane l
// addressing row n0 + 8 (l / 16) + l % 8 at column 8 ((l / 8) % 2), gives
// the same.  Two d fragments of adjacent 8-column blocks are, rounded
// and packed, the a fragment of a product over those 16 columns
// ({pack(d0[0], d0[1]), pack(d0[2], d0[3]), pack(d1[0], d1[1]),
// pack(d1[2], d1[3])}).
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- swizzled tiles and descriptors -----------------------------------------

// Byte offset of element (r, c) in a swizzled tile of R rows.
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 6) * (R * 128) + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         ((c & 7) << 1);
}

// A wgmma matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle (layout type 1, bits 62-63).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: rows [r0, r0 + 64 or N) of an R-row tile at `tile`,
// contraction step kk (columns 16 kk .. 16 kk + 15).
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return make_desc(tile + (kk >> 2) * (R * 128) + r0 * 128 + (kk & 3) * 32,
                   16, 1024);
}

// MN-major operand: contraction rows [16 kk, 16 kk + 16) of an R-row tile,
// columns from c0 (a multiple of 64).
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int c0, int kk) {
  return make_desc(tile + (c0 >> 6) * (R * 128) + kk * 2048, R * 128, 1024);
}

// ---- warpgroup products -----------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Two floats rounded to the 16-bit type and packed, the first in the low
// half: one register of a wgmma A fragment.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The accumulator of m64nNk16 (f32, N / 2 values a thread): thread t of
// the warpgroup holds, for column block j (8 columns), d[4j + 2i + e] =
// C[16 (t / 32) + (t % 32) / 4 + 8 i][8 j + 2 (t % 4) + e].  The A
// fragment of contraction step kk, from such an accumulator over the
// contraction columns, is {pack(d[8kk], d[8kk+1]), pack(d[8kk+2], ..+3),
// pack(d[8kk+4], ..+5), pack(d[8kk+6], ..+7)}.
//
// mma_ss<T, N>: d (+)= A (64 x 16, K-major, shared) . B (16 x N, K-major,
// shared); mma_ss_mn<T, N>: the same with B MN-major (a row-major (K, N)
// weight tile, as the MLP kernels read theirs); mma_rs<T, N>: d (+)= A
// (registers) . B (16 x N, MN-major, shared); mma_rs_k<T, N>: the same
// with B K-major.  `acc` 0 overwrites d.  The A fragment in registers:
// lane l of warp w holds {A[16w + g][2c, 2c+1], A[16w + g + 8][2c, 2c+1],
// A[16w + g][2c + 8, 2c + 9], A[16w + g + 8][2c + 8, 2c + 9]}, g = l / 4,
// c = l % 4, each pair packed low half first.
template <typename T, int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int acc);
template <typename T, int N>
__device__ __forceinline__ void mma_ss_mn(float (&d)[N / 2], uint64_t a,
                                          uint64_t b, int acc);
template <typename T, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int acc);
template <typename T, int N>
__device__ __forceinline__ void mma_rs_k(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int acc);

#define PT_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PT_D4 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define PT_D16 PT_D8(0), PT_D8(8)
#define PT_D32 PT_D16, PT_D8(16), PT_D8(24)
#define PT_D64 PT_D32, PT_D8(32), PT_D8(40), PT_D8(48), PT_D8(56)
#define PT_R4 "{%0, %1, %2, %3}"
#define PT_R16                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define PT_R32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define PT_R64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// IA, IB, IS: operand numbers of the descriptors and of `acc`.
#define PT_WGMMA_SS(T, TY, N, DREGS, DOPS, IA, IB, IS)                    \
  template <>                                                             \
  __device__ __forceinline__ void mma_ss<T, N>(                           \
      float(&d)[N / 2], uint64_t a, uint64_t b, int acc) {                \
    asm volatile(                                                         \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                 \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "   \
        DREGS ", %" #IA ", %" #IB ", p, 1, 1, 0, 0;\n}\n"                 \
        : DOPS                                                            \
        : "l"(a), "l"(b), "r"(acc));                                      \
  }
// The same with B MN-major (trans-b 1).
#define PT_WGMMA_SS_MN(T, TY, N, DREGS, DOPS, IA, IB, IS)                 \
  template <>                                                             \
  __device__ __forceinline__ void mma_ss_mn<T, N>(                        \
      float(&d)[N / 2], uint64_t a, uint64_t b, int acc) {                \
    asm volatile(                                                         \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                 \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "   \
        DREGS ", %" #IA ", %" #IB ", p, 1, 1, 0, 1;\n}\n"                 \
        : DOPS                                                            \
        : "l"(a), "l"(b), "r"(acc));                                      \
  }
// A0..A3: the A registers' operand numbers; B is MN-major (trans-b 1).
#define PT_WGMMA_RS(T, TY, N, DREGS, DOPS, A0, A1, A2, A3, IB, IS)        \
  template <>                                                             \
  __device__ __forceinline__ void mma_rs<T, N>(                           \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t b, int acc) {     \
    asm volatile(                                                         \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                 \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "   \
        DREGS ", {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #IB         \
        ", p, 1, 1, 1;\n}\n"                                              \
        : DOPS                                                            \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));  \
  }

// The same with B K-major (trans-b 0).
#define PT_WGMMA_RS_K(T, TY, N, DREGS, DOPS, A0, A1, A2, A3, IB, IS)      \
  template <>                                                             \
  __device__ __forceinline__ void mma_rs_k<T, N>(                         \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t b, int acc) {     \
    asm volatile(                                                         \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                 \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "   \
        DREGS ", {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #IB         \
        ", p, 1, 1, 0;\n}\n"                                              \
        : DOPS                                                            \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));  \
  }

PT_WGMMA_SS(__nv_bfloat16, "bf16", 32, PT_R16, PT_D16, 16, 17, 18)
PT_WGMMA_SS(__nv_bfloat16, "bf16", 64, PT_R32, PT_D32, 32, 33, 34)
PT_WGMMA_SS(__nv_bfloat16, "bf16", 128, PT_R64, PT_D64, 64, 65, 66)
PT_WGMMA_SS(__half, "f16", 32, PT_R16, PT_D16, 16, 17, 18)
PT_WGMMA_SS(__half, "f16", 64, PT_R32, PT_D32, 32, 33, 34)
PT_WGMMA_SS(__half, "f16", 128, PT_R64, PT_D64, 64, 65, 66)
PT_WGMMA_SS_MN(__nv_bfloat16, "bf16", 64, PT_R32, PT_D32, 32, 33, 34)
PT_WGMMA_SS_MN(__nv_bfloat16, "bf16", 128, PT_R64, PT_D64, 64, 65, 66)
PT_WGMMA_SS_MN(__half, "f16", 128, PT_R64, PT_D64, 64, 65, 66)
PT_WGMMA_RS(__nv_bfloat16, "bf16", 64, PT_R32, PT_D32, 32, 33, 34, 35, 36, 37)
PT_WGMMA_RS(__nv_bfloat16, "bf16", 128, PT_R64, PT_D64, 64, 65, 66, 67, 68,
            69)
PT_WGMMA_RS(__half, "f16", 64, PT_R32, PT_D32, 32, 33, 34, 35, 36, 37)
PT_WGMMA_RS(__half, "f16", 128, PT_R64, PT_D64, 64, 65, 66, 67, 68, 69)
PT_WGMMA_RS_K(__nv_bfloat16, "bf16", 8, PT_R4, PT_D4, 4, 5, 6, 7, 8, 9)
PT_WGMMA_RS_K(__nv_bfloat16, "bf16", 64, PT_R32, PT_D32, 32, 33, 34, 35, 36,
              37)
PT_WGMMA_RS_K(__nv_bfloat16, "bf16", 128, PT_R64, PT_D64, 64, 65, 66, 67, 68,
              69)
PT_WGMMA_RS_K(__half, "f16", 8, PT_R4, PT_D4, 4, 5, 6, 7, 8, 9)
PT_WGMMA_RS_K(__half, "f16", 64, PT_R32, PT_D32, 32, 33, 34, 35, 36, 37)
PT_WGMMA_RS_K(__half, "f16", 128, PT_R64, PT_D64, 64, 65, 66, 67, 68, 69)

#undef PT_WGMMA_RS_K
#undef PT_WGMMA_RS
#undef PT_WGMMA_SS_MN
#undef PT_WGMMA_SS
#undef PT_R64
#undef PT_R32
#undef PT_R16
#undef PT_R4
#undef PT_D64
#undef PT_D32
#undef PT_D16
#undef PT_D4
#undef PT_D8

}  // namespace sm90
