// Tensor-core building blocks shared by the bf16/fp16 flash kernels
// (flash_fwd.cu, flash_bwd.cu, blocksparse_fwd.cu), the int8 matmul and
// paged decode: asynchronous 16-, 8- and 4-byte copies into shared
// memory, ldmatrix fragment loads and the m16n8k16 product, and the tile
// constants by head dim.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major, 4 registers of 2 elements:
//     a0 (row g, cols 2t..2t+1), a1 (row g+8, cols 2t..), a2 (row g,
//     cols 2t+8..), a3 (row g+8, cols 2t+8..);
//   B 16x8 (k x n), 2 registers: b0 (k 2t..2t+1, col g), b1 (k 2t+8.., g);
//   C 16x8 fp32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, the same).
// The C layout of two neighbouring n8 tiles is the A layout of one k16
// slice, so a score tile becomes the next product's A operand in
// registers (pack2 of c0/c1 and c2/c3 of each tile).
//
// Shared tiles are row-major with a row pitch of the tile width + 8
// elements: the 16 bytes of padding put the eight 16-byte rows one
// ldmatrix phase reads in eight different bank quads (at tile widths 32,
// 64, 80, 96 and 128 alike), so the loads are free of bank conflicts.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace flash_mma {

constexpr int PAD = 8;   // elements of padding per shared row

// The tile width of a head dim D on the tensor cores: the next multiple of
// 16, the k side of m16n8k16 in Q K^T. The columns past D are zero-filled
// on the load (cp.async with a source size of 0, nothing read) and never
// stored; at D = 64 and 128 the tile is D and no predicate is compiled.
__host__ __device__ constexpr int tile_width(int D) { return (D + 15) / 16 * 16; }

// The attention libraries are built once per width D (-DDS_HEAD_DIM=D).
// Built as they are, their kernels take head dim D, every column
// predicate resolved at compile time. Built with -DDS_RUNTIME_D, they take
// any head dim d <= D that is a multiple of 8, given at run time: the
// columns d .. of a tile are zero-filled on the load as those past D are
// in a tile wider than D, and never stored, so that a head dim between
// two built widths runs in the wider one with no padded copy of q, k, v
// or the pools.
#ifdef DS_RUNTIME_D
constexpr bool RUNTIME_D = true;
#else
constexpr bool RUNTIME_D = false;
#endif

// The flash kernels' ring modes (flash_fwd.cu, flash_bwd.cu): a library
// built with -DDS_RING runs its q rows at an offset after the keys, with
// the keys' segment ids of their own and, in the backward, fp32
// gradients; without it those are compile-time constants (offset 0, the
// q rows' ids, the input dtype) and the kernels' code is unchanged.
#ifdef DS_RING
constexpr bool RING_MODES = true;
#else
constexpr bool RING_MODES = false;
#endif

// the head dim a kernel of width D runs: D, or the caller's d
template <int D>
__host__ __device__ __forceinline__ int true_dim(int d) { return RUNTIME_D ? d : D; }

// whether column c (of a row of DP columns, DP >= D) is one of the true
// head dim dh's; at compile time where DP == D and dh is D
template <int D, int DP>
__device__ __forceinline__ bool in_dim(int c, int dh) { return (DP == D && !RUNTIME_D) || c < dh; }

// whether this build takes a head dim of d
template <int D>
constexpr bool takes_head_dim(int d) { return RUNTIME_D ? d > 0 && d <= D && d % 8 == 0 : d == D; }

// Registers a thread's fragments may take when an SM keeps `ctas` CTAs of
// 128 threads, at a tile width of `tile` columns: the launch bounds' cap
// (65536 registers over the threads, in the allocator's units of 8, at
// most 255) less what addresses, loop indices and the softmax state take,
// 64 at a width of 64 and a quarter register more per column beyond (the
// 96-wide forward spilled 80 bytes at three CTAs with 64 set aside).
__host__ __device__ constexpr int fragment_budget(int ctas, int tile) {
  return (65536 / (128 * ctas) / 8 * 8 > 255 ? 255 : 65536 / (128 * ctas) / 8 * 8)
      - (64 + (tile - 64) / 4);
}

// shared memory the CTAs of one SM may take together
constexpr int SMEM_PER_SM = 227 * 1024;

// A kernel's keys per tile and CTAs per SM at a tile width of `tile`: the
// first of (4, 3, 2 CTAs) x (64, 32 keys) whose fragments (`frag_base` +
// `frag_halves` x keys / 2 registers a thread) fit fragment_budget and
// whose shared memory (`smem_base` + `smem_per_key` x keys bytes a CTA)
// fits the SM; else 32 keys at one CTA. Widths 64 and 128 come out as
// they were tuned by hand (PERF.md).
struct TileChoice {
  int kt, ctas;
};

__host__ __device__ constexpr TileChoice choose_tiles(int tile, int frag_base, int frag_halves,
                                                      int smem_base, int smem_per_key) {
  for (int ctas = 4; ctas >= 2; --ctas)
    for (int kt = 64; kt >= 32; kt -= 32)
      if (frag_base + frag_halves * kt / 2 <= fragment_budget(ctas, tile)
          && ctas * (smem_base + smem_per_key * kt) <= SMEM_PER_SM)
        return TileChoice{kt, ctas};
  return TileChoice{32, 1};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !pred. src
// must be a valid address either way.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every copy this thread issued has landed (then __syncthreads for the CTA)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// all but this thread's N newest commit groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment of rows r0..r0+15, cols c0..c0+15 of a row-major tile
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* tile, int ld, int r0,
                                       int c0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles from a row-major [n][k] tile (B = tile^T:
// rows n0..n0+15, k columns c0..c0+15): b[0], b[1] for n0..n0+7, b[2],
// b[3] for n0+8..n0+15
template <typename T>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const T* tile, int ld, int n0,
                                          int c0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0
              + ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles from a row-major [k][n] tile (k rows
// k0..k0+15, n columns n0..n0+15), transposed by ldmatrix
template <typename T>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const T* tile, int ld, int k0,
                                          int n0, int lane) {
  ldsm_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0
                    + (lane >> 4) * 8);
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to T and packed, lo in the low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);

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

// the A fragment of k16 slice kk from the C fragments of n8 tiles 2kk and
// 2kk+1, rounded to T
template <typename T>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// 2^x in one MUFU instruction (results below 2^-126 flush to zero)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace flash_mma
