// Weight-only int8 dequant-matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/int8_matmul.py
// `_dq_matmul_kernel`, launched by `int8_matmul`:
//
//   out[m, n] = (sum_k x[m, k] * float(q[k, n])) * scale[n]
//
// x [M, K] float32 or bfloat16, q [K, N] int8, scale [N] float32, out
// [M, N] in x's dtype; the sum is fp32 and the scale is applied once at
// the end. Every matrix is row-major and contiguous; M, N and K may take
// any value (the edges of each tile are masked here). The weight keeps the
// JAX layout: it is not re-laid out for the kernel.
//
// What bounds it on an H100. Serving decode (M = 8 slots, or 1) reads
// each int8 weight once and does 2*M flops with it, far below the 295
// flop/byte ridge: the least time is the weight bytes over 3.35 TB/s (one
// llama-7b layer, 202.4 M weights: 60 us). A prefill chunk (M = 256) does
// 512 flops per weight byte: the least time is the flops over the bf16
// tensor-core rate (105 us for the layer).
//
// What this design does about it. int8 -> bf16 is exact, so the weight is
// widened on chip and multiplied on the tensor cores (fp32 accumulators).
// The widening is integer work: each byte, XORed with 0x80, is placed by
// one byte permute under the exponent of 2^23 and 2^23 + 128 is
// subtracted, and two such floats make one bf16x2 by a second permute
// (their high halves: exact for integers of 8 bits). Every byte of the
// weight is widened once per CTA, four bytes per shared-memory load.
// - Prefill, bf16 x, M > 16 (`i8mm_wg_kernel`): `wgmma` with the product
//   transposed, out^T = W^T x^T, so that the weight is the A operand,
//   widened straight into registers, and x the B operand, read by wgmma
//   from shared memory (128-byte swizzled, K-major) as TMA left it: no
//   bf16 copy of the weight is ever written. A CTA of two consumer
//   warpgroups covers 128 weight columns (64 each, m64) and NTOK = 128 or
//   256 rows of x (every row of a prefill chunk: n256), so each weight
//   tile is read from device memory and widened once per call (M > 256
//   walks row tiles in the fastest grid index, so the CTAs sharing a
//   weight tile run together and re-read it from L2). A producer
//   warpgroup (one lane; its registers handed to the consumers by
//   setmaxnreg) keeps TMA loads of x and of the int8 weight running into a
//   ring of 5 stages of 64 k rows, on `mbarrier`s (a `full` and an `empty`
//   barrier per slot), so no consumer thread spends an instruction on a
//   load. The warpgroups never wait for each other: one widens its next
//   stage while the tensor cores run the other's products. TMA needs
//   16-byte aligned rows and bases (K a multiple of 8, N of 16); other
//   shapes take the decode kernel in row tiles of 16.
// - Decode, bf16 x, M <= 16 (`i8mm_dec_kernel`): `mma.sync` m16n8k16
//   with x's 16 rows as A (ldmatrix) and B widened in registers straight
//   from the int8 stage: the columns of each warp's four n8 tiles are
//   interleaved (column 4g + j of the warp's 32 is lane g's column of
//   tile j), so a lane's B fragments of all four tiles are four 4-byte
//   loads, and its outputs are 8 consecutive columns of a row. A ring of
//   4 stages of 64 x 128 int8 bytes (16-byte cp.async) per CTA, and
//   two to three CTAs per SM, keep 50-75 KB of weight in flight per SM.
//   What bounds them: decode the weight bytes (at ~2 TB/s: the splits'
//   ramp and tail and the reduce launch cost the rest); the prefill
//   kernel the widening and each warpgroup's wait for its own products,
//   below the tensor cores' rate (~450 TFLOP/s at M = 256 on an NVIDIA
//   H100 80GB HBM3 at 700.00 W).
// - The plan (tile widths, K splits) is chosen by the wrapper
//   (`int8_matmul.plan`). K is split only where the output tiles leave SMs
//   idle (decode; attn_out and mlp_out at a prefill chunk, 32 column tiles
//   of 128 for 132 SMs); the splits write fp32 partials that a second
//   kernel sums in split order (no atomics: two launches give the same
//   bits) and scales.
// - float32 x runs on the CUDA cores (`i8mm_f32_kernel`, 4 x 4 outputs per
//   thread from shared memory): TF32 would lose the float32 path's
//   precision.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cuda.h>

#include "flash_mma.cuh"

namespace {

using flash_mma::cp_async16;

constexpr int BK = 64;           // k rows per stage of the bf16 kernels
constexpr int STAGES = 4;        // ring depth of the decode kernel
// decode kernel (bf16 x, M <= 16)
constexpr int DEC_NT = 128;      // 4 warps
constexpr int DEC_BN = 128;      // output columns per CTA, 32 per warp
constexpr int XP = BK + 8;       // bf16 pitch of its x stage
constexpr int WP = DEC_BN + 16;  // byte pitch of its weight stage
// wgmma kernel (bf16 x, M > 16)
constexpr int WG_NT = 384;       // 2 consumer warpgroups, 1 producer warpgroup
// CUDA-core kernel (float32 x)
constexpr int FNT = 128;
constexpr int FBM = 32, FBN = 64, FBK = 32;

struct Params {
  const void* x; const int8_t* q; const float* scale; void* out; float* part;
  int M, N, K;
  int kps;                       // k stages per split
  int splits;
  int vec_x, vec_q;              // 16-byte loads allowed: aligned rows and base
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// byte `sel & 3` of w (w already XORed with 0x80808080) as an exact fp32
__device__ __forceinline__ float widen(uint32_t w, uint32_t sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | sel)) - 8388736.f;
}

// two exact fp32 integers as bf16x2, lo in the low half
__device__ __forceinline__ uint32_t bf16x2_of(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// the k-pairs (row of lo, row of hi) of the four bytes of two weight words
__device__ __forceinline__ void widen_pairs(uint32_t lo, uint32_t hi, uint32_t (&o)[4]) {
  lo ^= 0x80808080u;
  hi ^= 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = bf16x2_of(widen(lo, j), widen(hi, j));
}

// one output element: the scaled sum, or the split's fp32 partial
template <typename T>
__device__ __forceinline__ void put(const Params& p, int z, int m, int n, float acc) {
  if (m >= p.M || n >= p.N) return;
  if (p.splits == 1) {
    static_cast<T*>(p.out)[(long long)m * p.N + n] = from_f<T>(acc * p.scale[n]);
  } else {
    p.part[((long long)z * p.M + m) * p.N + n] = acc;
  }
}

// 16 bytes of x or of the weight into shared memory: cp.async when the
// chunk is whole and aligned (zero-filled, nothing read, past the edges),
// else element by element
__device__ __forceinline__ void x_chunk(const Params& p, void* dst, int m, int k) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  if (p.vec_x) {
    const bool ok = m < p.M && k < p.K;
    cp_async16(dst, ok ? x + (long long)m * p.K + k : x, ok);
  } else {
    __nv_bfloat16* d = static_cast<__nv_bfloat16*>(dst);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      d[e] = (m < p.M && k + e < p.K) ? x[(long long)m * p.K + k + e] : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void w_chunk(const Params& p, void* dst, int k, int n) {
  if (p.vec_q) {
    const bool ok = k < p.K && n < p.N;
    cp_async16(dst, ok ? p.q + (long long)k * p.N + n : p.q, ok);
  } else {
    int8_t* d = static_cast<int8_t*>(dst);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      d[e] = (k < p.K && n + e < p.N) ? p.q[(long long)k * p.N + n + e] : 0;
  }
}

// ---------------------------------------------------------------------------
// decode: bf16 x, M <= 16, mma.sync
// ---------------------------------------------------------------------------

struct DecSmem {
  __nv_bfloat16 x[STAGES][16][XP];
  int8_t w[STAGES][BK][WP];
};

// grid (ceil(N / DEC_BN), splits, ceil(M / 16)); warp w owns columns
// [32 w, 32 w + 32) of the CTA's tile, interleaved over its four n8
// tiles: lane g's column of tile j is 32 w + 4 g + j. More than one row
// tile runs only for shapes the TMA loads of the wgmma kernel cannot take
// (K not a multiple of 8, N not one of 16, or unaligned bases).
__global__ void __launch_bounds__(DEC_NT) i8mm_dec_kernel(const Params p) {
  __shared__ __align__(16) DecSmem sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * DEC_BN, z = blockIdx.y, m0 = blockIdx.z * 16;
  const int ktiles = (p.K + BK - 1) / BK;
  const int kt0 = z * p.kps;
  const int nk = min(kt0 + p.kps, ktiles) - kt0;

  auto load = [&](int i) {                 // stage kt0 + i -> slot i % STAGES
    const int s = i % STAGES, k0 = (kt0 + i) * BK;
    {                                      // x: 16 rows x 8 chunks, one each
      const int row = tid / 8, c = tid % 8;
      x_chunk(p, &sm.x[s][row][c * 8], m0 + row, k0 + c * 8);
    }
#pragma unroll
    for (int j = 0; j < BK * DEC_BN / 16 / DEC_NT; ++j) {
      const int c = tid + j * DEC_NT, row = c / (DEC_BN / 16), col = (c % (DEC_BN / 16)) * 16;
      w_chunk(p, &sm.w[s][row][col], k0 + row, n0 + col);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk) load(i);
    flash_mma::cp_async_commit();
  }
  const int wn = warp * 32;
  for (int i = 0; i < nk; ++i) {
    flash_mma::cp_async_wait_group<STAGES - 2>();
    __syncthreads();                       // stage i landed; slot (i - 1) free
    if (i + STAGES - 1 < nk) load(i + STAGES - 1);
    flash_mma::cp_async_commit();
    const int s = i % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4];
      flash_mma::load_a(a, &sm.x[s][0][0], XP, 0, kk, lane);
      const int8_t* wr = &sm.w[s][kk + 2 * t][wn + 4 * g];
      uint32_t b0[4], b1[4];
      widen_pairs(*reinterpret_cast<const uint32_t*>(wr),
                  *reinterpret_cast<const uint32_t*>(wr + WP), b0);
      widen_pairs(*reinterpret_cast<const uint32_t*>(wr + 8 * WP),
                  *reinterpret_cast<const uint32_t*>(wr + 9 * WP), b1);
#pragma unroll
      for (int j = 0; j < 4; ++j) flash_mma::mma16816<__nv_bfloat16>(acc[j], a, b0[j], b1[j]);
    }
  }

  // lane (g, t): rows g and g + 8, columns n0 + wn + 8 t + e, e < 8 (c0/c2
  // of tile j at e = j, c1/c3 at e = 4 + j)
  const int nb = n0 + wn + 8 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + g + 8 * h;
    if (m >= p.M) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[j][2 * h];
      v[4 + j] = acc[j][2 * h + 1];
    }
    if (p.splits == 1) {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + (long long)m * p.N;
      if (nb + 8 <= p.N && p.N % 8 == 0) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = flash_mma::pack2<__nv_bfloat16>(v[2 * e] * p.scale[nb + 2 * e],
                                                 v[2 * e + 1] * p.scale[nb + 2 * e + 1]);
        *reinterpret_cast<uint4*>(out + nb) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) put<__nv_bfloat16>(p, z, m, nb + e, v[e]);
      }
    } else {
      float* part = p.part + ((long long)z * p.M + m) * p.N;
      if (nb + 8 <= p.N && p.N % 4 == 0) {
        *reinterpret_cast<float4*>(part + nb) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(part + nb + 4) = make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) put<__nv_bfloat16>(p, z, m, nb + e, v[e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// prefill: bf16 x, M > 16, wgmma
// ---------------------------------------------------------------------------

template <int N> struct WgmmaRS;

template <> struct WgmmaRS<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct WgmmaRS<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// descriptor of a K-major tile of 64-element (128-byte) rows, 128-byte
// swizzled (16-byte chunk c of row r stored at chunk c ^ (r % 8)), 8-row
// groups 1024 bytes apart; `addr` 1024-byte aligned plus the k offset
__device__ __forceinline__ uint64_t sw128_desc(const void* addr) {
  const uint64_t a = flash_mma::smem_addr(addr);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// mbarrier and TMA (cp.async.bulk.tensor) helpers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(flash_mma::smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(flash_mma::smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(flash_mma::smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(flash_mma::smem_addr(bar)), "r"(parity) : "memory");
}
// a 2-D box of `map` at (c0 inner, c1 outer) into shared memory; the
// bytes land on `bar`'s transaction count (out-of-range elements are 0)
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(flash_mma::smem_addr(dst)), "l"(map), "r"(c0), "r"(c1),
         "r"(flash_mma::smem_addr(bar)) : "memory");
}

constexpr int WG_BN = 128;       // weight columns per CTA, 64 per warpgroup
constexpr int WG_STAGES = 5;

template <int NTOK>
struct WgGeom {
  static constexpr int XS = NTOK * 128;        // bytes of an x stage (NTOK x 64 bf16)
  static constexpr int WS = BK * WG_BN;        // bytes of an int8 stage (64 x 128)
  static constexpr int SMEM = WG_STAGES * (XS + WS) + 2 * WG_STAGES * 8 + 1024;
};

// The product is computed transposed, out^T = W^T x^T: the weight is
// wgmma's A operand, widened straight into registers, and x its B
// operand, read by wgmma from shared memory as TMA left it. A warpgroup's
// m64 is 64 weight columns; its n is NTOK (128 or 256) rows of x.
//
// grid (ceil(M / NTOK), ceil(N / 128), splits): rows of x in the fastest
// index, so the CTAs of one weight tile run together. Warps 0-7 are two
// consumer warpgroups, warpgroup wg owning columns [64 wg, 64 wg + 64) of
// the CTA's 128 (232 registers a thread, by setmaxnreg); warpgroup 2 is
// the producer (40 registers), one lane of which keeps TMA
// loads of x (NTOK x 64) and of the weight (64 x 128 bytes), both
// 128-byte swizzled, running into a ring of WG_STAGES slots, each slot
// with a `full` barrier (its bytes landed) and an `empty` one (both
// warpgroups are done with it).
//
// A operand, m16 block w of warpgroup wg: its rows g and g + 8 (lane g =
// lane / 4, t = lane % 4) are the weight columns c and c + 1, c = 64 wg +
// 16 w + 2 g, so the four k rows of a fragment (2t, 2t + 1, 2t + 8, 2t + 9
// of the k16 step) are four 2-byte loads, free of bank conflicts under the
// swizzle. A warpgroup waits for its own products of a stage before it
// releases the slot and widens the next stage into the same registers;
// the two warpgroups never wait for each other, so one widens while the
// tensor cores run the other's products. (Keeping a stage's products in
// flight across the widening, with two sets of A registers, made ptxas
// serialize every wgmma and was slower on an NVIDIA H100 80GB HBM3 at
// 700.00 W.)
template <int NTOK>
__global__ void __launch_bounds__(WG_NT, 1)
    i8mm_wg_kernel(const Params p, const __grid_constant__ CUtensorMap tmx,
                   const __grid_constant__ CUtensorMap tmw) {
  using G = WgGeom<NTOK>;
  constexpr int NACC = NTOK / 2;               // fp32 per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xs = base;                              // [STAGES][NTOK][128 B]
  unsigned char* ws = xs + WG_STAGES * G::XS;            // [STAGES][64][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + WG_STAGES * G::WS);
  uint64_t* empty = full + WG_STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * NTOK, n0 = blockIdx.y * WG_BN, z = blockIdx.z;
  const int ktiles = (p.K + BK - 1) / BK;
  const int kt0 = z * p.kps;
  const int nk = min(kt0 + p.kps, ktiles) - kt0;

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {                               // the producer warpgroup: one lane
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % WG_STAGES, k0 = (kt0 + i) * BK;
        if (i >= WG_STAGES) mbar_wait(&empty[s], (i / WG_STAGES - 1) & 1);
        mbar_expect_tx(&full[s], G::XS + G::WS);
        tma_2d(xs + s * G::XS, &tmx, k0, m0, &full[s]);
        tma_2d(ws + s * G::WS, &tmw, n0, k0, &full[s]);
      }
    }
    return;
  }
  // the consumers take the registers the producer gave back
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int wtid = tid % 128, wq = wtid / 32, lane = wtid % 32;
  const int g = lane / 4, t = lane % 4;
  const int chunk = 4 * wg + wq;               // 16-byte chunk of this warp's columns
  // A fragments of the four k16 steps of stage i, widened from its slot
  auto widen_a = [&](int i, uint32_t (&a)[4][4]) {
    const unsigned char* w = ws + (i % WG_STAGES) * G::WS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {            // k rows 2t, 2t + 1 (+ 8 h)
        const int k = 16 * kk + 2 * t + 8 * h;
        const uint32_t lo = *reinterpret_cast<const uint16_t*>(
            w + k * 128 + ((chunk ^ (k & 7)) << 4) + 2 * g);
        const uint32_t hi = *reinterpret_cast<const uint16_t*>(
            w + (k + 1) * 128 + ((chunk ^ ((k + 1) & 7)) << 4) + 2 * g);
        // bytes: column c at k, c + 1 at k, c at k + 1, c + 1 at k + 1
        const uint32_t q4 = (lo | (hi << 16)) ^ 0x80808080u;
        a[kk][2 * h] = bf16x2_of(widen(q4, 0), widen(q4, 2));       // row g
        a[kk][2 * h + 1] = bf16x2_of(widen(q4, 1), widen(q4, 3));   // row g + 8
      }
    }
  };

  float acc[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = 0.f;
  uint32_t a[4][4];
  if (nk > 0) {
    mbar_wait(&full[0], 0);
    widen_a(0, a);
  }
  for (int i = 0; i < nk; ++i) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaRS<NTOK>::mma(acc, a[kk], sw128_desc(xs + (i % WG_STAGES) * G::XS + kk * 32));
    wg_commit();
    wg_wait<0>();
    mbar_arrive(&empty[i % WG_STAGES]);
    if (i + 1 < nk) {
      mbar_wait(&full[(i + 1) % WG_STAGES], ((i + 1) / WG_STAGES) & 1);
      widen_a(i + 1, a);
    }
  }
#pragma unroll
  for (int e = 0; e < NACC; ++e) fence_reg(acc[e]);

  // accumulator e: A row 16 wq + g (+ 8 for e % 4 >= 2), that is weight
  // column n (n + 1), and x row 8 (e / 4) + 2 t + (e % 2)
  const int n = n0 + 64 * wg + 16 * wq + 2 * g;
  const float s0 = n < p.N ? p.scale[n] : 0.f, s1 = n + 1 < p.N ? p.scale[n + 1] : 0.f;
#pragma unroll
  for (int j = 0; j < NTOK / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = m0 + 8 * j + 2 * t + c;
      if (m >= p.M) continue;
      const float v0 = acc[4 * j + c], v1 = acc[4 * j + 2 + c];
      if (n + 1 < p.N && p.N % 2 == 0) {
        if (p.splits == 1) {
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.out) +
                                       (long long)m * p.N + n) =
              flash_mma::pack2<__nv_bfloat16>(v0 * s0, v1 * s1);
        } else {
          *reinterpret_cast<float2*>(p.part + ((long long)z * p.M + m) * p.N + n) =
              make_float2(v0, v1);
        }
      } else {
        put<__nv_bfloat16>(p, z, m, n, v0);
        put<__nv_bfloat16>(p, z, m, n + 1, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 x: CUDA cores
// ---------------------------------------------------------------------------

// grid (ceil(N / FBN), ceil(M / FBM), splits); thread (ty, tx) of 8 x 16
// owns rows ty + 8 i and columns tx + 16 j, i, j < 4
__global__ void __launch_bounds__(FNT) i8mm_f32_kernel(const Params p) {
  __shared__ float xs[FBK][FBM + 1];           // transposed: row r of x is column r
  __shared__ float ws[FBK][FBN];
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * FBN, m0 = blockIdx.y * FBM, z = blockIdx.z;
  const int ktiles = (p.K + FBK - 1) / FBK;
  const int kt0 = z * p.kps;
  const int kt1 = min(kt0 + p.kps, ktiles);
  float acc[4][4] = {};
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * FBK;
    for (int e = tid; e < FBM * FBK; e += FNT) {
      const int r = e / FBK, kk = e % FBK, m = m0 + r, k = k0 + kk;
      xs[kk][r] = (m < p.M && k < p.K) ? x[(long long)m * p.K + k] : 0.f;
    }
    for (int e = tid; e < FBK * FBN; e += FNT) {
      const int kk = e / FBN, c = e % FBN, k = k0 + kk, n = n0 + c;
      ws[kk][c] = (k < p.K && n < p.N) ? (float)p.q[(long long)k * p.N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 8 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      put<float>(p, z, m0 + ty + 8 * i, n0 + tx + 16 * j, acc[i][j]);
}

// out[m, n] = (sum over splits, in order, of part[s, m, n]) * scale[n]
template <typename T>
__global__ void __launch_bounds__(256) i8mm_reduce_kernel(const Params p) {
  const long long total = (long long)p.M * p.N;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += (long long)gridDim.x * 256) {
    float s = 0.f;
    for (int z = 0; z < p.splits; ++z) s += p.part[z * total + i];
    static_cast<T*>(p.out)[i] = from_f<T>(s * p.scale[i % p.N]);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a row-major [rows, cols] matrix of `esz`-byte elements as boxes of
// box_rows x box_cols
bool tensor_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int esz, int rows,
                int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esz};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NTOK>
cudaError_t launch_wg(const Params& p, cudaStream_t s) {
  using G = WgGeom<NTOK>;
  static cudaError_t set = cudaFuncSetAttribute(
      i8mm_wg_kernel<NTOK>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (set != cudaSuccess) return set;
  CUtensorMap tmx, tmw;
  if (!tensor_map(&tmx, p.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.M, p.K, NTOK, BK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tmw, p.q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.K, p.N, BK, WG_BN,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const dim3 grid((p.M + NTOK - 1) / NTOK, (p.N + WG_BN - 1) / WG_BN, p.splits);
  i8mm_wg_kernel<NTOK><<<grid, WG_NT, G::SMEM, s>>>(p, tmx, tmw);
  return cudaGetLastError();
}

}  // namespace

// The plan comes from the wrapper (`int8_matmul.plan`): kernel 0 =
// float32 x on the CUDA cores (tiles FBM x FBN, FBK k rows per stage), 1 =
// bf16 x at M <= 16 (`mma.sync`, 128 columns per CTA), 2 = bf16 x at M > 16
// (`wgmma`, bn = 64, 96 or 128 columns and mw * 128 rows per CTA); kps k
// stages per split, splits > 1 with fp32 scratch `part` of splits * M * N.
// Returns the CUDA error of the launches (0 on success).
extern "C" int ds_int8_matmul(const void* x, const void* q, const void* scale, void* out,
                              void* part, int kernel, int M, int N, int K, int bn, int mw,
                              int kps, int splits, int vec_x, int vec_q, void* stream) {
  Params p{x, static_cast<const int8_t*>(q), static_cast<const float*>(scale), out,
           static_cast<float*>(part), M, N, K, kps, splits, vec_x, vec_q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (kernel == 0) {
    i8mm_f32_kernel<<<dim3((N + FBN - 1) / FBN, (M + FBM - 1) / FBM, splits), FNT, 0, s>>>(p);
    err = cudaGetLastError();
  } else if (kernel == 1) {
    i8mm_dec_kernel<<<dim3((N + DEC_BN - 1) / DEC_BN, splits, (M + 15) / 16), DEC_NT, 0, s>>>(p);
    err = cudaGetLastError();
  } else if (kernel == 2 && bn == WG_BN && mw == 1) {
    err = launch_wg<128>(p, s);
  } else if (kernel == 2 && bn == WG_BN && mw == 2) {
    err = launch_wg<256>(p, s);
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  if (kernel == 0) {
    i8mm_reduce_kernel<float><<<blocks, 256, 0, s>>>(p);
  } else {
    i8mm_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(p);
  }
  return cudaGetLastError();
}
