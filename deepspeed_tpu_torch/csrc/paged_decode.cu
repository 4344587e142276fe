// Paged flash-decode (and speculative verify) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/attention/paged.py
// `_paged_decode_kernel`, launched by `_paged_attention_call`: each serving
// slot's queries attend THROUGH its block table, reading only the pool
// blocks that hold its cache, with an online softmax. q_len == 1 is
// decode; q_len > 1 is the verify chunk, where chunk row c is causal at
// position lengths[b] + c.
//
// What bounds it on an H100: the bytes. Every occupied K and V row is read
// once, plus q and out, and the arithmetic is ~4 flops per K/V element, far
// below the 295 flop/byte ridge; so the least time is those bytes over
// 3.35 TB/s (the llama-7b decode step's layer, 8 slots of lengths 5-2047,
// 32 heads of 128 in bf16: 113 MB, 34 us).
//
// What this design does about it (the decode mode, and float32 q in
// both modes; the verify mode in bf16 and fp16 is described below).
// - Work is cut by the cache that exists. A slot's positions [lo, hi] (lo:
//   the first row's window band, hi: lengths[b] + q_len - 1, capped at the
//   table) are cut into units of 16 consecutive positions. A CTA (slot,
//   kv head, split) takes `chunk` consecutive units and finds them from
//   lengths[b] on the device: no host read of the lengths, no sync. A CTA
//   whose split lies past its slot's work returns at once, and no position
//   outside [lo, hi] is ever read (trash block 0, stale table entries).
//   `chunk` comes from the wrapper's plan (`paged.plan`), sized so that
//   full tables give a few waves over the SMs.
// - Bytes in flight. Each of the 4 warps takes every 4th unit of its CTA
//   and owns a ring of 3 units in shared memory, filled by 16-byte
//   cp.async (a token's K or V row of one head is Dh * size bytes: 16
//   lanes in bf16 at Dh = 128), so two units are in flight while it
//   computes the third. Warps sync only among their own lanes; there is no
//   __syncthreads per block. Ring rows are padded by 16 bytes, so the 16
//   lanes that read 16 tokens' rows at one offset hit distinct bank quads.
// - Warps work independently. Scores: lane (t, half) takes token t of the
//   unit; with one query row (decode at group 1) the halves split Dh and
//   add by a shuffle, with R rows (GQA group x verify q_len) they take
//   alternate rows, so each K load serves every row. q waits in shared
//   memory in fp32. The softmax is spread over the lanes: each row's max
//   and sum over the unit by shuffles, p to shared memory (rounded to V's
//   type in the float modes), each row's (max, sum) in registers in every
//   lane. PV: a lane owns Dh / 32 columns of every row, acc[R][Dh / 32] in
//   registers (a row capacity of 1, 4 or 16; more rows run in passes of
//   16, one grid index each). The warps merge once, at the CTA's end,
//   through shared memory, in warp order.
// - A slot whose work fits one split is written by its CTA directly; the
//   others write partial (max, sum, accumulator) in fp32, and a second
//   kernel merges exactly the splits that hold work, in split order (two
//   launches give the same bits), one output element a thread.
//
// Layout: q and out [B, q_len, Hkv, group, Dh] contiguous (the wrapper
// views decode's [B, Hkv, group, Dh] with q_len = 1), pools [N, bs, Hkv,
// Dh] contiguous (one layer's slice of the [L, N, ...] pool), tables [B,
// NB] int32, lengths [B] int32; fp32 scratch part_acc [B, Hkv, nsplit, R,
// Dh] and part_ml [B, Hkv, nsplit, 2, R] with R = group * q_len. Masked
// scores take -1e30, as on the TPU, and a zero softmax sum gives an
// output of 0.
//
// int8-pool mode (the TPU kernel's `quant=True`): the pools hold int8 and
// k_scale / v_scale [N, Hkv] fp32 hold one scale per (block, kv head),
// read through the same table entry as the block. Each K and V element is
// widened to fp32 and multiplied by its block's scale right after the
// load from shared memory (the TPU kernel's in-register dequant), so the
// bytes read are the int8 payload plus one scale per token row and head:
// about half of the bf16 mode's. q is widened to fp32 as in the float
// modes, and p is not rounded: the dequantized V is fp32, so the TPU
// kernel's `p.astype(vh.dtype)` keeps p in fp32.
//
// float16, decode and verify: over float pools the bf16 mode's code with
// __half rows, widened to fp32 on the load from shared memory, every sum
// in fp32, p rounded to fp16 before PV as the float modes round it to V's
// type, the output rounded to fp16 once; over int8 pools the int8 mode's
// code with a float16 q (the TPU kernel dequantizes a block to q's dtype),
// on the tensor cores in verify as below with the codes exact in fp16.
//
// Head dims: one library per width of _build.HEAD_DIMS (32, 64, 72, 96,
// 128), built with -DDS_HEAD_DIM, and for the multiples of 8 between them
// a second build of the next width with -DDS_RUNTIME_D, which takes its
// head dim at run time (flash_mma::true_dim). A kernel runs D in a row of
// DP columns in the ring and in shared memory: the CUDA-core design and
// the int8 tensor-core one in groups of 32 (72 in 96: a lane's DP / 32
// output columns, the int8 fragments' 32-dim blocks), the float
// tensor-core one in tile_width(D) (72 in 80). The columns past the head
// dim are zero-filled on the copy (cp.async with a source size of 0:
// nothing read), computed on and never stored. A pool row is copied in
// 16-byte pieces, or in 8-byte ones where its bytes are not a multiple of
// 16 (int8 at 72, and int8 at a run-time head dim). At 64 and 128 DP is D
// and no predicate is compiled.
//
// The verify mode in bf16 and fp16: `paged_verify_mma_kernel`, on the
// tensor cores. The CUDA-core design above spends its time on
// instructions there, not bytes: R = 5 rows ran in the 16-row tier, every
// score an fp32 dot product on the CUDA cores, and more than 16 rows in
// passes that re-read the cache. The tensor-core tier keeps the unit
// walk, the per-warp cp.async ring (its pitch of D + 8 elements is
// flash_mma's, so ldmatrix reads are conflict-free), the splits and the
// combine, and per unit of 16 positions and warp computes S [16 MT x 16]
// = Q K^T with mma.sync m16n8k16 (Q's rows once in shared memory, rows
// past R zero, read by ldmatrix; each K fragment shared by the MT m16
// tiles), masks each (row, position) by the row's qpos = lengths[b] + row
// % q_len and the window, runs the online softmax on the C fragments in
// the log2 domain (a row's max and sum over its quad of lanes; the
// accumulators rescaled only when some row's max moved), packs P to q's
// type in registers (the TPU kernel's p.astype(v.dtype)) and adds P V
// with V by ldmatrix.trans into D / 8 n8 tiles of fp32 a lane per m16
// tile. All R rows of a (slot, kv head) share one CTA up to 16 MT rows
// (MT up to 2 at head dim 128 and 4 at 64: the accumulators take R * D /
// 32 registers a lane); more rows run in passes. q's rows are loaded with
// every 16-byte load issued before the first store, and a unit's table
// entries are read one unit ahead of its copies.
//
// int8 pools with a bf16 or fp16 q on the tensor cores: an int8 code is
// exact in bf16 and fp16 (|x| <= 128), so the products take the codes
// themselves; K's scale
// per (block, head) factors out of the dot product onto the score column
// (s[r, t] = ksc[t] * sum_d q k), and V's scale is folded into P before P
// is packed to bf16 (P[r, t] * vsc[t]), so the bf16 rounding falls on
// P * vsc where the float modes round P. The ring holds the int8 rows;
// the B fragments are built by hand, with no staging tile: Q's columns
// are permuted within each k16 block (qcol_int8) so that a lane's K
// fragment of a k16 step is one 32-bit word of its token's row, and the
// output dims within each 32 are permuted so that a lane's V fragments
// of four n8 tiles come from one word of each of four tokens; a byte
// permute and a float add turn a code into an exact fp32, whose upper
// half is its bf16 (two of which one cvt packs to fp16).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "flash_mma.cuh"

namespace {

using flash_mma::cp_async16;
using flash_mma::cp_async8;
using flash_mma::cp_async4;
using flash_mma::in_dim;
using flash_mma::tile_width;
using flash_mma::true_dim;

constexpr int NT = 128;       // 4 warps
constexpr int NWARP = NT / 32;
constexpr int TT = 16;        // cache positions per unit
constexpr int NSTAGE = 3;     // units in each warp's ring
constexpr int RMAX = 16;      // rows of one pass
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q; const void* k_pool; const void* v_pool;
  const float* k_scale; const float* v_scale;    // int8 mode only
  const int* tables; const int* lengths; void* out;
  float* part_acc; float* part_ml;
  int q_len, Hkv, group, bs, NB, chunk, nsplit, npass;
  float scale;
  int window;
  int d;   // the head dim (flash_mma::true_dim): D, or d <= D with DS_RUNTIME_D
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// the columns of a row in the ring and in shared memory: the CUDA-core
// design's lanes own DP / 32 of them
template <int D> __host__ __device__ constexpr int fma_width() { return (D + 31) / 32 * 32; }
// the tensor-core design's: tile_width(D) over float pools; over int8
// pools multiples of 32, the blocks of the permuted V fragments
template <typename TK, int D> __host__ __device__ constexpr int mma_width() {
  return std::is_same<TK, int8_t>::value ? fma_width<D>() : tile_width(D);
}

// two fp16 packed in a 32-bit word (the lower half first), widened
__device__ __forceinline__ float2 half2_f(uint32_t w) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}

// the first and last cache position any row of slot b attends, and the
// number of splits that hold work (at least 1: an empty range still
// writes its rows); `paged.slot_ranges` is the host's copy of this
// arithmetic
struct Work {
  int pos, lo, hi, ulo, nunits, ns;
};

__device__ __forceinline__ Work work_of(const Params& p, int b) {
  Work w;
  w.pos = p.lengths[b];
  w.hi = min(w.pos + p.q_len - 1, p.NB * p.bs - 1);
  w.lo = p.window > 0 ? max(w.pos - p.window + 1, 0) : 0;
  w.ulo = w.lo / TT;
  w.nunits = w.hi >= w.lo ? w.hi / TT - w.ulo + 1 : 0;
  w.ns = max(1, (w.nunits + p.chunk - 1) / p.chunk);
  return w;
}

// n floats of one 16-byte chunk of a K or V row in shared memory
template <typename TK> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void get(const void* s, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void get(const void* s, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(s);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 -> fp32 is a 16-bit shift
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Chunk<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void get(const void* s, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(s);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = half2_f(w[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};
template <> struct Chunk<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void get(const void* s, float* f) {
    const int4 v = *reinterpret_cast<const int4*>(s);
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f[4 * i + j] = (float)(int8_t)(w[i] >> (8 * j));
  }
};

// E consecutive elements of a V row (E = Dh / 32: 2 or 4), widened
template <typename TK, int E>
__device__ __forceinline__ void load_cols(const TK* s, float* f) {
  if constexpr (std::is_same<TK, float>::value) {
    if constexpr (E == 4) {
      const float4 v = *reinterpret_cast<const float4*>(s);
      f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(s);
      f[0] = v.x; f[1] = v.y;
    }
  } else if constexpr (std::is_same<TK, __nv_bfloat16>::value) {
    if constexpr (E == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(s);
      f[0] = __uint_as_float(v.x << 16); f[1] = __uint_as_float(v.x & 0xffff0000u);
      f[2] = __uint_as_float(v.y << 16); f[3] = __uint_as_float(v.y & 0xffff0000u);
    } else {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(s);
      f[0] = __uint_as_float(v << 16); f[1] = __uint_as_float(v & 0xffff0000u);
    }
  } else if constexpr (std::is_same<TK, __half>::value) {
    if constexpr (E == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(s);
      const float2 a = half2_f(v.x), b = half2_f(v.y);
      f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
    } else {
      const float2 a = half2_f(*reinterpret_cast<const uint32_t*>(s));
      f[0] = a.x; f[1] = a.y;
    }
  } else {
    if constexpr (E == 4) {
      const int v = *reinterpret_cast<const int*>(s);
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = (float)(int8_t)(v >> (8 * j));
    } else {
      const int v = *reinterpret_cast<const short*>(s);
      f[0] = (float)(int8_t)v; f[1] = (float)(int8_t)(v >> 8);
    }
  }
}

// each warp's ring: NSTAGE units of 16 positions' K and V rows of one head
// (and, with int8 pools, their blocks' two scales per position); a row of
// D elements in the pool takes DP in the ring, zero past D. A run-time
// head dim (a multiple of 8) copies int8 rows by 8 bytes, the others by 16
template <typename TK, int D, int DP>
struct Ring {
  static constexpr bool QUANT = std::is_same<TK, int8_t>::value;
  static constexpr int RB = D * (int)sizeof(TK);          // bytes of a pool row
  static constexpr int PB = DP * (int)sizeof(TK);         // bytes of a ring row
  static constexpr int CB = flash_mma::RUNTIME_D ? (QUANT ? 8 : 16)
                                                 : (RB % 16 == 0 ? 16 : 8);   // bytes of one copy
  static constexpr int CPR = PB / CB;                     // copies per ring row
  static constexpr int C16 = PB / 16;                     // 16-byte chunks of a ring row
  static constexpr int KP = PB + 16;                      // padded pitch in the ring
  static constexpr int UNIT = 2 * TT * KP + (QUANT ? 2 * TT * 4 : 0);   // K, V, scales
  static constexpr int RING = NWARP * NSTAGE * UNIT;
  static_assert(TT * CPR % 32 == 0 && PB % 16 == 0, "a unit's copies split over the lanes");
};

template <typename TK, int D, int RT>
struct Geometry : Ring<TK, D, fma_width<D>()> {
  static constexpr int DP = fma_width<D>();
  using Ring<TK, D, DP>::RING;
  static constexpr int MERGE = NWARP * RT * (DP + 2) * 4;
  static constexpr int SMEM = RT * DP * 4 + NWARP * RT * TT * 4 + (RING > MERGE ? RING : MERGE);
};

// where token t of a unit sits in the pool: its block (from the table)
// and its offset in the block; both 0 outside [lo, hi], where nothing is
// read
struct Token {
  int blk, off;
};

// token t of unit u of slot b, for lanes t and t + 16
__device__ __forceinline__ Token unit_token(const Params& p, const Work& wk, int b, int u,
                                            int lane) {
  const int tp = u * TT + (lane & 15);
  Token k{0, 0};
  if (tp >= wk.lo && tp <= wk.hi) {
    k.blk = p.tables[(long long)b * p.NB + tp / p.bs];
    k.off = tp % p.bs;
  }
  return k;
}

// unit u of slot b, kv head h into a ring slot by cp.async of CB bytes
// (lanes t and t + 16 find token t's row from tok, unit_token's);
// positions outside [lo, hi] and columns past D are zero-filled without a
// read
template <typename TK, int D, int DP>
__device__ __forceinline__ void load_unit(const Params& p, const Work& wk, int b, int h, int u,
                                          Token tok, unsigned char* slot, int lane) {
  using G = Ring<TK, D, DP>;
  const int t = lane & 15, h2 = lane >> 4;
  const char* kpool = static_cast<const char*>(p.k_pool);
  const char* vpool = static_cast<const char*>(p.v_pool);
  const int tp = u * TT + t;
  const bool tv = tp >= wk.lo && tp <= wk.hi;
  const int blk = tok.blk;
  const int rb = true_dim<D>(p.d) * (int)sizeof(TK);   // bytes of a pool row
  // the token's row of this head
  const long long row = tv ? ((long long)blk * p.bs + tok.off) * p.Hkv + h : 0;
#pragma unroll
  for (int i = 0; i < TT * G::CPR / 32; ++i) {
    const int c = lane + 32 * i, tk = c / G::CPR, part = c % G::CPR;
    const long long rk = __shfl_sync(FULL, row, tk);
    // in_dim over bytes: piece `part` of a PB-byte ring row holds bytes of
    // the rb-byte pool row
    const bool ok = __shfl_sync(FULL, (int)tv, tk) != 0
        && in_dim<G::RB, G::PB>(part * G::CB, rb);
    const long long off = ok ? rk * rb + part * G::CB : 0;
    unsigned char* dk = slot + tk * G::KP + part * G::CB;
    if constexpr (G::CB == 16) {
      cp_async16(dk, kpool + off, ok);
      cp_async16(dk + TT * G::KP, vpool + off, ok);
    } else {
      cp_async8(dk, kpool + off, ok);
      cp_async8(dk + TT * G::KP, vpool + off, ok);
    }
  }
  if constexpr (G::QUANT) {
    float* sc = reinterpret_cast<float*>(slot + 2 * TT * G::KP);   // [2][TT]
    const float* src = h2 ? p.v_scale : p.k_scale;
    cp_async4(sc + h2 * TT + t, tv ? src + (long long)blk * p.Hkv + h : src, tv);
  }
}

// the CTA's end: each warp left its (max, sum, accumulator) of rows 0 ..
// RT in shared memory (mM, mL [NWARP][RT], mA [NWARP][RT][DP]); rows r0 ..
// r0 + Rp of the (slot, kv head) are merged in warp order and their head
// dim's columns written to the output when the slot's work is this one
// split, else to the split's partials
template <typename T, int D, int DP, int RT>
__device__ __forceinline__ void merge_warps(const Params& p, const Work& wk, const float* mM,
                                            const float* mL, const float* mA, int b, int h,
                                            int split, int r0, int Rp) {
  const int R = p.group * p.q_len;
  const long long bh = (long long)b * p.Hkv + h;
  const int dh = true_dim<D>(p.d);
  T* __restrict__ out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < Rp * dh; i += NT) {
    const int r = i / dh, d = i % dh, rg = r0 + r;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) M = fmaxf(M, mM[w * RT + r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float a = expf(mM[w * RT + r] - M);
      L = fmaf(a, mL[w * RT + r], L);
      O = fmaf(a, mA[(w * RT + r) * DP + d], O);
    }
    if (wk.ns == 1) {
      const int gm = rg / p.q_len, c = rg % p.q_len;
      out[((((long long)b * p.q_len + c) * p.Hkv + h) * p.group + gm) * dh + d] =
          from_f<T>(O / (L == 0.f ? 1.f : L));
    } else {
      const long long part = bh * p.nsplit + split;
      p.part_acc[(part * R + rg) * dh + d] = O;
      if (d == 0) {
        p.part_ml[part * 2 * R + rg] = M;
        p.part_ml[part * 2 * R + R + rg] = L;
      }
    }
  }
}

// CTAs per SM the split kernel's launch bounds ask for: 0 (none: ptxas
// picks the registers, at most 168 in the 16-row tier) but 1 at head dim
// 96 and 16 rows, where ptxas's choice spilled 4 bytes in bf16 and fp16
// and one CTA's bound gives 206 registers and no spill
template <int D, int RT> __host__ __device__ constexpr int split_min_ctas() {
  return D == 96 && RT == 16 ? 1 : 0;
}

// grid (B, Hkv * npass, nsplit): the partial softmax state of one split
// of one (slot, kv head, pass of <= RMAX rows). T: q and out; TK: the
// pools' element (T, or int8 with per-(block, head) scales); RT: the
// row capacity (>= the pass's rows)
template <typename T, typename TK, int D, int RT>
__global__ void __launch_bounds__(NT, split_min_ctas<D, RT>()) paged_split_kernel(const Params p) {
  using G = Geometry<TK, D, RT>;
  constexpr int DP = G::DP;                  // columns in the ring and sQ
  constexpr bool QUANT = G::QUANT;
  constexpr bool SPLIT_D = RT == 1;          // one row: the halves split Dh
  constexpr int SR = SPLIT_D ? 1 : RT / 2;   // score rows per lane
  constexpr int DL = Chunk<TK>::N;           // elements per 16-byte chunk
  constexpr int NCH = SPLIT_D ? G::C16 / 2 : G::C16;
  constexpr int DV = DP / 32;                // PV columns per lane
  // at DP = 64 and 128 a lane's DV columns are consecutive (one vector
  // load); at 32 and 96 they are lane + 32 e (element loads, neighbouring
  // lanes on neighbouring addresses)
  constexpr bool STRIDED = DV % 2 == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);                  // [RT][DP]
  float* sPall = sQ + RT * DP;                                 // [NWARP][RT][TT]
  unsigned char* ring = reinterpret_cast<unsigned char*>(sPall + NWARP * RT * TT);

  const int b = blockIdx.x, h = blockIdx.y / p.npass, pass = blockIdx.y % p.npass;
  const int split = blockIdx.z;
  const Work wk = work_of(p, b);
  if (split >= wk.ns) return;
  const int R = p.group * p.q_len;
  const int r0 = pass * RMAX;
  const int Rp = min(RMAX, R - r0);          // rows of this pass (<= RT)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t = lane & 15, h2 = lane >> 4;

  // q rows r0 .. r0 + Rp of this kv head, widened, zero past the head dim
  // dh; row r = (group member r / q_len, chunk offset r % q_len)
  const T* __restrict__ q = static_cast<const T*>(p.q);
  const int dh = true_dim<D>(p.d);
  for (int i = tid; i < RT * DP; i += NT) {
    const int r = i / DP, d = i % DP;
    float v = 0.f;
    if (r < Rp && in_dim<D, DP>(d, dh)) {
      const int rg = r0 + r, gm = rg / p.q_len, c = rg % p.q_len;
      v = to_f(q[((((long long)b * p.q_len + c) * p.Hkv + h) * p.group + gm) * dh + d]);
    }
    sQ[i] = v;
  }
  __syncthreads();

  const int u_first = wk.ulo + split * p.chunk;
  const int u_end = min(u_first + p.chunk, wk.ulo + wk.nunits);
  // this warp's units: u_first + warp, + NWARP, ...
  const int nk = u_end - u_first > warp ? (u_end - u_first - warp + NWARP - 1) / NWARP : 0;
  unsigned char* wring = ring + warp * NSTAGE * G::UNIT;
  float* sP = sPall + warp * RT * TT;
  auto fetch = [&](int k) {
    const int u = u_first + warp + k * NWARP;
    load_unit<TK, D, DP>(p, wk, b, h, u, unit_token(p, wk, b, u, lane),
                         wring + (k % NSTAGE) * G::UNIT, lane);
  };

  float m[RT], l[RT], acc[RT][DV];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[r][e] = 0.f;
  }

#pragma unroll
  for (int k = 0; k < NSTAGE - 1; ++k) {
    if (k < nk) fetch(k);
    flash_mma::cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    if (k + NSTAGE - 1 < nk) fetch(k + NSTAGE - 1);
    flash_mma::cp_async_commit();
    flash_mma::cp_async_wait_group<NSTAGE - 1>();
    __syncwarp();
    const unsigned char* slot = wring + (k % NSTAGE) * G::UNIT;
    const unsigned char* sK = slot;
    const TK* sV = reinterpret_cast<const TK*>(slot + TT * G::KP);
    const float* sc = reinterpret_cast<const float*>(slot + 2 * TT * G::KP);
    const int u = u_first + warp + k * NWARP;
    const int col = u * TT + t;
    const bool tv = col >= wk.lo && col <= wk.hi;

    // scores of token t for this lane's rows
    float s[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) s[i] = 0.f;
    const float ksc = QUANT ? sc[t] : 1.f;
    const int ch0 = SPLIT_D ? h2 * NCH : 0;
    auto dot_chunk = [&](int c) {
      float kf[DL];
      Chunk<TK>::get(sK + t * G::KP + (ch0 + c) * 16, kf);
      if constexpr (QUANT) {
#pragma unroll
        for (int e = 0; e < DL; ++e) kf[e] *= ksc;
      }
      const int d0 = (ch0 + c) * DL;
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = SPLIT_D ? 0 : h2 + 2 * i;
        if (r < Rp) {
          const float* qr = sQ + r * DP + d0;
#pragma unroll
          for (int e = 0; e < DL; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            s[i] = fmaf(qv.x, kf[e], s[i]);
            s[i] = fmaf(qv.y, kf[e + 1], s[i]);
            s[i] = fmaf(qv.z, kf[e + 2], s[i]);
            s[i] = fmaf(qv.w, kf[e + 3], s[i]);
          }
        }
      }
    };
    // unrolled up to 4 rows; one chunk at a time for 16 (the registers of
    // 8 rows' partial sums, 16 rows' state and accumulators)
    if constexpr (RT < 16) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) dot_chunk(c);
    } else {
#pragma unroll 1
      for (int c = 0; c < NCH; ++c) dot_chunk(c);
    }
    if constexpr (SPLIT_D) s[0] += __shfl_xor_sync(FULL, s[0], 16);
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int r = SPLIT_D ? 0 : h2 + 2 * i;
      const int qpos = wk.pos + (r0 + r) % p.q_len;
      bool ok = tv && r < Rp && col <= qpos;
      if (p.window > 0) ok = ok && col > qpos - p.window;
      s[i] = ok ? s[i] * p.scale : NEG_INF;
    }

    // each row's max over the unit (16 lanes of a half), then every row's
    // new max in every lane: rows 2i and 2i + 1 live in halves 0 and 1
    float bm[RT];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      float v = s[i];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
      if constexpr (SPLIT_D) {
        bm[0] = v;
      } else {
        const float other = __shfl_xor_sync(FULL, v, 16);
        bm[2 * i] = h2 ? other : v;
        bm[2 * i + 1] = h2 ? v : other;
      }
    }
    // rescale each row's state to its new max
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float mn = fmaxf(m[r], bm[r]);
      const float alpha = expf(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[r][e] *= alpha;
    }
    // p of this lane's rows; rows' sums as the maxes
    float rs[RT];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int r = SPLIT_D ? 0 : h2 + 2 * i;
      const float mr = SPLIT_D ? m[0] : (h2 ? m[2 * i + 1] : m[2 * i]);
      const float e = expf(s[i] - mr);
      if (r < Rp && (!SPLIT_D || h2 == 0)) {
        // V's type in the float modes (the TPU kernel's p.astype(v.dtype))
        if constexpr (QUANT) sP[r * TT + t] = e;
        else sP[r * TT + t] = to_f(from_f<TK>(e));
      }
      float v = e;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
      if constexpr (SPLIT_D) {
        rs[0] = v;
      } else {
        const float other = __shfl_xor_sync(FULL, v, 16);
        rs[2 * i] = h2 ? other : v;
        rs[2 * i + 1] = h2 ? v : other;
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) l[r] += rs[r];
    __syncwarp();

    // PV: this lane's DV columns of every row, four tokens at a time
#pragma unroll
    for (int t4 = 0; t4 < TT; t4 += 4) {
      float vf[4][DV];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const TK* vrow = reinterpret_cast<const TK*>(
            reinterpret_cast<const unsigned char*>(sV) + (t4 + j) * G::KP);
        if constexpr (STRIDED) {
#pragma unroll
          for (int e = 0; e < DV; ++e) vf[j][e] = to_f(vrow[lane + 32 * e]);
        } else {
          load_cols<TK, DV>(vrow + lane * DV, vf[j]);
        }
        if constexpr (QUANT) {
          const float vsc = sc[TT + t4 + j];
#pragma unroll
          for (int e = 0; e < DV; ++e) vf[j][e] *= vsc;
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < Rp) {
          const float4 pr = *reinterpret_cast<const float4*>(sP + r * TT + t4);
#pragma unroll
          for (int e = 0; e < DV; ++e) {
            float a = acc[r][e];
            a = fmaf(pr.x, vf[0][e], a);
            a = fmaf(pr.y, vf[1][e], a);
            a = fmaf(pr.z, vf[2][e], a);
            a = fmaf(pr.w, vf[3][e], a);
            acc[r][e] = a;
          }
        }
      }
    }
    __syncwarp();   // the slot and sP are refilled next
  }

  // merge the warps' states in warp order (the ring is free now)
  flash_mma::cp_async_wait_all();
  __syncthreads();
  float* mM = reinterpret_cast<float*>(ring);       // [NWARP][RT]
  float* mL = mM + NWARP * RT;                      // [NWARP][RT]
  float* mA = mL + NWARP * RT;                      // [NWARP][RT][DP]
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r) { mM[warp * RT + r] = m[r]; mL[warp * RT + r] = l[r]; }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < DV; ++e)
      mA[(warp * RT + r) * DP + (STRIDED ? lane + 32 * e : lane * DV + e)] = acc[r][e];
  __syncthreads();

  merge_warps<T, D, DP, RT>(p, wk, mM, mL, mA, b, h, split, r0, Rp);
}

// ---------------------------------------------------------------------------
// The verify mode (q_len > 1) in bfloat16 and float16: tensor cores
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// int8 byte j of a word already XORed with 0x80808080, as an exact fp32:
// a byte permute builds the float 2^23 + (x + 128), less 2^23 + 128 (j is
// a constant once the loops around a call are unrolled)
__device__ __forceinline__ float i8_at(uint32_t wx, int j) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7650 + j)) - 8388736.f;
}

// the T pair (lo in the low half) of two floats that bf16 and fp16 hold
// exactly (integers of at most 8 bits): their upper halves in bf16, one
// cvt to fp16
template <typename T> __device__ __forceinline__ uint32_t codes2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t codes2<__nv_bfloat16>(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
template <> __device__ __forceinline__ uint32_t codes2<__half>(float lo, float hi) {
  return flash_mma::pack2<__half>(lo, hi);
}

// int8 pools: the column of sQ that q dim d takes. Column j of a k16
// block holds dim 4 t + 2 (j / 8) + j % 2 of the block, t = (j % 8) / 2, so
// that lane (g, t)'s B fragment of a k16 step, k rows 2t, 2t+1 (b0) and
// 2t+8, 2t+9 (b1) of token g, is the one 32-bit word at bytes 4t .. 4t+3
// of the block in the token's ring row
__device__ __forceinline__ int qcol_int8(int d) {
  const int dd = d & 15;
  return (d - dd) + 8 * ((dd >> 1) & 1) + 2 * (dd >> 2) + (dd & 1);
}

// rows of one pass: MT m16 tiles
template <typename T, typename TK, int D, int MT>
struct VerifyGeometry : Ring<TK, D, mma_width<TK, D>()> {
  static constexpr int DP = mma_width<TK, D>();
  using Ring<TK, D, DP>::RING;
  static constexpr int ROWS = 16 * MT;
  static constexpr int LDQ = DP + flash_mma::PAD;         // sQ's pitch, elements
  static constexpr int QBYTES = ROWS * LDQ * (int)sizeof(T);
  static constexpr int MERGE = NWARP * ROWS * (DP + 2) * 4;
  static constexpr int SMEM = QBYTES + (RING > MERGE ? RING : MERGE);
};

// grid (B, Hkv * npass, nsplit), as paged_split_kernel: one split of one
// (slot, kv head, pass of <= 16 * MT rows). T: q, out and the mma operands
// (bf16 or fp16); TK: the pools' element (T, or int8 with per-(block,
// head) scales). Each warp walks its units through the same
// ring; per unit of 16 positions: S [16 MT x 16] = Q K^T on mma.sync
// (every m-tile shares each K fragment), the online softmax on the C
// fragments, P packed to T in registers, O += P V.
template <typename T, typename TK, int D, int MT>
__global__ void __launch_bounds__(NT) paged_verify_mma_kernel(const Params p) {
  using namespace flash_mma;
  using G = VerifyGeometry<T, TK, D, MT>;
  constexpr bool QUANT = G::QUANT;
  constexpr int DP = G::DP;               // columns in the ring and sQ
  constexpr int ROWS = G::ROWS, LDQ = G::LDQ;
  constexpr int LDK = DP + PAD;           // ring pitch in elements (float pools)
  constexpr int KS = DP / 16;             // k16 steps of the scores
  constexpr int DN = DP / 8;              // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);                     // [ROWS][LDQ]
  unsigned char* ring = smem + G::QBYTES;

  const int b = blockIdx.x, h = blockIdx.y / p.npass, pass = blockIdx.y % p.npass;
  const int split = blockIdx.z;
  const Work wk = work_of(p, b);
  if (split >= wk.ns) return;
  const int R = p.group * p.q_len;
  const int r0 = pass * ROWS;
  const int Rp = min(ROWS, R - r0);       // rows of this pass
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  // q rows r0 .. r0 + Rp of this kv head in T, the rest (and the columns
  // past the head dim dh) zero; row r = (group member r / q_len, chunk
  // offset r % q_len). Every 16-byte load is issued before the first
  // store, so the CTA waits for one load's latency, not one per element
  constexpr int QCH = DP / 8;                       // 16-byte chunks of a row
  constexpr int QN = (ROWS * QCH + NT - 1) / NT;    // chunks per thread
  const int dh = true_dim<D>(p.d);
  uint4 qv[QN];
#pragma unroll
  for (int i = 0; i < QN; ++i) {
    const int c = tid + NT * i, r = c / QCH;
    qv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (r < Rp && in_dim<D, DP>((c % QCH) * 8, dh)) {
      const int rg = r0 + r, gm = rg / p.q_len, cq = rg % p.q_len;
      qv[i] = *reinterpret_cast<const uint4*>(
          static_cast<const T*>(p.q)
          + ((((long long)b * p.q_len + cq) * p.Hkv + h) * p.group + gm) * dh + (c % QCH) * 8);
    }
  }

  // each of the lane's rows (mt, hh): row mt*16 + g + 8 hh of the pass sees
  // the positions (qlo, qhi]; a row past R sees none
  int qhi[MT][2], qlo[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = mt * 16 + g + 8 * hh;
      const int qpos = wk.pos + (r0 + r) % p.q_len;
      qhi[mt][hh] = r < Rp ? qpos : -1;
      qlo[mt][hh] = p.window > 0 ? qpos - p.window : -1;
    }
  const float scale2 = p.scale * LOG2E;   // scores in the log2 domain

  const int u_first = wk.ulo + split * p.chunk;
  const int u_end = min(u_first + p.chunk, wk.ulo + wk.nunits);
  const int nk = u_end - u_first > warp ? (u_end - u_first - warp + NWARP - 1) / NWARP : 0;
  unsigned char* wring = ring + warp * NSTAGE * G::UNIT;
  // the table entry of a unit is read one unit before its copies are
  // issued, so a fetch does not wait for it
  auto token_of = [&](int k) {
    return k < nk ? unit_token(p, wk, b, u_first + warp + k * NWARP, lane) : Token{0, 0};
  };
  auto fetch = [&](int k, Token tok) {
    load_unit<TK, D, DP>(p, wk, b, h, u_first + warp + k * NWARP, tok,
                         wring + (k % NSTAGE) * G::UNIT, lane);
  };

  float m[MT][2], l[MT][2], acc[MT][DN][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) { m[mt][hh] = NEG_INF; l[mt][hh] = 0.f; }
#pragma unroll
    for (int n = 0; n < DN; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  }

  Token first[NSTAGE - 1];
#pragma unroll
  for (int k = 0; k < NSTAGE - 1; ++k) first[k] = token_of(k);
  Token next = token_of(NSTAGE - 1);
#pragma unroll
  for (int k = 0; k < NSTAGE - 1; ++k) {
    if (k < nk) fetch(k, first[k]);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < QN; ++i) {
    const int c = tid + NT * i, r = c / QCH, d0 = (c % QCH) * 8;
    if (ROWS * QCH % NT != 0 && c >= ROWS * QCH) break;
    if constexpr (QUANT) {     // element by element to the permuted columns
      const uint32_t w[4] = {qv[i].x, qv[i].y, qv[i].z, qv[i].w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        reinterpret_cast<uint16_t*>(sQ)[r * LDQ + qcol_int8(d0 + e)] =
            (uint16_t)(w[e / 2] >> (16 * (e % 2)));
    } else {
      *reinterpret_cast<uint4*>(sQ + r * LDQ + d0) = qv[i];
    }
  }
  __syncthreads();   // sQ is written
  for (int k = 0; k < nk; ++k) {
    if (k + NSTAGE - 1 < nk) fetch(k + NSTAGE - 1, next);
    cp_async_commit();
    next = token_of(k + NSTAGE);
    cp_async_wait_group<NSTAGE - 1>();
    __syncwarp();
    const unsigned char* slot = wring + (k % NSTAGE) * G::UNIT;
    const unsigned char* sK = slot;
    const unsigned char* sV = slot + TT * G::KP;
    const float* sc = reinterpret_cast<const float*>(slot + 2 * TT * G::KP);
    const int c0 = (u_first + warp + k * NWARP) * TT;   // the unit's first position

    // S = Q K^T: n8 tile j holds tokens 8j .. 8j + 7 of the unit
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t bk[4];
      if constexpr (QUANT) {
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(sK + g * G::KP + kk * 16 + 4 * t4)
                            ^ 0x80808080u;
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(sK + (g + 8) * G::KP + kk * 16
                                                               + 4 * t4) ^ 0x80808080u;
        bk[0] = codes2<T>(i8_at(w0, 0), i8_at(w0, 1));
        bk[1] = codes2<T>(i8_at(w0, 2), i8_at(w0, 3));
        bk[2] = codes2<T>(i8_at(w1, 0), i8_at(w1, 1));
        bk[3] = codes2<T>(i8_at(w1, 2), i8_at(w1, 3));
      } else {
        load_b_nk(bk, reinterpret_cast<const T*>(sK), LDK, 0, kk * 16, lane);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        load_a(a, sQ, LDQ, mt * 16, kk * 16, lane);
        mma16816<T>(s[mt][0], a, bk[0], bk[1]);
        mma16816<T>(s[mt][1], a, bk[2], bk[3]);
      }
    }

    // scale (by K's scale per token with int8 pools) and mask: element e
    // of tile j is row g + 8 (e / 2), token 8j + 2 t4 + e % 2
    float ks[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
    if constexpr (QUANT) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * t4);
        ks[j][0] = v.x;
        ks[j][1] = v.y;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 8 * j + 2 * t4 + (e & 1);
        const bool in = col >= wk.lo && col <= wk.hi;
        const float f = scale2 * ks[j][e & 1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int hh = e >> 1;
          const bool ok = in && col <= qhi[mt][hh] && col > qlo[mt][hh];
          s[mt][j][e] = ok ? s[mt][j][e] * f : NEG_INF;
        }
      }

    // online softmax on the fragments: the quad of lanes sharing g holds
    // one row's 16 scores. Masked scores are -1e30: a row that has seen
    // only masked positions has m = -1e30 and p = 1, wiped by alpha = 0
    // at its first valid position, as in the TPU kernel. The accumulators
    // are rescaled only when some row's max moved (a warp-wide vote)
    float alpha[MT][2];
    bool moved = false;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m[mt][hh];
#pragma unroll
        for (int j = 0; j < 2; ++j) mx = fmaxf(mx, fmaxf(s[mt][j][2 * hh], s[mt][j][2 * hh + 1]));
        mx = quad_max(mx);
        alpha[mt][hh] = exp2_ftz(m[mt][hh] - mx);
        moved = moved || mx != m[mt][hh];
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
            s[mt][j][e] = exp2_ftz(s[mt][j][e] - mx);
            sum += s[mt][j][e];
          }
        l[mt][hh] = alpha[mt][hh] * l[mt][hh] + quad_sum(sum);
        m[mt][hh] = mx;
      }
    if (__any_sync(FULL, moved)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < DN; ++n) {
          acc[mt][n][0] *= alpha[mt][0];
          acc[mt][n][1] *= alpha[mt][0];
          acc[mt][n][2] *= alpha[mt][1];
          acc[mt][n][3] *= alpha[mt][1];
        }
    }

    // P as the A fragment of the unit's one k16 step, rounded to T (the
    // TPU kernel's p.astype(v.dtype)); with int8 pools V's scale per token
    // is folded into P first, so the product takes V's exact codes
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (QUANT) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 v = *reinterpret_cast<const float2*>(sc + TT + 8 * j + 2 * t4);
          s[mt][j][0] *= v.x; s[mt][j][1] *= v.y;
          s[mt][j][2] *= v.x; s[mt][j][3] *= v.y;
        }
      }
      c_to_a<T>(pa[mt], s[mt][0], s[mt][1]);
    }

    // O += P V
    if constexpr (QUANT) {
      // tile 4c + i, column g holds dim 32c + 4g + i: lane (g, t)'s B
      // fragments of four tiles come from one word of each of tokens 2t,
      // 2t+1 (b0) and 2t+8, 2t+9 (b1)
#pragma unroll
      for (int c = 0; c < DP / 32; ++c) {
        uint32_t w[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int tok = 2 * t4 + (x & 1) + 8 * (x >> 1);
          w[x] = *reinterpret_cast<const uint32_t*>(sV + tok * G::KP + 32 * c + 4 * g)
                 ^ 0x80808080u;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t b0 = codes2<T>(i8_at(w[0], i), i8_at(w[1], i));
          const uint32_t b1 = codes2<T>(i8_at(w[2], i), i8_at(w[3], i));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma16816<T>(acc[mt][4 * c + i], pa[mt], b0, b1);
        }
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < DP / 16; ++jj) {
        uint32_t bv[4];
        load_b_kn(bv, reinterpret_cast<const T*>(sV), LDK, 0, jj * 16, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816<T>(acc[mt][2 * jj], pa[mt], bv[0], bv[1]);
          mma16816<T>(acc[mt][2 * jj + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
    __syncwarp();   // the slot is refilled next
  }

  // merge the warps' states in warp order (the ring is free now)
  cp_async_wait_all();
  __syncthreads();
  float* mM = reinterpret_cast<float*>(ring);       // [NWARP][ROWS]
  float* mL = mM + NWARP * ROWS;                    // [NWARP][ROWS]
  float* mA = mL + NWARP * ROWS;                    // [NWARP][ROWS][DP]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * ROWS + mt * 16 + g + 8 * hh;
      // the max back from the log2 domain: merge_warps and the combine
      // weigh by expf
      if (t4 == 0) { mM[r] = m[mt][hh] * (1.f / LOG2E); mL[r] = l[mt][hh]; }
#pragma unroll
      for (int n = 0; n < DN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * t4 + e;    // the C fragment's column in tile n
          const int d = QUANT ? 32 * (n / 4) + 4 * col + n % 4 : 8 * n + col;
          mA[r * DP + d] = acc[mt][n][2 * hh + e];
        }
    }
  __syncthreads();
  merge_warps<T, D, DP, ROWS>(p, wk, mM, mL, mA, b, h, split, r0, Rp);
}

// grid (B, Hkv, R), a thread per column of the head dim dh (<= D): element
// d of row r, out = sum_s w_s acc_s /
// sum_s w_s l_s, w_s = exp(m_s - M), over the splits of slot b that hold
// work, in split order. One element a thread, the split loops unrolled,
// so a thread waits for a few loads' latency, not two per split and row
template <typename T, int D>
__global__ void __launch_bounds__(D) paged_combine_kernel(const Params p) {
  const int b = blockIdx.x, h = blockIdx.y, r = blockIdx.z, d = threadIdx.x;
  const Work wk = work_of(p, b);
  if (wk.ns == 1) return;                  // written by its one split
  const int R = p.group * p.q_len;
  const int dh = true_dim<D>(p.d);
  const long long first = ((long long)b * p.Hkv + h) * p.nsplit;
  const float* __restrict__ ml = p.part_ml + first * 2 * R + r;     // split s: + s * 2R
  const float* __restrict__ acc = p.part_acc + (first * R + r) * dh + d;   // + s * R dh
  float M = NEG_INF;
#pragma unroll 4
  for (int s = 0; s < wk.ns; ++s) M = fmaxf(M, ml[s * 2 * R]);
  float L = 0.f, O = 0.f;
#pragma unroll 4
  for (int s = 0; s < wk.ns; ++s) {
    const float w = expf(ml[s * 2 * R] - M);
    L = fmaf(w, ml[s * 2 * R + R], L);
    O = fmaf(w, acc[(long long)s * R * dh], O);
  }
  const int gm = r / p.q_len, c = r % p.q_len;
  static_cast<T*>(p.out)[((((long long)b * p.q_len + c) * p.Hkv + h) * p.group + gm) * dh + d] =
      from_f<T>(O / (L == 0.f ? 1.f : L));
}

// the split kernel over grid (B, Hkv * npass, nsplit), then the combine
// where a slot's work may take more than one split
template <typename T, int D, typename Kernel>
cudaError_t launch_split(Kernel kernel, int smem, const Params& p, int B, cudaStream_t stream) {
  kernel<<<dim3(B, p.Hkv * p.npass, p.nsplit), NT, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return err;
  paged_combine_kernel<T, D><<<dim3(B, p.Hkv, p.group * p.q_len), true_dim<D>(p.d), 0,
                                stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename TK, int D, int RT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = Geometry<TK, D, RT>::SMEM;
  static cudaError_t set = cudaFuncSetAttribute(
      paged_split_kernel<T, TK, D, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  return launch_split<T, D>(paged_split_kernel<T, TK, D, RT>, smem, p, B, stream);
}

template <typename T, typename TK, int D, int MT>
cudaError_t launch_tiles(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = VerifyGeometry<T, TK, D, MT>::SMEM;
  static cudaError_t set = cudaFuncSetAttribute(
      paged_verify_mma_kernel<T, TK, D, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  return launch_split<T, D>(paged_verify_mma_kernel<T, TK, D, MT>, smem, p, B, stream);
}

// the CUDA-core design: a row capacity rt of 1, 4 or 16 (more rows in
// passes of 16)
template <typename T, typename TK, int D>
cudaError_t launch_fma(const Params& p, int rt, int B, cudaStream_t s) {
  if (rt == 1) return launch<T, TK, D, 1>(p, B, s);
  if (rt == 4) return launch<T, TK, D, 4>(p, B, s);
  if (rt == 16) return launch<T, TK, D, 16>(p, B, s);
  return cudaErrorInvalidValue;
}

// m16 tiles a pass may hold at head dim D: the accumulators of 16 MT rows
// take 16 MT x tile_width(D) / 32 fp32 registers a lane, held at 128 (4 at
// head dims 32 and 64, 2 at 72, 96 and 128: `paged.MMA_TILES`)
template <int D> __host__ __device__ constexpr int mma_max_tiles() {
  return 128 / (16 * tile_width(D) / 32);
}

// the tensor-core design: rt rows a pass, in m16 tiles; MMA_ROWS of
// `paged.py` (16 x the most tiles of mma_max_tiles)
template <typename T, typename TK, int D>
cudaError_t launch_mma(const Params& p, int rt, int B, cudaStream_t s) {
  if (rt == 16) return launch_tiles<T, TK, D, 1>(p, B, s);
  if (rt == 32) return launch_tiles<T, TK, D, 2>(p, B, s);
  if constexpr (mma_max_tiles<D>() >= 4) {
    if (rt == 64) return launch_tiles<T, TK, D, 4>(p, B, s);
  }
  return cudaErrorInvalidValue;
}

// the design of each (q dtype, pool, mode), one line each; `paged.DESIGN`
// names the same (tests/test_torch_paged_design.py reads these lines)
template <int D>
cudaError_t dispatch(const Params& p, int dtype, int quant, int rt, int B, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const int verify = p.q_len > 1;
  if (dtype == 0 && quant == 0 && verify == 0) return launch_fma<float, float, D>(p, rt, B, s);
  if (dtype == 0 && quant == 0 && verify == 1) return launch_fma<float, float, D>(p, rt, B, s);
  if (dtype == 0 && quant == 1 && verify == 0) return launch_fma<float, int8_t, D>(p, rt, B, s);
  if (dtype == 0 && quant == 1 && verify == 1) return launch_fma<float, int8_t, D>(p, rt, B, s);
  if (dtype == 1 && quant == 0 && verify == 0) return launch_fma<bf16, bf16, D>(p, rt, B, s);
  if (dtype == 1 && quant == 0 && verify == 1) return launch_mma<bf16, bf16, D>(p, rt, B, s);
  if (dtype == 1 && quant == 1 && verify == 0) return launch_fma<bf16, int8_t, D>(p, rt, B, s);
  if (dtype == 1 && quant == 1 && verify == 1) return launch_mma<bf16, int8_t, D>(p, rt, B, s);
  if (dtype == 2 && quant == 0 && verify == 0) return launch_fma<__half, __half, D>(p, rt, B, s);
  if (dtype == 2 && quant == 0 && verify == 1) return launch_mma<__half, __half, D>(p, rt, B, s);
  if (dtype == 2 && quant == 1 && verify == 0) return launch_fma<__half, int8_t, D>(p, rt, B, s);
  if (dtype == 2 && quant == 1 && verify == 1) return launch_mma<__half, int8_t, D>(p, rt, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// one library per width of _build.HEAD_DIMS
#ifndef DS_HEAD_DIM
#error "build one library per head dim: -DDS_HEAD_DIM=<width> [-DDS_RUNTIME_D]"
#endif

// dtype (of q and out, and of the pools unless quant): 0 = float32, 1 =
// bfloat16, 2 = float16. quant: 1 = int8 pools with k_scale / v_scale [N,
// Hkv] fp32 (else those pointers are unused). head_dim: DS_HEAD_DIM, or
// with DS_RUNTIME_D a multiple of 8 up to it. The plan (`paged.plan`, for
// the design `dispatch` picks): rt, the rows of one pass (the CUDA-core
// design's row capacity, 1, 4 or 16, or the tensor-core design's 16, 32
// or, at head dims 32 and 64, 64), npass passes, chunk (units of 16
// positions per CTA) and nsplit (splits per slot in the
// partial buffers; 1: no combine). window <= 0: none. Returns the CUDA
// error of the launches (0 on success).
extern "C" int ds_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                               const float* k_scale, const float* v_scale,
                               const int* tables, const int* lengths, void* out,
                               float* part_acc, float* part_ml, int dtype, int quant, int B,
                               int q_len, int Hkv, int group, int head_dim, int bs, int NB,
                               int rt, int npass, int chunk, int nsplit, float scale,
                               int window, void* stream) {
  Params p{q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, part_acc, part_ml,
           q_len, Hkv, group, bs, NB, chunk, nsplit, npass, scale, window, head_dim};
  if (!flash_mma::takes_head_dim<DS_HEAD_DIM>(head_dim)) return cudaErrorInvalidValue;
  return dispatch<DS_HEAD_DIM>(p, dtype, quant, rt, B, static_cast<cudaStream_t>(stream));
}
