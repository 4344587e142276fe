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
// What this design does about it.
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
//   launches give the same bits).
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "flash_mma.cuh"

namespace {

using flash_mma::cp_async16;
using flash_mma::cp_async4;

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
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename TK, int D, int RT>
struct Geometry {
  static constexpr bool QUANT = std::is_same<TK, int8_t>::value;
  static constexpr int RB = D * (int)sizeof(TK);          // bytes of a row
  static constexpr int CPR = RB / 16;                     // 16-byte chunks per row
  static constexpr int KP = RB + 16;                      // padded pitch in the ring
  static constexpr int UNIT = 2 * TT * KP + (QUANT ? 2 * TT * 4 : 0);   // K, V, scales
  static constexpr int RING = NWARP * NSTAGE * UNIT;
  static constexpr int MERGE = NWARP * RT * (D + 2) * 4;
  static constexpr int SMEM = RT * D * 4 + NWARP * RT * TT * 4 + (RING > MERGE ? RING : MERGE);
};

// grid (B, Hkv * npass, nsplit): the partial softmax state of one split
// of one (slot, kv head, pass of <= RMAX rows). T: q and out; TK: the
// pools' element (T, or int8 with per-(block, head) scales); RT: the
// row capacity (>= the pass's rows)
template <typename T, typename TK, int D, int RT>
__global__ void __launch_bounds__(NT) paged_split_kernel(const Params p) {
  using G = Geometry<TK, D, RT>;
  constexpr bool QUANT = G::QUANT;
  constexpr bool SPLIT_D = RT == 1;          // one row: the halves split Dh
  constexpr int SR = SPLIT_D ? 1 : RT / 2;   // score rows per lane
  constexpr int DL = Chunk<TK>::N;           // elements per 16-byte chunk
  constexpr int NCH = SPLIT_D ? G::CPR / 2 : G::CPR;
  constexpr int DV = D / 32;                 // PV columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);                  // [RT][D]
  float* sPall = sQ + RT * D;                                  // [NWARP][RT][TT]
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

  // q rows r0 .. r0 + Rp of this kv head, widened; row r = (group member
  // r / q_len, chunk offset r % q_len)
  const T* __restrict__ q = static_cast<const T*>(p.q);
  for (int i = tid; i < RT * D; i += NT) {
    const int r = i / D, d = i % D;
    float v = 0.f;
    if (r < Rp) {
      const int rg = r0 + r, gm = rg / p.q_len, c = rg % p.q_len;
      v = to_f(q[((((long long)b * p.q_len + c) * p.Hkv + h) * p.group + gm) * D + d]);
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
  const char* kpool = static_cast<const char*>(p.k_pool);
  const char* vpool = static_cast<const char*>(p.v_pool);

  // unit k of this warp -> ring slot k % NSTAGE; positions outside [lo, hi]
  // are zero-filled without a read
  auto load_unit = [&](int k) {
    unsigned char* slot = wring + (k % NSTAGE) * G::UNIT;
    const int u = u_first + warp + k * NWARP;
    const int tp = u * TT + t;                  // lanes t and t + 16: token t
    const bool tv = tp >= wk.lo && tp <= wk.hi;
    long long row = 0;                          // the token's row of this head
    int blk = 0;
    if (tv) {
      blk = p.tables[(long long)b * p.NB + tp / p.bs];
      row = ((long long)blk * p.bs + tp % p.bs) * p.Hkv + h;
    }
#pragma unroll
    for (int i = 0; i < TT * G::CPR / 32; ++i) {
      const int c = lane + 32 * i, tk = c / G::CPR, part = c % G::CPR;
      const long long rk = __shfl_sync(FULL, row, tk);
      const bool ok = __shfl_sync(FULL, (int)tv, tk) != 0;
      const long long off = ok ? rk * G::RB + part * 16 : 0;
      cp_async16(slot + tk * G::KP + part * 16, kpool + off, ok);
      cp_async16(slot + TT * G::KP + tk * G::KP + part * 16, vpool + off, ok);
    }
    if constexpr (QUANT) {
      float* sc = reinterpret_cast<float*>(slot + 2 * TT * G::KP);   // [2][TT]
      const float* src = h2 ? p.v_scale : p.k_scale;
      cp_async4(sc + h2 * TT + t, tv ? src + (long long)blk * p.Hkv + h : src, tv);
    }
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
    if (k < nk) load_unit(k);
    flash_mma::cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    if (k + NSTAGE - 1 < nk) load_unit(k + NSTAGE - 1);
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
          const float* qr = sQ + r * D + d0;
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
        load_cols<TK, DV>(reinterpret_cast<const TK*>(
                              reinterpret_cast<const unsigned char*>(sV) + (t4 + j) * G::KP)
                              + lane * DV, vf[j]);
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
  float* mA = mL + NWARP * RT;                      // [NWARP][RT][D]
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r) { mM[warp * RT + r] = m[r]; mL[warp * RT + r] = l[r]; }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < DV; ++e) mA[(warp * RT + r) * D + lane * DV + e] = acc[r][e];
  __syncthreads();

  const long long bh = (long long)b * p.Hkv + h;
  T* __restrict__ out = static_cast<T*>(p.out);
  for (int i = tid; i < Rp * D; i += NT) {
    const int r = i / D, d = i % D, rg = r0 + r;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) M = fmaxf(M, mM[w * RT + r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float a = expf(mM[w * RT + r] - M);
      L = fmaf(a, mL[w * RT + r], L);
      O = fmaf(a, mA[(w * RT + r) * D + d], O);
    }
    if (wk.ns == 1) {
      const int gm = rg / p.q_len, c = rg % p.q_len;
      out[((((long long)b * p.q_len + c) * p.Hkv + h) * p.group + gm) * D + d] =
          from_f<T>(O / (L == 0.f ? 1.f : L));
    } else {
      const long long part = bh * p.nsplit + split;
      p.part_acc[(part * R + rg) * D + d] = O;
      if (d == 0) {
        p.part_ml[part * 2 * R + rg] = M;
        p.part_ml[part * 2 * R + R + rg] = L;
      }
    }
  }
}

// grid (B, Hkv): out = sum_s w_s acc_s / sum_s w_s l_s, w_s = exp(m_s - M),
// over the splits of slot b that hold work, in split order
template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_combine_kernel(const Params p) {
  const int b = blockIdx.x, h = blockIdx.y;
  const Work wk = work_of(p, b);
  if (wk.ns == 1) return;                  // written by its one split
  const int R = p.group * p.q_len;
  const long long first = ((long long)b * p.Hkv + h) * p.nsplit;
  T* __restrict__ out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D, d = i % D;
    float M = NEG_INF;
    for (int s = 0; s < wk.ns; ++s) M = fmaxf(M, p.part_ml[(first + s) * 2 * R + r]);
    float L = 0.f, O = 0.f;
    for (int s = 0; s < wk.ns; ++s) {
      const float* ml = p.part_ml + (first + s) * 2 * R;
      const float w = expf(ml[r] - M);
      L = fmaf(w, ml[R + r], L);
      O = fmaf(w, p.part_acc[((first + s) * R + r) * D + d], O);
    }
    const int gm = r / p.q_len, c = r % p.q_len;
    out[((((long long)b * p.q_len + c) * p.Hkv + h) * p.group + gm) * D + d] =
        from_f<T>(O / (L == 0.f ? 1.f : L));
  }
}

template <typename T, typename TK, int D, int RT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = Geometry<TK, D, RT>::SMEM;
  static cudaError_t set = cudaFuncSetAttribute(
      paged_split_kernel<T, TK, D, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  paged_split_kernel<T, TK, D, RT>
      <<<dim3(B, p.Hkv * p.npass, p.nsplit), NT, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return err;
  paged_combine_kernel<T, D><<<dim3(B, p.Hkv), NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename TK, int D>
cudaError_t launch_rows(const Params& p, int rt, int B, cudaStream_t s) {
  if (rt == 1) return launch<T, TK, D, 1>(p, B, s);
  if (rt == 4) return launch<T, TK, D, 4>(p, B, s);
  if (rt == 16) return launch<T, TK, D, 16>(p, B, s);
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t launch_mode(const Params& p, int quant, int rt, int B, cudaStream_t s) {
  return quant ? launch_rows<T, int8_t, D>(p, rt, B, s) : launch_rows<T, T, D>(p, rt, B, s);
}

}  // namespace

// dtype (of q and out, and of the pools unless quant): 0 = float32, 1 =
// bfloat16. quant: 1 = int8 pools with k_scale / v_scale [N, Hkv] fp32
// (else those pointers are unused). head_dim: 64 or 128. The plan
// (`paged.plan`): rt, the row capacity (1, 4 or 16; rows beyond 16 run in
// npass passes), chunk (units of 16 positions per CTA) and nsplit (splits
// per slot in the partial buffers; 1: no combine). window <= 0: none.
// Returns the CUDA error of the launches (0 on success).
extern "C" int ds_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                               const float* k_scale, const float* v_scale,
                               const int* tables, const int* lengths, void* out,
                               float* part_acc, float* part_ml, int dtype, int quant, int B,
                               int q_len, int Hkv, int group, int head_dim, int bs, int NB,
                               int rt, int npass, int chunk, int nsplit, float scale,
                               int window, void* stream) {
  Params p{q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, part_acc, part_ml,
           q_len, Hkv, group, bs, NB, chunk, nsplit, npass, scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch_mode<float, 64>(p, quant, rt, B, s);
  if (dtype == 0 && head_dim == 128) return launch_mode<float, 128>(p, quant, rt, B, s);
  if (dtype == 1 && head_dim == 64) return launch_mode<__nv_bfloat16, 64>(p, quant, rt, B, s);
  if (dtype == 1 && head_dim == 128) return launch_mode<__nv_bfloat16, 128>(p, quant, rt, B, s);
  return cudaErrorInvalidValue;
}
