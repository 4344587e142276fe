// Paged flash-decode (and speculative verify) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/attention/paged.py
// `_paged_decode_kernel`, launched by `_paged_attention_call`: each serving
// slot's queries attend THROUGH its block table, reading only the pool
// blocks tables[b, lo..hi] that hold its cache, with an online softmax.
// q_len == 1 is decode; q_len > 1 is the verify chunk, where chunk row c
// is causal at position lengths[b] + c.
//
// What bounds it on an H100: the bytes. Every occupied K and V block is
// read once, plus q and out, and the arithmetic is ~4 flops per K/V
// element, far below the 295 flop/byte ridge; so the least time is those
// bytes over 3.35 TB/s.
//
// What this design does about it: the TPU walks a slot's blocks in order
// on one core (the sequential grid dimension) and folds all kv heads into
// one grid step so that one DMA serves every head. Here the walk is split
// (flash-decoding): one CTA owns one (slot, kv head, range of
// `split_blocks` blocks) and holds that head's group*q_len query rows, so a
// long slot is spread over many CTAs instead of one CTA's serial loop, and
// nothing past the slot's last block (trash block 0 or stale entries) is
// ever read. Each warp reads whole [Dh] rows of its head straight from the
// pool (one coalesced 256-byte row for bf16, Dh = 128) and reduces the dot
// products with shuffles; each CTA writes its partial (max, sum,
// accumulator) in fp32, and a second kernel combines the partials of each
// (slot, head). Loads are not yet pipelined ahead of use.
//
// Layout: q and out [B, q_len, Hkv, group, Dh] contiguous (the wrapper
// views decode's [B, Hkv, group, Dh] with q_len = 1), pools
// [N, bs, Hkv, Dh] contiguous (one layer's slice of the [L, N, ...] pool),
// tables [B, NB] int32, lengths [B] int32; fp32 scratch part_acc
// [B, Hkv, nsplit, R, Dh] and part_ml [B, Hkv, nsplit, 2, R] with
// R = group * q_len. Masked scores take -1e30, as on the TPU, and a zero
// softmax sum gives an output of 0.
//
// int8-pool mode (the TPU kernel's `quant=True`): the pools hold int8 and
// k_scale / v_scale [N, Hkv] fp32 hold one scale per (block, kv head),
// read through the same table entry as the block. Each K and V element is
// widened to fp32 and multiplied by its block's scale right after the
// load (the TPU kernel's in-register dequant), so the bytes read are the
// int8 payload plus one scale per block and head: half of the bf16 mode's.
// q is widened to fp32 as in the float modes, and p is not rounded: the
// dequantized V is fp32, so the TPU kernel's `p.astype(vh.dtype)` keeps
// p in fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int NT = 128;       // 4 warps
constexpr int NWARP = NT / 32;
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q; const void* k_pool; const void* v_pool;
  const float* k_scale; const float* v_scale;    // int8 mode only
  const int* tables; const int* lengths; void* out;
  float* part_acc; float* part_ml;
  int q_len, Hkv, group, bs, NB, split_blocks, nsplit;
  float scale;
  int window;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// grid (Hkv, B, nsplit): the partial softmax state of one block range.
// T: q and out; QUANT: int8 pools with per-(block, head) scales, else
// pools of T
template <typename T, int D, bool QUANT>
__global__ void __launch_bounds__(NT) paged_split_kernel(const Params p) {
  using TK = typename std::conditional<QUANT, int8_t, T>::type;
  extern __shared__ float smem[];
  const int R = p.group * p.q_len;     // query rows of this kv head
  float* sQ = smem;                    // [R][D]
  float* sAcc = sQ + R * D;            // [R][D]
  float* sS = sAcc + R * D;            // [R][bs] scores, then p
  float* sM = sS + R * p.bs;           // [R]
  float* sL = sM + R;                  // [R]
  float* sAlpha = sL + R;              // [R]

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const TK* __restrict__ kp = static_cast<const TK*>(p.k_pool);
  const TK* __restrict__ vp = static_cast<const TK*>(p.v_pool);

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int DJ = D / 32;
  const long long part = ((long long)b * p.Hkv + h) * p.nsplit + split;
  float* ml = p.part_ml + part * 2 * R;   // [2][R]: max, then sum

  const int pos = p.lengths[b];
  const int hi = min((pos + p.q_len - 1) / p.bs, p.NB - 1);
  int lo = 0;
  if (p.window > 0) lo = min(max((pos - p.window + 1) / p.bs, 0), p.NB - 1);
  const int j0 = max(lo, split * p.split_blocks);
  const int j1 = min(hi, split * p.split_blocks + p.split_blocks - 1);
  if (j0 > j1) {                       // no block of this slot in range
    for (int r = tid; r < R; r += NT) { ml[r] = -INFINITY; ml[R + r] = 0.f; }
    return;
  }

  // row r = (group member r / q_len, chunk offset r % q_len)
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, d = i % D;
    const int gm = r / p.q_len, c = r % p.q_len;
    const long long qi = ((((long long)b * p.q_len + c) * p.Hkv + h) * p.group + gm) * D + d;
    sQ[i] = to_f(q[qi]);
    sAcc[i] = 0.f;
  }
  for (int r = tid; r < R; r += NT) { sM[r] = NEG_INF; sL[r] = 0.f; }
  const long long tok_stride = (long long)p.Hkv * D;   // one token of one block
  __syncthreads();

  for (int j = j0; j <= j1; ++j) {
    const int blk = p.tables[b * p.NB + j];
    const long long base = ((long long)blk * p.bs * p.Hkv + h) * D;
    float ksc = 1.f, vsc = 1.f;
    if constexpr (QUANT) {
      ksc = p.k_scale[(long long)blk * p.Hkv + h];
      vsc = p.v_scale[(long long)blk * p.Hkv + h];
    }

    // scores: warp w takes tokens w, w + 4, ...; lane holds Dh / 32 values
    for (int t = warp; t < p.bs; t += NWARP) {
      float kv[DJ];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        kv[jj] = to_f(kp[base + t * tok_stride + lane + 32 * jj]);
        if constexpr (QUANT) kv[jj] *= ksc;
      }
      const int col = j * p.bs + t;
      for (int r = 0; r < R; ++r) {
        float part_s = 0.f;
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) part_s = fmaf(sQ[r * D + lane + 32 * jj], kv[jj], part_s);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part_s += __shfl_xor_sync(0xffffffffu, part_s, o);
        if (lane == 0) {
          const int qpos = pos + r % p.q_len;
          bool ok = col <= qpos;
          if (p.window > 0) ok = ok && col > qpos - p.window;
          sS[r * p.bs + t] = ok ? part_s * p.scale : NEG_INF;
        }
      }
    }
    __syncthreads();

    // online softmax, one thread per row; p is cast to V's type before PV
    // (fp32 in the int8 mode, whose V is dequantized to fp32)
    for (int r = tid; r < R; r += NT) {
      float* srow = sS + r * p.bs;
      float m_cur = NEG_INF;
      for (int t = 0; t < p.bs; ++t) m_cur = fmaxf(m_cur, srow[t]);
      const float m_new = fmaxf(sM[r], m_cur);
      float sum = 0.f;
      for (int t = 0; t < p.bs; ++t) {
        const float e = expf(srow[t] - m_new);
        sum += e;
        if constexpr (QUANT) srow[t] = e;
        else srow[t] = to_f(from_f<T>(e));
      }
      const float alpha = expf(sM[r] - m_new);
      sL[r] = alpha * sL[r] + sum;
      sM[r] = m_new;
      sAlpha[r] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V over (row, column) pairs; neighbouring
    // threads read neighbouring columns of one V token row
    for (int i = tid; i < R * D; i += NT) {
      const int r = i / D, d = i % D;
      const float* prow = sS + r * p.bs;
      float a = sAcc[i] * sAlpha[r];
      for (int t = 0; t < p.bs; ++t) {
        float v = to_f(vp[base + t * tok_stride + d]);
        if constexpr (QUANT) v *= vsc;
        a = fmaf(prow[t], v, a);
      }
      sAcc[i] = a;
    }
    __syncthreads();
  }

  float* acc = p.part_acc + part * R * D;
  for (int i = tid; i < R * D; i += NT) acc[i] = sAcc[i];
  for (int r = tid; r < R; r += NT) { ml[r] = sM[r]; ml[R + r] = sL[r]; }
}

// grid (Hkv, B): out = sum_s w_s acc_s / sum_s w_s l_s, w_s = exp(m_s - M)
template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_combine_kernel(const Params p) {
  const int R = p.group * p.q_len;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long first = ((long long)b * p.Hkv + h) * p.nsplit;
  T* __restrict__ out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D, d = i % D;
    float M = -INFINITY;
    for (int s = 0; s < p.nsplit; ++s) M = fmaxf(M, p.part_ml[(first + s) * 2 * R + r]);
    float L = 0.f, O = 0.f;
    for (int s = 0; s < p.nsplit; ++s) {
      const float* ml = p.part_ml + (first + s) * 2 * R;
      if (ml[r] == -INFINITY) continue;          // empty split
      const float w = expf(ml[r] - M);
      L = fmaf(w, ml[R + r], L);
      O = fmaf(w, p.part_acc[((first + s) * R + r) * D + d], O);
    }
    const int gm = r / p.q_len, c = r % p.q_len;
    const long long oi = ((((long long)b * p.q_len + c) * p.Hkv + h) * p.group + gm) * D + d;
    out[oi] = from_f<T>(O / (L == 0.f ? 1.f : L));
  }
}

template <typename T, int D, bool QUANT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int R = p.group * p.q_len;
  const size_t smem = sizeof(float) * (2 * R * D + R * p.bs + 3 * R);
  cudaError_t err = cudaFuncSetAttribute(paged_split_kernel<T, D, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  paged_split_kernel<T, D, QUANT><<<dim3(p.Hkv, B, p.nsplit), NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T, D><<<dim3(p.Hkv, B), NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

template <typename T, int D>
cudaError_t launch_mode(const Params& p, int quant, int B, cudaStream_t s) {
  return quant ? launch<T, D, true>(p, B, s) : launch<T, D, false>(p, B, s);
}

// dtype (of q and out, and of the pools unless quant): 0 = float32, 1 =
// bfloat16. quant: 1 = int8 pools with k_scale / v_scale [N, Hkv] fp32
// (else those pointers are unused). head_dim: 64 or 128. window <= 0:
// none. Returns the CUDA error of the launches (0 on success).
extern "C" int ds_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                               const float* k_scale, const float* v_scale,
                               const int* tables, const int* lengths, void* out,
                               float* part_acc, float* part_ml, int dtype, int quant, int B,
                               int q_len, int Hkv, int group, int head_dim, int bs, int NB,
                               int split_blocks, int nsplit, float scale, int window,
                               void* stream) {
  Params p{q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, part_acc, part_ml,
           q_len, Hkv, group, bs, NB, split_blocks, nsplit, scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch_mode<float, 64>(p, quant, B, s);
  if (dtype == 0 && head_dim == 128) return launch_mode<float, 128>(p, quant, B, s);
  if (dtype == 1 && head_dim == 64) return launch_mode<__nv_bfloat16, 64>(p, quant, B, s);
  if (dtype == 1 && head_dim == 128) return launch_mode<__nv_bfloat16, 128>(p, quant, B, s);
  return cudaErrorInvalidValue;
}
