// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/attention/flash.py
// `_fwd_kernel`, launched by `_flash_fwd`: FA2 online-softmax attention
// that writes O and the per-row log-sum-exp, with causal tile skipping,
// grouped-query heads, a [B, Skv] key-validity mask, a sliding window and
// [B, S] segment ids of packed rows (a query sees only keys of its own
// segment; self-attention only, Skv == S).
//
// What bounds it on an H100: causal attention does ~2*B*H*S^2*D flops
// (QK^T plus PV over the lower triangle), so at prefill lengths it is
// bound by operations (989 TFLOP/s bf16 on the tensor cores); at short S
// the q/k/v/o bytes over 3.35 TB/s bound it instead.
//
// Two designs, chosen by dtype in `ds_flash_fwd` (a dispatch, not a
// fallback):
//
// bfloat16 and float16: `flash_fwd_mma_kernel`, FlashAttention-2 on the
// tensor cores (mma.sync m16n8k16, fp32 accumulate). One CTA owns one
// (batch*head, 64-row q tile) with 4 warps of 16 rows; Q goes once through
// shared memory into A fragments (ldmatrix) held in registers. K/V tiles
// (32 keys at head dim 64, 64 at 128: see fwd_kt) sit in shared memory in
// the input dtype, rows padded by 16 bytes (conflict-free ldmatrix), and
// arrive by 16-byte cp.async into a two-stage ring, so tile t+1 loads
// while tile t computes. S = Q K^T takes K's rows as the col-major B
// operand; the online softmax runs on the accumulator fragments in the
// log2 domain (each thread holds 2 rows; the row max and sum take two quad
// shuffles; one MUFU ex2 per score); P is rounded to V's type in registers and
// reused as the A fragment of P V, with V read by ldmatrix.trans. Masks
// are applied per fragment element only on tiles that need them (the
// diagonal, the window edge, the ragged end of Skv, and every tile under
// kv_mask or segment ids, whose key values are staged in shared memory
// with K). Causal q tiles launch heaviest first (reversed blockIdx.x), so
// the long rows do not form the tail.
//
// float32: `flash_fwd_fma_kernel`, the first design, on the CUDA cores in
// fp32 FMA. TF32 tensor cores would miss the float32 tolerance (1e-4).
// K and V tiles are staged in shared memory as fp32; the running max, sum
// and accumulator stay fp32 in registers.
//
// Both walk the kv tiles from the window's lower edge up to the causal
// limit of the q tile, so no tile above the diagonal or below the band is
// read.
//
// Layout: q [B, S, H, D], k/v [B, Skv, Hkv, D] read through element
// strides (the last dimension contiguous; for the tensor-core kernel
// every base pointer and row stride 16-byte aligned, which the wrapper
// ensures), o [B, S, H, D] contiguous,
// lse [B, H, S] fp32 contiguous. Masked scores take -1e30, not -inf,
// exactly as the TPU kernel: a fully masked tile gives p = 1 everywhere,
// and the first tile with a valid key wipes that with alpha = 0. Rows
// with no valid key at all are garbage by contract.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BKV = 64;       // kv columns per tile
constexpr int NT = 256;       // threads per CTA: 8 warps x 8 rows each
constexpr int ROWS = BQ / (NT / 32);
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q; const void* k; const void* v; const float* mask;
  const int* segs;
  void* o; float* lse;
  int B, S, Skv, H, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  int causal, window;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// SEGS: whether segment ids are given. A template parameter, so that the
// kernel without them carries none of their loads and tests. The q rows'
// ids sit in shared memory: eight more registers per thread took the
// head-dim-128 kernel past 128 registers and cost it a third of its speed.
template <typename T, int D, bool SEGS>
__global__ void __launch_bounds__(NT) flash_fwd_fma_kernel(const Params p) {
  extern __shared__ float smem[];
  float* sQ = smem;                    // [BQ][D]
  float* sK = sQ + BQ * D;             // [BKV][D + 1]: padded, lanes read columns
  float* sV = sK + BKV * (D + 1);      // [BKV][D]
  float* sP = sV + BKV * D;            // [BQ][BKV]
  int* sSeg = reinterpret_cast<int*>(sP + BQ * BKV);   // [BQ], with SEGS only

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ o = static_cast<T*>(p.o);

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);    // GQA: kv head = q head // group
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int DJ = D / 32;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, s = q0 + r;
    sQ[i] = s < p.S ? to_f(q[b * p.q_sb + s * p.q_ss + h * p.q_sh + d]) : 0.f;
  }
  if constexpr (SEGS) {   // the tile's q-row segment ids: shared, not 8 registers
    if (tid < BQ) sSeg[tid] = q0 + tid < p.S ? p.segs[(long long)b * p.S + q0 + tid] : 0;
  }

  // kv columns any row of this tile may see: causal stops at the tile's
  // last row, the window starts at the first row's band edge
  int kv_end = p.Skv;
  if (p.causal) kv_end = min(kv_end, min(q0 + BQ, p.S));
  int kv_start = 0;
  if (p.window > 0) kv_start = max(0, q0 - p.window + 1);
  const int t_lo = kv_start / BKV;
  const int t_hi = (kv_end + BKV - 1) / BKV;

  float m[ROWS], l[ROWS], acc[ROWS][DJ];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF; l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BKV;
    __syncthreads();   // the previous tile's sK/sV reads are done (and sQ is loaded)
    for (int i = tid; i < BKV * D; i += NT) {
      const int c = i / D, d = i % D, col = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (col < p.Skv) {
        kv = to_f(k[b * p.k_sb + col * p.k_ss + hk * p.k_sh + d]);
        vv = to_f(v[b * p.v_sb + col * p.v_ss + hk * p.v_sh + d]);
      }
      sK[c * (D + 1) + d] = kv;
      sV[i] = vv;
    }
    __syncthreads();

    // S = Q K^T: warp owns rows warp*ROWS.., lane owns columns lane, lane+32
    float s[ROWS][2];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i][0] = s[i][1] = 0.f;
    const float* qrow = sQ + warp * ROWS * D;
    const float* k0row = sK + lane * (D + 1);
    const float* k1row = sK + (lane + 32) * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float ka = k0row[d], kb = k1row[d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float qv = qrow[i * D + d];
        s[i][0] = fmaf(qv, ka, s[i][0]);
        s[i][1] = fmaf(qv, kb, s[i][1]);
      }
    }

    int kseg[2] = {0, 0};
    if constexpr (SEGS) {   // segment ids need Skv == S (checked by the wrapper)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + lane + 32 * j;
        if (col < p.Skv) kseg[j] = p.segs[(long long)b * p.S + col];
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = q0 + warp * ROWS + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + lane + 32 * j;
        bool ok = col < p.Skv;
        if (p.causal) ok = ok && col <= row;
        if (p.window > 0) ok = ok && row - col < p.window;
        if (p.mask != nullptr && ok) ok = p.mask[(long long)b * p.Skv + col] > 0.f;
        if constexpr (SEGS) ok = ok && sSeg[warp * ROWS + i] == kseg[j];
        s[i][j] = ok ? s[i][j] * p.scale : NEG_INF;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
      const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
      // p is cast to V's type before the PV product, as on the TPU
      float* prow = sP + (warp * ROWS + i) * BKV;
      prow[lane] = to_f(from_f<T>(p0));
      prow[lane + 32] = to_f(from_f<T>(p1));
    }
    __syncwarp();

    // O += P V: lane owns columns lane + 32*j of its warp's rows
    const float* prow = sP + warp * ROWS * BKV;
#pragma unroll 2
    for (int c = 0; c < BKV; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * D + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float pc = prow[i * BKV + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pc, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + warp * ROWS + i;
    if (row >= p.S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (((long long)b * p.S + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[lane + 32 * j] = from_f<T>(acc[i][j] / l_safe);
    if (lane == 0) p.lse[((long long)b * p.H + h) * p.S + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int D, bool SEGS>
cudaError_t launch_fma_kernel(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + BKV * (D + 1) + BKV * D + BQ * BKV)
      + (SEGS ? sizeof(int) * BQ : 0);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_fma_kernel<T, D, SEGS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_fma_kernel<T, D, SEGS><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_fma(const Params& p, cudaStream_t stream) {
  return p.segs != nullptr ? launch_fma_kernel<T, D, true>(p, stream)
                           : launch_fma_kernel<T, D, false>(p, stream);
}

// ---------------------------------------------------------------------------
// bfloat16 / float16: the tensor-core design
// ---------------------------------------------------------------------------

constexpr int MMA_NT = 128;          // threads per CTA: 4 warps x 16 q rows
constexpr int MMA_BQ = 64;           // q rows per CTA
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Keys per kv tile: 32 at head dim 64, whose score tile then takes 16
// registers a thread instead of 32, so that the kernel fits the 128
// registers of four CTAs per SM without spilling (0.38 against 0.42 ms at
// the gpt2-1.5b training shape on the H100); 64 at head dim 128. Two m16
// row tiles per warp at head dim 64 (each K/V fragment feeding two
// products) took 255 registers and was slower (0.49 against 0.46 ms).
template <int D> __host__ __device__ constexpr int fwd_kt() { return D == 64 ? 32 : 64; }
// CTAs an SM should hold, which bounds the registers (launch bounds)
template <int D> __host__ __device__ constexpr int fwd_min_ctas() { return D == 64 ? 4 : 2; }

template <typename T, int D>
constexpr size_t mma_smem_bytes() {
  constexpr int KT = fwd_kt<D>();
  // Q [64][D + PAD], two stages of K and V [KT][D + PAD], two stages of
  // the tile's key mask (fp32) and key segment ids
  return sizeof(T) * (MMA_BQ + 4 * KT) * (D + flash_mma::PAD)
      + 2 * KT * (sizeof(float) + sizeof(int));
}

template <typename T, int D, bool SEGS>
__global__ void __launch_bounds__(MMA_NT, fwd_min_ctas<D>()) flash_fwd_mma_kernel(const Params p) {
  using namespace flash_mma;
  constexpr int KT = fwd_kt<D>();      // keys per kv tile
  constexpr int LD = D + PAD;          // shared row pitch, elements
  constexpr int CH = D / 8;            // 16-byte chunks per row
  constexpr int KS = D / 16;           // k16 steps over the head dim
  constexpr int NJ = KT / 8;           // n8 score tiles per kv tile
  constexpr int DN = D / 8;            // n8 output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);                  // [MMA_BQ][LD]
  T* sKV = sQ + MMA_BQ * LD;                               // [2][K, V][KT][LD]
  float* sMask = reinterpret_cast<float*>(sKV + 4 * KT * LD);   // [2][KT]
  int* sKseg = reinterpret_cast<int*>(sMask + 2 * KT);          // [2][KT]

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);    // GQA: kv head = q head // group
  // causal: the last q tiles see the most keys, so they launch first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * MMA_BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int qw = q0 + warp * 16;       // the warp's first row; the thread's
                                       // rows are qw + g and qw + g + 8
  // scores are kept in the log2 domain: x = s * scale * log2(e)
  const float scale2 = p.scale * LOG2E;

  const T* qbase = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kbase = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < MMA_BQ * CH; i += MMA_NT) {
    const int r = i / CH, c = (i % CH) * 8, s = q0 + r;
    cp_async16(sQ + r * LD + c, qbase + (long long)min(s, p.S - 1) * p.q_ss + c, s < p.S);
  }

  // the present kernel's tile range: up to the causal limit of the tile's
  // last row, from the band edge of its first row
  int kv_end = p.Skv;
  if (p.causal) kv_end = min(kv_end, min(q0 + MMA_BQ, p.S));
  int kv_start = 0;
  if (p.window > 0) kv_start = max(0, q0 - p.window + 1);
  const int t_lo = kv_start / KT;
  const int t_hi = (kv_end + KT - 1) / KT;

  auto load_kv = [&](int t, int st) {
    const int k0 = t * KT;
    T* sK = sKV + st * 2 * KT * LD;
    T* sV = sK + KT * LD;
    for (int i = tid; i < KT * CH; i += MMA_NT) {
      const int r = i / CH, c = (i % CH) * 8, col = k0 + r;
      const long long row = min(col, p.Skv - 1);
      cp_async16(sK + r * LD + c, kbase + row * p.k_ss + c, col < p.Skv);
      cp_async16(sV + r * LD + c, vbase + row * p.v_ss + c, col < p.Skv);
    }
    if (tid < KT) {
      const int col = k0 + tid;
      const long long at = (long long)b * p.Skv + min(col, p.Skv - 1);
      if (p.mask != nullptr) cp_async4(sMask + st * KT + tid, p.mask + at, col < p.Skv);
      // segment ids need Skv == S (checked by the wrapper)
      if constexpr (SEGS) cp_async4(sKseg + st * KT + tid, p.segs + at, col < p.Skv);
    }
  };

  int qseg[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = qw + g + 8 * hh;
    qseg[hh] = (SEGS && row < p.S) ? p.segs[(long long)b * p.S + row] : 0;
  }

  if (t_lo < t_hi) load_kv(t_lo, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a(qf[kk], sQ, LD, warp * 16, kk * 16, lane);

  // row statistics in the log2 domain; m stays -1e30 while every key of
  // the row so far was masked
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_hi) load_kv(t + 1, st ^ 1);   // lands while this tile computes
    cp_async_commit();
    const T* sK = sKV + st * 2 * KT * LD;
    const T* sV = sK + KT * LD;
    const int k0 = t * KT;

    // S = Q K^T: 16 rows x KT keys per warp
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        uint32_t bf[4];
        load_b_nk(bf, sK, LD, jj * 16, kk * 16, lane);
        mma16816<T>(s[2 * jj], qf[kk], bf[0], bf[1]);
        mma16816<T>(s[2 * jj + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale, and mask only where some pair of the warp's block may fail
    const bool need = p.mask != nullptr || SEGS || k0 + KT > p.Skv
        || (p.causal && k0 + KT - 1 > qw)
        || (p.window > 0 && qw + 15 - k0 >= p.window);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale2;
        if (need) {
          const int c = j * 8 + 2 * t4 + (e & 1), col = k0 + c;
          const int hh = e >> 1, row = qw + g + 8 * hh;
          bool ok = col < p.Skv;
          if (p.causal) ok = ok && col <= row;
          if (p.window > 0) ok = ok && row - col < p.window;
          if (p.mask != nullptr) ok = ok && sMask[st * KT + c] > 0.f;
          if constexpr (SEGS) ok = ok && sKseg[st * KT + c] == qseg[hh];
          if (!ok) x = NEG_INF;
        }
        s[j][e] = x;
      }
    }

    // online softmax on the fragments: element e of a tile is row
    // qw + g + 8 (e / 2); the quad of lanes sharing g holds one row's KT
    // columns
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = quad_max(mx);
      // masked scores are -1e30 in both domains: a row that has seen only
      // masked keys has m = -1e30 and p = 1, wiped by alpha = 0 at its
      // first valid key, as in the TPU kernel
      const float alpha = exp2_ftz(m[hh] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          s[j][e] = exp2_ftz(s[j][e] - mx);
          sum += s[j][e];
        }
      }
      l[hh] = alpha * l[hh] + quad_sum(sum);
      m[hh] = mx;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        acc[n][2 * hh] *= alpha;
        acc[n][2 * hh + 1] *= alpha;
      }
    }

    // O += P V: P rounded to V's type in registers, as on the TPU
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t a[4];
      c_to_a<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int jj = 0; jj < DN / 2; ++jj) {
        uint32_t bf[4];
        load_b_kn(bf, sV, LD, kk * 16, jj * 16, lane);
        mma16816<T>(acc[2 * jj], a, bf[0], bf[1]);
        mma16816<T>(acc[2 * jj + 1], a, bf[2], bf[3]);
      }
    }
    cp_async_wait_all();   // tile t+1 has landed ...
    __syncthreads();       // ... for every thread, and stage st is free
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = qw + g + 8 * hh;
    if (row >= p.S) continue;
    const float l_safe = l[hh] == 0.f ? 1.f : l[hh];
    T* orow = o + (((long long)b * p.S + row) * p.H + h) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack2<T>(acc[n][2 * hh] / l_safe, acc[n][2 * hh + 1] / l_safe);
    // back to the natural log; a row with no valid key keeps -1e30
    const float mn = m[hh] == NEG_INF ? NEG_INF : m[hh] * LN2;
    if (t4 == 0) p.lse[((long long)b * p.H + h) * p.S + row] = mn + logf(l_safe);
  }
}

template <typename T, int D, bool SEGS>
cudaError_t launch_mma_kernel(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<T, D, SEGS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + MMA_BQ - 1) / MMA_BQ, p.B * p.H);
  flash_fwd_mma_kernel<T, D, SEGS><<<grid, MMA_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  return p.segs != nullptr ? launch_mma_kernel<T, D, true>(p, stream)
                           : launch_mma_kernel<T, D, false>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. head_dim: 64 or 128.
// window <= 0: none. mask ([B, Skv] fp32) and segs ([B, S] int32) may be
// null. Returns the CUDA error of the launch (0 on success).
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v, const float* mask,
                            const int* segs, void* o, float* lse, int dtype, int B, int S, int Skv, int H,
                            int Hkv, int head_dim, long long q_sb, long long q_ss,
                            long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh, float scale,
                            int causal, int window, void* stream) {
  Params p{q, k, v, mask, segs, o, lse, B, S, Skv, H, Hkv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the design by dtype: float32 on the CUDA cores (TF32 would miss its
  // tolerance), bfloat16 and float16 on the tensor cores
  if (dtype == 0 && head_dim == 64) return launch_fma<float, 64>(p, s);
  if (dtype == 0 && head_dim == 128) return launch_fma<float, 128>(p, s);
  if (dtype == 1 && head_dim == 64) return launch_mma<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && head_dim == 128) return launch_mma<__nv_bfloat16, 128>(p, s);
  if (dtype == 2 && head_dim == 64) return launch_mma<__half, 64>(p, s);
  if (dtype == 2 && head_dim == 128) return launch_mma<__half, 128>(p, s);
  return cudaErrorInvalidValue;
}
