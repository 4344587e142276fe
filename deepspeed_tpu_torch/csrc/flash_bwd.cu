// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, dq and dk/dv.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/attention/flash.py
// launched by `_flash_bwd`: `_bwd_dq_kernel` (dq = sum over kv of ds K) and
// `_bwd_dkv_kernel` (dv = sum over q of p^T dO, dk = sum over q of ds^T Q),
// with p = exp(s - lse), ds = p * (dO V^T - delta) * scale and s recomputed
// from q and k under the forward's masks (causal, sliding window, [B, Skv]
// key validity, [B, S] segment ids; masked scores take -1e30, as in the
// forward). lse [B, H, S] comes from the forward, delta = rowsum(dO * O)
// [B, H, S] from the caller, both fp32.
//
// What bounds them on an H100: the recompute form does five tile products
// per (q tile, kv tile) pair over the causal triangle (dq: three, 6*D flops
// per score; dkv: four, 8*D), against q, k, v, dO read once and the
// gradients written once, so at training lengths both are bound by
// operations (989 TFLOP/s bf16 on the tensor cores), at short S by bytes.
//
// What the designs do about it: the TPU grids carry an accumulator in
// scratch across a sequential axis. Here that axis is a loop inside the
// CTA, and the accumulator stays in registers and is written once, so
// there are no atomics and two runs give the same bits.
//   dq:  one CTA per (batch*head, 64-row q tile) walks the kv tiles from
//        the window's lower edge to the causal limit. Two designs, chosen
//        by dtype in `dispatch`:
//        bfloat16 / float16, `flash_bwd_dq_mma_kernel`, on the tensor
//        cores (mma.sync m16n8k16, fp32 accumulate): 4 warps of 16 q rows;
//        Q and dO of the tile arrive once by cp.async, Q stays in
//        registers as A fragments (ldmatrix), dO's are read from shared
//        memory per kv tile (see dq_kt), the lse and delta of each
//        thread's two rows in registers; K/V tiles (see dq_kt) arrive by
//        16-byte cp.async into a two-stage ring with their key validity
//        and segment ids beside them. Per kv tile: S = Q K^T and
//        dP = dO V^T, P and dS on the accumulator fragments (masks only on
//        the tiles that need them), then dQ += dS K with dS converted from
//        the C to the A layout in registers (no shared-memory round trip)
//        and K read by ldmatrix.trans. dQ stays in fp32 registers and is
//        written once. Causal q tiles launch heaviest first.
//        float32, `flash_bwd_dq_fma_kernel`, the first design on the CUDA
//        cores (TF32 would miss the float32 tolerance): tiles staged in
//        shared memory as fp32, the products in fp32 FMA.
//   dkv: one CTA per (batch*kv head, 64-column kv tile) walks the q tiles
//        that can see it (from the diagonal down to the window's far edge)
//        and, under grouped-query attention, does so for each q head of
//        its group in turn inside the same CTA: the group's sum is taken in
//        the fp32 registers, with no buffer of per-q-head partials. Two
//        designs, chosen by dtype in `dispatch`:
//        bfloat16 / float16, `flash_bwd_dkv_mma_kernel`, on the tensor
//        cores (mma.sync m16n8k16, fp32 accumulate): 4 warps of 16 keys;
//        K and V stay in shared memory in the input dtype and are A
//        operands by ldmatrix; Q and dO tiles of 32 rows (dK and dV stay
//        in registers: see DKV_QT) arrive by 16-byte cp.async into a
//        two-stage ring, their lse and delta staged beside them. Per q
//        tile: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T on the
//        fragments, then dV += P^T dO and dK += dS^T Q with P^T and dS^T
//        from registers as A and dO, Q through ldmatrix.trans.
//        float32, `flash_bwd_dkv_fma_kernel`, the first design on the CUDA
//        cores, as dq.
// p is rounded to dO's type before p^T dO and ds to q's type before ds K
// and ds^T Q, where the TPU kernels round them.
//
// Layout: q, dO [B, S, H, D] and k, v [B, Skv, Hkv, D] read through element
// strides (last dimension contiguous; for the tensor-core kernel every
// base pointer and row stride 16-byte aligned, which the wrapper ensures);
// dq [B, S, H, D] and dk, dv
// [B, Skv, Hkv, D] contiguous. Ragged S and Skv are masked here. A row
// with no valid key has lse ~ -1e30 and p = 1 on its masked entries, as in
// the plain version: garbage by contract, harmless once dO is zero there.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int BQ = 64;        // q rows per tile
constexpr int BKV = 64;       // kv columns per tile
constexpr int NT = 256;       // threads per CTA: 8 warps
constexpr int ROWS = BQ / (NT / 32);   // rows (dq) or columns (dkv) a warp owns
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q; const void* k; const void* v; const void* dout;
  const float* lse; const float* delta; const float* mask; const int* segs;
  void* dq; void* dk; void* dv;
  int B, S, Skv, H, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
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
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// 64 rows r0.. of a strided [n, D] slice into shared memory as fp32 with
// row stride LD; rows past n are zero.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int r0, int n, int tid) {
  for (int i = tid; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D, row = r0 + r;
    dst[r * LD + d] = row < n ? to_f(src[row * row_stride + d]) : 0.f;
  }
}

// One (q tile, kv tile) pair. The warp owns q rows row0..row0+ROWS-1 (tile
// rows wrow..), the lane kv columns col0 and col0+32 (tile columns lane and
// lane+32). sQ and sdO have row stride D (broadcast float4 reads), sK and sV
// D+1 (each lane reads its own row). Returns p = exp(s - lse) and
// ds = p * (dO V^T - delta) * scale under the forward's masks.
template <int D>
__device__ __forceinline__ void tile_p_ds(
    const Params& p, const float* sQ, const float* sdO, const float* sK, const float* sV,
    int wrow, int lane, int row0, int col0, const float (&lse)[ROWS],
    const float (&delta)[ROWS], const int (&qseg)[ROWS], const bool (&kvok)[2],
    const int (&kseg)[2], float (&pr)[ROWS][2], float (&ds)[ROWS][2]) {
  float s[ROWS][2], dp[ROWS][2];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
  const float* qrow = sQ + wrow * D;
  const float* dorow = sdO + wrow * D;
  const float* k0row = sK + lane * (D + 1);
  const float* k1row = sK + (lane + 32) * (D + 1);
  const float* v0row = sV + lane * (D + 1);
  const float* v1row = sV + (lane + 32) * (D + 1);
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float ka[4], kb[4], va[4], vb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ka[e] = k0row[d + e]; kb[e] = k1row[d + e];
      va[e] = v0row[d + e]; vb[e] = v1row[d + e];
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float4 q4 = *reinterpret_cast<const float4*>(qrow + i * D + d);
      const float4 o4 = *reinterpret_cast<const float4*>(dorow + i * D + d);
      const float qe[4] = {q4.x, q4.y, q4.z, q4.w};
      const float oe[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][0] = fmaf(qe[e], ka[e], s[i][0]);
        s[i][1] = fmaf(qe[e], kb[e], s[i][1]);
        dp[i][0] = fmaf(oe[e], va[e], dp[i][0]);
        dp[i][1] = fmaf(oe[e], vb[e], dp[i][1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = row0 + i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = col0 + 32 * j;
      bool ok = kvok[j] && row < p.S;
      if (p.causal) ok = ok && col <= row;
      if (p.window > 0) ok = ok && row - col < p.window;
      if (p.segs != nullptr) ok = ok && qseg[i] == kseg[j];
      const float sv = ok ? s[i][j] * p.scale : NEG_INF;
      pr[i][j] = expf(sv - lse[i]);
      ds[i][j] = pr[i][j] * (dp[i][j] - delta[i]) * p.scale;
    }
  }
}

// lse, delta and segment id of the warp's q rows (0 past the end of S)
__device__ __forceinline__ void load_rows(const Params& p, int b, int h, int row0,
                                          float (&lse)[ROWS], float (&delta)[ROWS],
                                          int (&qseg)[ROWS]) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = row0 + i;
    const bool in = row < p.S;
    const long long at = ((long long)b * p.H + h) * p.S + row;
    lse[i] = in ? p.lse[at] : 0.f;
    delta[i] = in ? p.delta[at] : 0.f;
    qseg[i] = (in && p.segs != nullptr) ? p.segs[(long long)b * p.S + row] : 0;
  }
}

// validity and segment id of the lane's two kv columns
__device__ __forceinline__ void load_cols(const Params& p, int b, int col0,
                                          bool (&kvok)[2], int (&kseg)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = col0 + 32 * j;
    kvok[j] = col < p.Skv;
    kseg[j] = 0;
    if (kvok[j] && p.mask != nullptr) kvok[j] = p.mask[(long long)b * p.Skv + col] > 0.f;
    // segment ids need Skv == S (checked by the wrapper)
    if (col < p.Skv && p.segs != nullptr) kseg[j] = p.segs[(long long)b * p.S + col];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_fma_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                    // [BQ][D]
  float* sdO = sQ + BQ * D;            // [BQ][D]
  float* sK = sdO + BQ * D;            // [BKV][D + 1]
  float* sV = sK + BKV * (D + 1);      // [BKV][D + 1]
  float* sdS = sV + BKV * (D + 1);     // [BQ][BKV]

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  const T* __restrict__ dout = static_cast<const T*>(p.dout);
  T* __restrict__ dq = static_cast<T*>(p.dq);

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);    // GQA: kv head = q head // group
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int DJ = D / 32;

  load_tile<T, D, D>(sQ, q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.S, tid);
  load_tile<T, D, D>(sdO, dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0, p.S, tid);

  const int row0 = q0 + warp * ROWS;
  float lse[ROWS], delta[ROWS];
  int qseg[ROWS];
  load_rows(p, b, h, row0, lse, delta, qseg);

  // the forward's tile range: up to the causal limit of the tile's last
  // row, from the band edge of its first row
  int kv_end = p.Skv;
  if (p.causal) kv_end = min(kv_end, min(q0 + BQ, p.S));
  int kv_start = 0;
  if (p.window > 0) kv_start = max(0, q0 - p.window + 1);
  const int t_lo = kv_start / BKV;
  const int t_hi = (kv_end + BKV - 1) / BKV;

  float acc[ROWS][DJ];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BKV;
    __syncthreads();   // the previous tile's sK reads are done (and sQ, sdO are loaded)
    load_tile<T, D, D + 1>(sK, k + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, p.Skv, tid);
    load_tile<T, D, D + 1>(sV, v + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, p.Skv, tid);
    __syncthreads();

    bool kvok[2];
    int kseg[2];
    load_cols(p, b, k0 + lane, kvok, kseg);
    float pr[ROWS][2], ds[ROWS][2];
    tile_p_ds<D>(p, sQ, sdO, sK, sV, warp * ROWS, lane, row0, k0 + lane, lse, delta,
                 qseg, kvok, kseg, pr, ds);
    // ds is cast to K's type before the ds K product, as on the TPU
    float* dsrow = sdS + warp * ROWS * BKV;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      dsrow[i * BKV + lane] = round_to<T>(ds[i][0]);
      dsrow[i * BKV + lane + 32] = round_to<T>(ds[i][1]);
    }
    __syncwarp();

    // dQ += dS K: lane owns columns lane + 32*j of its warp's rows
#pragma unroll 2
    for (int c = 0; c < BKV; ++c) {
      float kk[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kk[j] = sK[c * (D + 1) + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float dsc = dsrow[i * BKV + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsc, kk[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = row0 + i;
    if (row >= p.S) continue;
    T* out = dq + (((long long)b * p.S + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[lane + 32 * j] = from_f<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_fma_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                    // [BQ][D]
  float* sdO = sQ + BQ * D;            // [BQ][D]
  float* sK = sdO + BQ * D;            // [BKV][D + 1]
  float* sV = sK + BKV * (D + 1);      // [BKV][D + 1]
  float* sP = sV + BKV * (D + 1);      // [BQ][BKV]
  float* sdS = sP + BQ * BKV;          // [BQ][BKV]

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  const T* __restrict__ dout = static_cast<const T*>(p.dout);
  T* __restrict__ dk = static_cast<T*>(p.dk);
  T* __restrict__ dv = static_cast<T*>(p.dv);

  const int group = p.H / p.Hkv;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int k0 = blockIdx.x * BKV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int DJ = D / 32;

  load_tile<T, D, D + 1>(sK, k + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, p.Skv, tid);
  load_tile<T, D, D + 1>(sV, v + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, p.Skv, tid);
  bool kvok[2];
  int kseg[2];
  load_cols(p, b, k0 + lane, kvok, kseg);

  // q tiles that can see this kv tile: from the diagonal (row >= column)
  // down to the window's far edge (row - column < window)
  const int num_q = (p.S + BQ - 1) / BQ;
  int qt_lo = 0, qt_hi = num_q;
  if (p.causal) qt_lo = min(k0 / BQ, num_q);
  if (p.window > 0) qt_hi = min(num_q, (k0 + BKV - 1 + p.window - 1) / BQ + 1);

  // the warp owns kv columns warp*ROWS.., the lane head-dim columns lane + 32*j
  float acc_k[ROWS][DJ], acc_v[ROWS][DJ];
#pragma unroll
  for (int c = 0; c < ROWS; ++c)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[c][j] = acc_v[c][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;      // the q heads of this kv head, in turn
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // the previous tile's reads are done (and sK, sV are loaded)
      load_tile<T, D, D>(sQ, q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.S, tid);
      load_tile<T, D, D>(sdO, dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0, p.S, tid);
      __syncthreads();

      const int row0 = q0 + warp * ROWS;
      float lse[ROWS], delta[ROWS];
      int qseg[ROWS];
      load_rows(p, b, h, row0, lse, delta, qseg);
      float pr[ROWS][2], ds[ROWS][2];
      tile_p_ds<D>(p, sQ, sdO, sK, sV, warp * ROWS, lane, row0, k0 + lane, lse, delta,
                   qseg, kvok, kseg, pr, ds);
      // p is cast to dO's type and ds to Q's before the products, as on the TPU
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = (warp * ROWS + i) * BKV;
        sP[r + lane] = round_to<T>(pr[i][0]);
        sP[r + lane + 32] = round_to<T>(pr[i][1]);
        sdS[r + lane] = round_to<T>(ds[i][0]);
        sdS[r + lane + 32] = round_to<T>(ds[i][1]);
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's q rows
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        const float4* p4 = reinterpret_cast<const float4*>(sP + i * BKV + warp * ROWS);
        const float4* s4 = reinterpret_cast<const float4*>(sdS + i * BKV + warp * ROWS);
        const float4 pa = p4[0], pb = p4[1], sa = s4[0], sb = s4[1];
        const float pc[ROWS] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
        const float sc[ROWS] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
        float ov[DJ], qv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          ov[j] = sdO[i * D + lane + 32 * j];
          qv[j] = sQ[i * D + lane + 32 * j];
        }
#pragma unroll
        for (int c = 0; c < ROWS; ++c) {
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            acc_v[c][j] = fmaf(pc[c], ov[j], acc_v[c][j]);
            acc_k[c][j] = fmaf(sc[c], qv[j], acc_k[c][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < ROWS; ++c) {
    const int col = k0 + warp * ROWS + c;
    if (col >= p.Skv) continue;
    const long long at = (((long long)b * p.Skv + col) * p.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[at + lane + 32 * j] = from_f<T>(acc_k[c][j]);
      dv[at + lane + 32 * j] = from_f<T>(acc_v[c][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq_fma(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BQ * D + 2 * BKV * (D + 1) + BQ * BKV);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_fma_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  flash_bwd_dq_fma_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_fma(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BQ * D + 2 * BKV * (D + 1) + 2 * BQ * BKV);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_fma_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Skv + BKV - 1) / BKV, p.B * p.Hkv);
  flash_bwd_dkv_fma_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dk/dv for bfloat16 / float16: the tensor-core design
// ---------------------------------------------------------------------------

constexpr int MMA_NT = 128;           // threads per CTA: 4 warps x 16 keys
constexpr float LOG2E = 1.4426950408889634f;

// q rows per tile: 32, so that dK and dV (16 keys x D in fp32: 128
// registers a thread together at head dim 128) and the S^T and dP^T tiles
// fit in registers without spilling, and at head dim 64 in the 168
// registers of three CTAs per SM (0.62 ms at the gpt2-1.5b training shape
// on the H100, against 0.66 with 64-row tiles at 232 registers)
constexpr int DKV_QT = 32;

template <typename T, int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K and V [64][D + PAD]; two stages of Q and dO [QT][D + PAD] and of the
  // tile's lse, delta (fp32) and q-row segment ids; the keys' validity and
  // segment ids
  return sizeof(T) * (2 * BKV + 4 * DKV_QT) * (D + flash_mma::PAD)
      + 2 * DKV_QT * (2 * sizeof(float) + sizeof(int)) + 2 * BKV * sizeof(int);
}

// at most 168 registers at head dim 64, so that an SM holds three CTAs
template <int D> __host__ __device__ constexpr int dkv_min_ctas() { return D == 64 ? 3 : 1; }

template <typename T, int D>
__global__ void __launch_bounds__(MMA_NT, dkv_min_ctas<D>()) flash_bwd_dkv_mma_kernel(const Params p) {
  using namespace flash_mma;
  constexpr int QT = DKV_QT;          // q rows per tile
  constexpr int LD = D + PAD;          // shared row pitch, elements
  constexpr int CH = D / 8;            // 16-byte chunks per row
  constexpr int KS = D / 16;           // k16 steps over the head dim
  constexpr int NQ = QT / 8;           // n8 tiles of S^T (q rows)
  constexpr int DN = D / 8;            // n8 tiles of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);                  // [BKV][LD]
  T* sV = sK + BKV * LD;                                   // [BKV][LD]
  T* sQO = sV + BKV * LD;                                  // [2][Q, dO][QT][LD]
  float* sLse = reinterpret_cast<float*>(sQO + 4 * QT * LD);   // [2][QT]
  float* sDelta = sLse + 2 * QT;                               // [2][QT]
  int* sQseg = reinterpret_cast<int*>(sDelta + 2 * QT);        // [2][QT]
  int* sKok = sQseg + 2 * QT;                                  // [BKV]
  int* sKseg = sKok + BKV;                                     // [BKV]

  const int group = p.H / p.Hkv;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int k0 = blockIdx.x * BKV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kw = k0 + warp * 16;       // the warp's first key; the thread's
                                       // keys are kw + g and kw + g + 8

  const T* kbase = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  for (int i = tid; i < BKV * CH; i += MMA_NT) {
    const int r = i / CH, c = (i % CH) * 8, col = k0 + r;
    const long long row = min(col, p.Skv - 1);
    cp_async16(sK + r * LD + c, kbase + row * p.k_ss + c, col < p.Skv);
    cp_async16(sV + r * LD + c, vbase + row * p.v_ss + c, col < p.Skv);
  }
  // the tile's key validity and segment ids, read on masked tiles only
  if (tid < BKV) {
    const int col = k0 + tid;
    bool ok = col < p.Skv;
    if (ok && p.mask != nullptr) ok = p.mask[(long long)b * p.Skv + col] > 0.f;
    sKok[tid] = ok;
    // segment ids need Skv == S (checked by the wrapper)
    sKseg[tid] = (col < p.Skv && p.segs != nullptr) ? p.segs[(long long)b * p.S + col] : 0;
  }
  const bool kv_need = p.mask != nullptr || k0 + BKV > p.Skv;

  // q tiles that can see this kv tile: from the diagonal (row >= column)
  // down to the window's far edge (row - column < window)
  const int num_q = (p.S + QT - 1) / QT;
  int qt_lo = 0, qt_hi = num_q;
  if (p.causal) qt_lo = min(k0 / QT, num_q);
  if (p.window > 0) qt_hi = min(num_q, (k0 + BKV - 1 + p.window - 1) / QT + 1);
  const int n_q = max(0, qt_hi - qt_lo);
  const int total = group * n_q;       // (q head of the group, q tile) pairs

  auto load_q = [&](int i, int st) {
    const int hq = hk * group + i / n_q;
    const int q0 = (qt_lo + i % n_q) * QT;
    T* dQ = sQO + st * 2 * QT * LD;
    T* dO = dQ + QT * LD;
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + hq * p.q_sh;
    const T* ob = static_cast<const T*>(p.dout) + b * p.do_sb + hq * p.do_sh;
    for (int c = tid; c < QT * CH; c += MMA_NT) {
      const int r = c / CH, d = (c % CH) * 8, row = q0 + r;
      const long long rr = min(row, p.S - 1);
      cp_async16(dQ + r * LD + d, qb + rr * p.q_ss + d, row < p.S);
      cp_async16(dO + r * LD + d, ob + rr * p.do_ss + d, row < p.S);
    }
    if (tid < QT) {
      const int row = q0 + tid;
      const long long rr = min(row, p.S - 1);
      const long long at = ((long long)b * p.H + hq) * p.S + rr;
      cp_async4(sLse + st * QT + tid, p.lse + at, row < p.S);
      cp_async4(sDelta + st * QT + tid, p.delta + at, row < p.S);
      if (p.segs != nullptr)
        cp_async4(sQseg + st * QT + tid, p.segs + (long long)b * p.S + rr, row < p.S);
    }
  };

  if (total > 0) load_q(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float acc_k[DN][4], acc_v[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int i = 0; i < total; ++i) {
    const int st = i & 1;
    if (i + 1 < total) load_q(i + 1, st ^ 1);   // lands while this tile computes
    cp_async_commit();
    const int q0 = (qt_lo + i % n_q) * QT;
    const T* sQ = sQO + st * 2 * QT * LD;
    const T* sdO = sQ + QT * LD;
    const float* lse = sLse + st * QT;
    const float* delta = sDelta + st * QT;
    const int* qseg = sQseg + st * QT;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x QT q rows per warp
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, sK, LD, warp * 16, kk * 16, lane);
      load_a(av, sV, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int jj = 0; jj < NQ / 2; ++jj) {
        uint32_t bq[4], bo[4];
        load_b_nk(bq, sQ, LD, jj * 16, kk * 16, lane);
        load_b_nk(bo, sdO, LD, jj * 16, kk * 16, lane);
        mma16816<T>(s[2 * jj], ak, bq[0], bq[1]);
        mma16816<T>(s[2 * jj + 1], ak, bq[2], bq[3]);
        mma16816<T>(dp[2 * jj], av, bo[0], bo[1]);
        mma16816<T>(dp[2 * jj + 1], av, bo[2], bo[3]);
      }
    }

    // P^T = exp(S^T * scale - lse) under the forward's masks, and
    // dS^T = P^T (dP^T - delta) * scale; element e of a tile is key
    // kw + g + 8 (e / 2), q row q0 + 8 j + 2 t4 + e % 2
    const bool need = kv_need || p.segs != nullptr || q0 + QT > p.S
        || (p.causal && q0 < kw + 15)
        || (p.window > 0 && q0 + QT - 1 - kw >= p.window);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t4 + (e & 1), row = q0 + c;
        const int hh = e >> 1, key = kw + g + 8 * hh;
        float x = s[j][e] * p.scale;
        if (need) {
          const int kc = warp * 16 + g + 8 * hh;   // the key's place in the tile
          bool ok = sKok[kc] && row < p.S;
          if (p.causal) ok = ok && key <= row;
          if (p.window > 0) ok = ok && row - key < p.window;
          if (p.segs != nullptr) ok = ok && qseg[c] == sKseg[kc];
          if (!ok) x = NEG_INF;
        }
        const float pr = exp2_ftz((x - lse[c]) * LOG2E);
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - delta[c]) * p.scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q: P^T rounded to dO's type and dS^T to
    // Q's in registers (the A operands), dO and Q read by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      uint32_t ap[4], ads[4];
      c_to_a<T>(ap, s[2 * kk], s[2 * kk + 1]);
      c_to_a<T>(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int jj = 0; jj < DN / 2; ++jj) {
        uint32_t bo[4], bq[4];
        load_b_kn(bo, sdO, LD, kk * 16, jj * 16, lane);
        load_b_kn(bq, sQ, LD, kk * 16, jj * 16, lane);
        mma16816<T>(acc_v[2 * jj], ap, bo[0], bo[1]);
        mma16816<T>(acc_v[2 * jj + 1], ap, bo[2], bo[3]);
        mma16816<T>(acc_k[2 * jj], ads, bq[0], bq[1]);
        mma16816<T>(acc_k[2 * jj + 1], ads, bq[2], bq[3]);
      }
    }
    cp_async_wait_all();   // the next tile has landed ...
    __syncthreads();       // ... for every thread, and stage st is free
  }

  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kw + g + 8 * hh;
    if (key >= p.Skv) continue;
    const long long at = (((long long)b * p.Skv + key) * p.Hkv + hk) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + n * 8) =
          pack2<T>(acc_k[n][2 * hh], acc_k[n][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + n * 8) =
          pack2<T>(acc_v[n][2 * hh], acc_v[n][2 * hh + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dkv_mma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dkv_mma_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Skv + BKV - 1) / BKV, p.B * p.Hkv);
  flash_bwd_dkv_mma_kernel<T, D><<<grid, MMA_NT, smem, stream>>>(p);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// dq for bfloat16 / float16: the tensor-core design
// ---------------------------------------------------------------------------

// Keys per kv tile, as K1-fwd's fwd_kt: 32 at head dim 64, 64 at 128.
// Q stays in registers as A fragments; dO's are read again from shared
// memory at every kv tile: holding them too took the head-dim-64 kernel
// past the 168 registers of three CTAs per SM and the head-dim-128 one
// past 255, both spilling, and two CTAs per SM at head dim 64 (no spill)
// were slower, as were 64-key tiles there (PERF.md, PR 6).
template <int D> __host__ __device__ constexpr int dq_kt() { return D == 64 ? 32 : 64; }
template <int D> __host__ __device__ constexpr int dq_min_ctas() { return D == 64 ? 3 : 2; }

template <typename T, int D>
constexpr size_t dq_mma_smem_bytes() {
  constexpr int KT = dq_kt<D>();
  // Q and dO [64][D + PAD], two stages of K and V [KT][D + PAD], two
  // stages of the tile's key mask (fp32) and key segment ids
  return sizeof(T) * (2 * BQ + 4 * KT) * (D + flash_mma::PAD)
      + 2 * KT * (sizeof(float) + sizeof(int));
}

// SEGS: whether segment ids are given (a template parameter, as in the
// forward, so that the kernel without them carries none of their work)
template <typename T, int D, bool SEGS>
__global__ void __launch_bounds__(MMA_NT, dq_min_ctas<D>()) flash_bwd_dq_mma_kernel(const Params p) {
  using namespace flash_mma;
  constexpr int KT = dq_kt<D>();       // keys per kv tile
  constexpr int LD = D + PAD;          // shared row pitch, elements
  constexpr int CH = D / 8;            // 16-byte chunks per row
  constexpr int KS = D / 16;           // k16 steps over the head dim
  constexpr int NJ = KT / 8;           // n8 tiles of S and dP (keys)
  constexpr int DN = D / 8;            // n8 tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);                  // [BQ][LD]
  T* sdO = sQ + BQ * LD;                                   // [BQ][LD]
  T* sKV = sdO + BQ * LD;                                  // [2][K, V][KT][LD]
  float* sMask = reinterpret_cast<float*>(sKV + 4 * KT * LD);   // [2][KT]
  int* sKseg = reinterpret_cast<int*>(sMask + 2 * KT);          // [2][KT]

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);    // GQA: kv head = q head // group
  // causal: the last q tiles see the most keys, so they launch first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int qw = q0 + warp * 16;       // the warp's first row; the thread's
                                       // rows are qw + g and qw + g + 8

  const T* qbase = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* obase = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kbase = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < BQ * CH; i += MMA_NT) {
    const int r = i / CH, c = (i % CH) * 8, s = q0 + r;
    const long long rr = min(s, p.S - 1);
    cp_async16(sQ + r * LD + c, qbase + rr * p.q_ss + c, s < p.S);
    cp_async16(sdO + r * LD + c, obase + rr * p.do_ss + c, s < p.S);
  }

  // the forward's tile range: up to the causal limit of the tile's last
  // row, from the band edge of its first row
  int kv_end = p.Skv;
  if (p.causal) kv_end = min(kv_end, min(q0 + BQ, p.S));
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

  // lse, delta and segment id of the thread's two rows (0 past S: such a
  // row's Q and dO are zero, so its dS is zero and it is not written)
  float lse[2], delta[2];
  int qseg[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = qw + g + 8 * hh;
    const bool in = row < p.S;
    const long long at = ((long long)b * p.H + h) * p.S + row;
    lse[hh] = in ? p.lse[at] : 0.f;
    delta[hh] = in ? p.delta[at] : 0.f;
    qseg[hh] = (SEGS && in) ? p.segs[(long long)b * p.S + row] : 0;
  }

  if (t_lo < t_hi) load_kv(t_lo, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a(qf[kk], sQ, LD, warp * 16, kk * 16, lane);

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

    // S = Q K^T and dP = dO V^T: 16 rows x KT keys per warp
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ao[4];   // dO's A fragment, from shared memory
      load_a(ao, sdO, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        uint32_t bk[4], bv[4];
        load_b_nk(bk, sK, LD, jj * 16, kk * 16, lane);
        load_b_nk(bv, sV, LD, jj * 16, kk * 16, lane);
        mma16816<T>(s[2 * jj], qf[kk], bk[0], bk[1]);
        mma16816<T>(s[2 * jj + 1], qf[kk], bk[2], bk[3]);
        mma16816<T>(dp[2 * jj], ao, bv[0], bv[1]);
        mma16816<T>(dp[2 * jj + 1], ao, bv[2], bv[3]);
      }
    }

    // P = exp(S * scale - lse) under the forward's masks (masked scores
    // -1e30, as in the forward: a row with no valid key has lse ~ -1e30
    // and p = 1, harmless since its dO, and so its dS, is zero) and
    // dS = P (dP - delta) * scale; element e of a tile is row
    // qw + g + 8 (e / 2), key k0 + 8 j + 2 t4 + e % 2
    const bool need = p.mask != nullptr || SEGS || k0 + KT > p.Skv
        || (p.causal && k0 + KT - 1 > qw)
        || (p.window > 0 && qw + 15 - k0 >= p.window);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        float x = s[j][e] * p.scale;
        if (need) {
          const int c = j * 8 + 2 * t4 + (e & 1), col = k0 + c;
          const int row = qw + g + 8 * hh;
          bool ok = col < p.Skv;
          if (p.causal) ok = ok && col <= row;
          if (p.window > 0) ok = ok && row - col < p.window;
          if (p.mask != nullptr) ok = ok && sMask[st * KT + c] > 0.f;
          if constexpr (SEGS) ok = ok && sKseg[st * KT + c] == qseg[hh];
          if (!ok) x = NEG_INF;
        }
        const float pr = exp2_ftz((x - lse[hh]) * LOG2E);
        s[j][e] = pr * (dp[j][e] - delta[hh]) * p.scale;
      }
    }

    // dQ += dS K: dS rounded to q's type in registers (the A operand), K
    // read by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t a[4];
      c_to_a<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int jj = 0; jj < DN / 2; ++jj) {
        uint32_t bf[4];
        load_b_kn(bf, sK, LD, kk * 16, jj * 16, lane);
        mma16816<T>(acc[2 * jj], a, bf[0], bf[1]);
        mma16816<T>(acc[2 * jj + 1], a, bf[2], bf[3]);
      }
    }
    cp_async_wait_all();   // tile t+1 has landed ...
    __syncthreads();       // ... for every thread, and stage st is free
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = qw + g + 8 * hh;
    if (row >= p.S) continue;
    T* out = dq + (((long long)b * p.S + row) * p.H + h) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8) = pack2<T>(acc[n][2 * hh], acc[n][2 * hh + 1]);
  }
}

template <typename T, int D, bool SEGS>
cudaError_t launch_dq_mma_kernel(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dq_mma_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<T, D, SEGS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  flash_bwd_dq_mma_kernel<T, D, SEGS><<<grid, MMA_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_mma(const Params& p, cudaStream_t stream) {
  return p.segs != nullptr ? launch_dq_mma_kernel<T, D, true>(p, stream)
                           : launch_dq_mma_kernel<T, D, false>(p, stream);
}

template <bool DQ>
int dispatch(const Params& p, int dtype, int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the design by dtype, for dq and dk/dv alike: float32 on the CUDA
  // cores (TF32 would miss its tolerance), bfloat16 and float16 on the
  // tensor cores
#define DS_CASE(code, T, D, DESIGN)                                    \
  if (dtype == code && head_dim == D)                                  \
    return DQ ? launch_dq_##DESIGN<T, D>(p, s) : launch_dkv_##DESIGN<T, D>(p, s);
  DS_CASE(0, float, 64, fma)
  DS_CASE(0, float, 128, fma)
  DS_CASE(1, __nv_bfloat16, 64, mma)
  DS_CASE(1, __nv_bfloat16, 128, mma)
  DS_CASE(2, __half, 64, mma)
  DS_CASE(2, __half, 128, mma)
#undef DS_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. head_dim: 64 or 128.
// window <= 0: none. mask ([B, Skv] fp32) and segs ([B, S] int32) may be
// null. Each returns the CUDA error of its launch (0 on success).
extern "C" int ds_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, const float* mask, const int* segs, void* dq, int dtype, int B,
    int S, int Skv, int H, int Hkv, int head_dim, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, int window, void* stream) {
  Params p{q, k, v, dout, lse, delta, mask, segs, dq, nullptr, nullptr, B, S, Skv, H, Hkv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
           scale, causal, window};
  return dispatch<true>(p, dtype, head_dim, stream);
}

extern "C" int ds_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, const float* mask, const int* segs, void* dk, void* dv, int dtype,
    int B, int S, int Skv, int H, int Hkv, int head_dim, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, int window, void* stream) {
  Params p{q, k, v, dout, lse, delta, mask, segs, nullptr, dk, dv, B, S, Skv, H, Hkv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
           scale, causal, window};
  return dispatch<false>(p, dtype, head_dim, stream);
}
