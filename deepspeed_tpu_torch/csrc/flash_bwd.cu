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
// What this first design does about it: the TPU grids carry an accumulator
// in scratch across a sequential axis. Here that axis is a loop inside the
// CTA, and the accumulator stays in registers and is written once, so
// there are no atomics and two runs give the same bits.
//   dq:  one CTA per (batch*head, 64-row q tile) walks the kv tiles from
//        the window's lower edge to the causal limit.
//   dkv: one CTA per (batch*kv head, 64-column kv tile) walks the q tiles
//        that can see it (from the diagonal down to the window's far edge)
//        and, under grouped-query attention, does so for each q head of
//        its group in turn inside the same CTA: the group's sum is taken in
//        the fp32 registers, with no buffer of per-q-head partials.
// Tiles are staged in shared memory as fp32 and the products run on the
// CUDA cores in fp32 FMA, one code path for fp32, bf16 and fp16, as in the
// forward kernel. p is rounded to dO's type before p^T dO and ds to q's
// type before ds K and ds^T Q, where the TPU kernels round them. Moving the
// products onto the tensor cores is later work.
//
// Layout: q, dO [B, S, H, D] and k, v [B, Skv, Hkv, D] read through element
// strides (last dimension contiguous); dq [B, S, H, D] and dk, dv
// [B, Skv, Hkv, D] contiguous. Ragged S and Skv are masked here. A row
// with no valid key has lse ~ -1e30 and p = 1 on its masked entries, as in
// the plain version: garbage by contract, harmless once dO is zero there.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

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
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Params p) {
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
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const Params p) {
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
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BQ * D + 2 * BKV * (D + 1) + BQ * BKV);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BQ * D + 2 * BKV * (D + 1) + 2 * BQ * BKV);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Skv + BKV - 1) / BKV, p.B * p.Hkv);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool DQ>
int dispatch(const Params& p, int dtype, int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_CASE(code, T, D)                                            \
  if (dtype == code && head_dim == D)                                  \
    return DQ ? launch_dq<T, D>(p, s) : launch_dkv<T, D>(p, s);
  DS_CASE(0, float, 64)
  DS_CASE(0, float, 128)
  DS_CASE(1, __nv_bfloat16, 64)
  DS_CASE(1, __nv_bfloat16, 128)
  DS_CASE(2, __half, 64)
  DS_CASE(2, __half, 128)
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
