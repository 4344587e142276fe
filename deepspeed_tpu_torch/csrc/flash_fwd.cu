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
// What this first design does about it: the TPU grid walks kv blocks in
// order on one core; here one CTA owns one (batch*head, 64-row q tile) and
// a loop inside the CTA walks the kv tiles from the window's lower edge up
// to the causal limit, so no tile above the diagonal or below the band is
// read. K and V tiles are staged in shared memory as fp32; the running
// max, sum and accumulator stay fp32 in registers. The products run on the
// CUDA cores in fp32 FMA (no tensor cores yet), which keeps bf16, fp16 and
// fp32 on one code path and makes the kernel's arithmetic that of the plain
// version; moving QK^T and PV onto wgmma is later work.
//
// Layout: q [B, S, H, D], k/v [B, Skv, Hkv, D] read through element
// strides (the last dimension contiguous), o [B, S, H, D] contiguous,
// lse [B, H, S] fp32 contiguous. Masked scores take -1e30, not -inf,
// exactly as the TPU kernel: a fully masked tile gives p = 1 everywhere,
// and the first tile with a valid key wipes that with alpha = 0. Rows
// with no valid key at all are garbage by contract.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

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
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
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
cudaError_t launch_kernel(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + BKV * (D + 1) + BKV * D + BQ * BKV)
      + (SEGS ? sizeof(int) * BQ : 0);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D, SEGS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_kernel<T, D, SEGS><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return p.segs != nullptr ? launch_kernel<T, D, true>(p, stream)
                           : launch_kernel<T, D, false>(p, stream);
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
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(p, s);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(p, s);
  if (dtype == 1 && head_dim == 64) return launch<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && head_dim == 128) return launch<__nv_bfloat16, 128>(p, s);
  if (dtype == 2 && head_dim == 64) return launch<__half, 64>(p, s);
  if (dtype == 2 && head_dim == 128) return launch<__half, 128>(p, s);
  return cudaErrorInvalidValue;
}
