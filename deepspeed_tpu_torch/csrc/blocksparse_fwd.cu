// Block-sparse attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/sparse_attention/
// blocksparse.py `_bs_fwd_kernel`, launched by `_bs_pallas_fwd`: attention
// restricted to a [H, nb, nb] block layout, compiled on the host into a
// table of the active key blocks of every (head, query-block row), `lut`
// [H, nb, L] (zero-padded to the longest row, L) with the true count per
// row, `nnz` [H, nb]. Online softmax in fp32, causal masking from global
// row and column ids, p rounded to the input dtype before P.V, and a row
// with no active key writes zeros.
//
// What bounds it on an H100: ~4*D flops per (query, key) pair that the
// layout keeps, against q/k/v/o read or written once. At the fixed layout
// BERT uses (block 16, ~67 active blocks per row at S = 4096, D = 64) it
// is bound by operations (989 TFLOP/s bf16 on the tensor cores).
//
// What this first design does about it: the TPU grid walks the table's
// slots in order on one core with the accumulator in VMEM scratch; here
// one CTA owns 16 query rows of one (batch, head, query block) and a loop
// inside the CTA walks the row's `nnz` active key blocks (never the
// zero padding up to L, which would visit key block 0 again). Each active
// K and V block (block x D) is copied into shared memory in the input
// dtype; each query row is held by 8 threads, each owning a contiguous
// eighth of the channels of q and of the fp32 accumulator in registers
// and reading its eighth of a key or value row with one 16-byte load, so a
// score is 8 partial dot products summed by three shuffles. Keys are taken 16 columns at a time through the
// online softmax. A causal CTA stops at the first 16 columns that lie
// above all of its rows. The products run on the CUDA cores in fp32 FMA
// (no tensor cores yet, no loads in flight ahead of use): one code path
// for bf16, fp16 and fp32, and the arithmetic of the plain version. A
// block of 32 to 128 rows is taken by 2 to 8 CTAs, each loading the same
// K/V blocks.
//
// Layout: q/k/v [B, S, H, D] read through element strides (the last
// dimension contiguous; the wrapper guarantees 16-byte aligned rows), o
// [B, S, H, D] contiguous. Masked scores take -1e30 and p = 0 there, as in
// the TPU kernel, so that a row with no valid key ends with l = 0 and
// writes 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int RG = 16;           // query rows per CTA
constexpr int TPR = 8;           // threads per query row
constexpr int NT = RG * TPR;     // threads per CTA
constexpr int CK = 16;           // key columns per online-softmax step
constexpr float NEG_INF = -1e30f;
constexpr int GENERIC = 0;       // the DPT of the instantiation for any D / 8

struct Params {
  const void* q; const void* k; const void* v;
  const int* lut; const int* nnz;
  void* o;
  int B, S, H, D, block, L;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
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

// N consecutive elements of T (from global or shared memory) widened to
// fp32. EXACT: N is the count, loaded by 16- or 8-byte vectors where N
// elements fill them (the caller keeps them aligned); otherwise the first
// n < N elements by element loads and zeros after them.
template <typename T, int N, bool EXACT>
__device__ __forceinline__ void load_chunk(const T* src, float* dst, int n) {
  constexpr int BYTES = N * sizeof(T);
  constexpr int PER16 = 16 / sizeof(T);
  if constexpr (EXACT && BYTES % 16 == 0) {
#pragma unroll
    for (int v = 0; v < N / PER16; ++v) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[v];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER16; ++i) dst[v * PER16 + i] = to_f(e[i]);
    }
  } else if constexpr (EXACT && BYTES == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = i < n ? to_f(src[i]) : 0.f;
  }
}

// DPT: the channels each thread owns, D / 8, contiguous. 4, 8 and 16 (D =
// 32, 64, 128) are exact instantiations with vector loads; GENERIC serves
// every other D up to 128 with a run-time count and element loads. The
// arrays stay in registers (every index is a compile-time constant).
template <typename T, int DPT, bool CAUSAL>
__global__ void __launch_bounds__(NT) blocksparse_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, BM = p.block;
  T* sK = reinterpret_cast<T*>(smem_raw);   // [BM][D], the input dtype
  T* sV = sK + BM * D;                        // [BM][D]
  const int groups = BM / RG;                 // CTAs per query block
  const int qi = blockIdx.x / groups;
  const int r0 = (blockIdx.x % groups) * RG;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid / TPR, j = tid % TPR;
  constexpr int R = DPT == GENERIC ? 16 : DPT;   // registers per array
  constexpr bool EXACT = DPT != GENERIC;
  const int dpt = D / TPR;                    // == DPT but for GENERIC
  const int row = qi * BM + r0 + r;           // global query row
  const int last_row = qi * BM + r0 + RG - 1;  // of this CTA

  float qr[R], acc[R];
  load_chunk<T, R, EXACT>(static_cast<const T*>(p.q) + b * p.q_sb + row * p.q_ss +
                     h * p.q_sh + j * dpt, qr, dpt);
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  const int hq = h * (p.S / BM) + qi;
  const int n = p.nnz[hq];
  const int* lut = p.lut + (long long)hq * p.L;
  const T* kbase = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  constexpr int VE = 16 / sizeof(T);
  const int vec_per_row = D / VE;

  for (int li = 0; li < n; ++li) {
    const int k0 = lut[li] * BM;              // first key row of the block
    if (CAUSAL && k0 > last_row) continue;    // above every row: p = 0
    __syncthreads();                          // the previous block is consumed
    for (int x = tid; x < BM * vec_per_row; x += NT) {
      const int c = x / vec_per_row, col = (x % vec_per_row) * VE;
      reinterpret_cast<uint4*>(sK + c * D + col)[0] =
          *reinterpret_cast<const uint4*>(kbase + (long long)(k0 + c) * p.k_ss + col);
      reinterpret_cast<uint4*>(sV + c * D + col)[0] =
          *reinterpret_cast<const uint4*>(vbase + (long long)(k0 + c) * p.v_ss + col);
    }
    __syncthreads();

    for (int c0 = 0; c0 < BM; c0 += CK) {
      if (CAUSAL && k0 + c0 > last_row) break;
      float s[CK];
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        float kc[R];
        load_chunk<T, R, EXACT>(sK + (c0 + c) * D + j * dpt, kc, dpt);
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) a = fmaf(qr[i], kc[i], a);
        s[c] = a;
      }
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        s[c] += __shfl_xor_sync(0xffffffffu, s[c], 1);
        s[c] += __shfl_xor_sync(0xffffffffu, s[c], 2);
        s[c] += __shfl_xor_sync(0xffffffffu, s[c], 4);
      }
      float mc = NEG_INF;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        s[c] *= p.scale;
        if (CAUSAL && row < k0 + c0 + c) s[c] = NEG_INF;
        mc = fmaxf(mc, s[c]);
      }
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float pc = s[c] <= 0.5f * NEG_INF ? 0.f : expf(s[c] - m_new);
        ps += pc;
        s[c] = to_f(from_f<T>(pc));           // p.astype(v.dtype)
      }
      l = alpha * l + ps;
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] *= alpha;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        float vc[R];
        load_chunk<T, R, EXACT>(sV + (c0 + c) * D + j * dpt, vc, dpt);
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = fmaf(s[c], vc[i], acc[i]);
      }
      m = m_new;
    }
  }

  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* orow = static_cast<T*>(p.o) + (((long long)b * p.S + row) * p.H + h) * D + j * dpt;
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (i < dpt) orow[i] = from_f<T>(acc[i] * inv);
}

template <typename T, int DPT, bool CAUSAL>
cudaError_t launch_kernel(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 2 * p.block * p.D;
  cudaError_t err = cudaFuncSetAttribute(blocksparse_fwd_kernel<T, DPT, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S / p.block) * (p.block / RG), p.H, p.B);
  blocksparse_fwd_kernel<T, DPT, CAUSAL><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DPT>
cudaError_t launch_causal(const Params& p, bool causal, cudaStream_t stream) {
  return causal ? launch_kernel<T, DPT, true>(p, stream)
                : launch_kernel<T, DPT, false>(p, stream);
}

template <typename T>
cudaError_t launch(const Params& p, bool causal, cudaStream_t stream) {
  const int dpt = p.D / TPR;
  if (dpt == 4) return launch_causal<T, 4>(p, causal, stream);
  if (dpt == 8) return launch_causal<T, 8>(p, causal, stream);
  if (dpt == 16) return launch_causal<T, 16>(p, causal, stream);
  return launch_causal<T, GENERIC>(p, causal, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. block: 16, 32, 64 or 128;
// head_dim: a multiple of 8 up to 128; S a multiple of block. lut
// [H, S / block, L] and nnz [H, S / block] int32 on the device. The
// strides are in elements and, like the pointers, must keep every row 16
// bytes aligned. Returns the CUDA error of the launch (0 on success).
extern "C" int ds_blocksparse_fwd(const void* q, const void* k, const void* v, const int* lut,
                                  const int* nnz, void* o, int dtype, int B, int S, int H,
                                  int head_dim, int block, int L, long long q_sb, long long q_ss,
                                  long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh, float scale,
                                  int causal, void* stream) {
  if ((block != 16 && block != 32 && block != 64 && block != 128) || head_dim % 8 != 0 ||
      head_dim <= 0 || head_dim > 128 || S % block != 0 || L < 1)
    return cudaErrorInvalidValue;
  Params p{q, k, v, lut, nnz, o, B, S, H, head_dim, block, L,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, causal != 0, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, causal != 0, s);
  if (dtype == 2) return launch<__half>(p, causal != 0, s);
  return cudaErrorInvalidValue;
}
