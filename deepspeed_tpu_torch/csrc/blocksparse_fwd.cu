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
// Two designs, chosen by dtype in `ds_blocksparse_fwd` (a dispatch, not a
// fallback):
//
// bfloat16 and float16: `blocksparse_fwd_mma_kernel`, on the tensor cores
// (mma.sync m16n8k16, fp32 accumulate), built from flash_mma.cuh as K1-fwd
// is. A CTA owns a row group of 64 query rows of one (batch, head), 4
// warps of 16 rows: 64 / block whole query blocks at block <= 64, half a
// query block at block 128. Neighbouring query blocks mostly share their
// key blocks (the fixed layout's 4 query blocks of a 64-row group have one
// list), so the CTA walks the sorted union of its query blocks' active
// key blocks (`ulut`, built on the host) and loads each K/V block once,
// by 16-byte cp.async into a two-stage ring, steps of BS_KT keys (several
// 16-key slots make one step at block 16, half a block one at block 128).
// Each key of a step carries the bits of the warps whose query block uses
// its slot (`umask`); a warp skips a step none of whose keys it uses, and
// masks (p = 0) the keys it does not use, the causal diagonal and the
// keys past its piece. Q goes once into A fragments; S = Q K^T takes K's
// rows as the col-major B operand; the online softmax runs on the
// accumulator fragments in the log2 domain; P is rounded to V's type in
// registers and reused as the A fragment of P V, V read by ldmatrix.trans.
// Head dims that are not a multiple of 16 are zero-padded to the next one
// in shared memory (so in the fragments); only D columns are written. A
// causal CTA stops at the first union block that starts past its last
// row. Unions longer than twice the table's median are cut on the host
// into pieces of about the median (`work`, as K3 splits a long block
// walk): a piece writes its unnormalised fp32 sums, m and l to a scratch
// buffer and `blocksparse_combine_kernel` merges each split group's
// pieces in piece order, so two launches give the same bits. The CTAs of
// one (batch, head) take neighbouring block indices and share its K/V in
// L2.
//
// float32: `blocksparse_fwd_fma_kernel`, the first design, on the CUDA
// cores in fp32 FMA (TF32 tensor cores would miss the float32 tolerance
// of 1e-4): one CTA owns 16 query rows of one (batch, head, query block)
// and walks that block's `nnz` active key blocks (never the zero padding
// up to L, which would visit key block 0 again). Each active K and V
// block (block x D) is copied into shared memory; each query row is held
// by 8 threads, each owning a contiguous eighth of the channels of q and
// of the fp32 accumulator in registers and reading its eighth of a key or
// value row with one 16-byte load, so a score is 8 partial dot products
// summed by three shuffles. Keys are taken 16 columns at a time through
// the online softmax. A causal CTA stops at the first 16 columns that lie
// above all of its rows. A block of 32 to 128 rows is taken by 2 to 8
// CTAs, each loading the same K/V blocks.
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

#include "flash_mma.cuh"

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
  int causal;
  // the tensor-core design's tables (KernelPlan in blocksparse.py): ulut and
  // umask [H, G, U], work [n_work, 5], combine [n_split, 4], and the fp32
  // scratch of the split groups' partial results
  const int* ulut; const int* umask; const int* work; const int* combine;
  float* scratch;
  int G, U, n_work, n_split, n_part, lb;   // lb = log2(block)
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
__global__ void __launch_bounds__(NT) blocksparse_fwd_fma_kernel(const Params p) {
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
cudaError_t launch_fma_kernel(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 2 * p.block * p.D;
  cudaError_t err = cudaFuncSetAttribute(blocksparse_fwd_fma_kernel<T, DPT, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S / p.block) * (p.block / RG), p.H, p.B);
  blocksparse_fwd_fma_kernel<T, DPT, CAUSAL><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DPT>
cudaError_t launch_fma_causal(const Params& p, cudaStream_t stream) {
  return p.causal ? launch_fma_kernel<T, DPT, true>(p, stream)
                  : launch_fma_kernel<T, DPT, false>(p, stream);
}

template <typename T>
cudaError_t launch_fma(const Params& p, cudaStream_t stream) {
  const int dpt = p.D / TPR;
  if (dpt == 4) return launch_fma_causal<T, 4>(p, stream);
  if (dpt == 8) return launch_fma_causal<T, 8>(p, stream);
  if (dpt == 16) return launch_fma_causal<T, 16>(p, stream);
  return launch_fma_causal<T, GENERIC>(p, stream);
}

// ---------------------------------------------------------------------------
// bfloat16 / float16: the tensor-core design
// ---------------------------------------------------------------------------

constexpr int GR = 64;           // query rows of a row group (one CTA)
constexpr int MMA_NT = 128;      // threads per CTA: 4 warps x 16 rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NO_KEY = 0x7fffffff;

// keys per step of the union walk: four 16-key slots at block 16, half a
// block at block 128. Steps of 32 and 16 keys took 1.2x and 1.5x the time
// at the fixed layout (one rescale and barrier per step; PERF.md, PR 6)
constexpr int BS_KT = 64;

// CTAs an SM should hold, which bounds the registers: Q (DP / 4), O
// (DP / 2) and the S tile (BS_KT / 2) a thread
template <int DP> __host__ __device__ constexpr int mma_min_ctas() { return DP <= 64 ? 3 : 2; }

template <typename T, int DP>
constexpr size_t mma_smem_bytes() {
  // Q [64][DP + PAD], two stages of K and V [BS_KT][DP + PAD], two stages
  // of each key's index and warp bits
  return sizeof(T) * (GR + 4 * BS_KT) * (DP + flash_mma::PAD) + 2 * BS_KT * 2 * sizeof(int);
}

// DP: the head dim padded to a multiple of 16 (the depth of one mma)
template <typename T, int DP>
__global__ void __launch_bounds__(MMA_NT, mma_min_ctas<DP>()) blocksparse_fwd_mma_kernel(const Params p) {
  using namespace flash_mma;
  constexpr int KT = BS_KT;            // keys per step
  constexpr int LD = DP + PAD;         // shared row pitch, elements
  constexpr int CH = DP / 8;           // 16-byte chunks per padded row
  constexpr int KS = DP / 16;          // k16 steps over the head dim
  constexpr int NJ = KT / 8;           // n8 score tiles per step
  constexpr int DN = DP / 8;           // n8 output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);                  // [GR][LD]
  T* sKV = sQ + GR * LD;                                   // [2][K, V][KT][LD]
  int* sKey = reinterpret_cast<int*>(sKV + 4 * KT * LD);   // [2][KT] key index
  int* sBits = sKey + 2 * KT;                              // [2][KT] warp bits

  const int* w = p.work + 5 * blockIdx.x;
  const int h = w[0], grp = w[1], first = w[2], partial = w[4];
  int last = w[3];
  const int b = blockIdx.y;
  const int D = p.D, block = p.block, lb = p.lb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = grp * GR;
  const int qw = q0 + warp * 16;       // the warp's first row; the thread's
                                       // rows are qw + g and qw + g + 8
  const long long hg = (long long)h * p.G + grp;
  const int* ulut = p.ulut + hg * p.U;
  const int* umask = p.umask + hg * p.U;
  // scores are kept in the log2 domain: x = s * scale * log2(e)
  const float scale2 = p.scale * LOG2E;

  // causal: the union is ascending, so every slot from the first block
  // that starts past the group's last row on lies above all of its rows
  if (p.causal) {
    int lo = first, hi = last;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (ulut[mid] * block > q0 + GR - 1) hi = mid; else lo = mid + 1;
    }
    last = lo;
  }
  // the piece's keys, numbered in union order
  const int u_lo = first << lb, u_hi = last << lb;
  const int n_steps = (u_hi - u_lo + KT - 1) / KT;

  const T* qbase = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kbase = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  // Q rows (zero past S), the head dim zero-filled from D up to DP
  for (int i = tid; i < GR * CH; i += MMA_NT) {
    const int r = i / CH, c = (i % CH) * 8, s = q0 + r;
    const long long row = min(s, p.S - 1);
    cp_async16(sQ + r * LD + c, qbase + row * p.q_ss + (c < D ? c : 0), s < p.S && c < D);
  }

  auto load_kv = [&](int t, int st) {
    const int o0 = u_lo + t * KT;
    T* sK = sKV + st * 2 * KT * LD;
    T* sV = sK + KT * LD;
    for (int i = tid; i < KT * CH; i += MMA_NT) {
      const int r = i / CH, c = (i % CH) * 8, o = o0 + r;
      const bool in = o < u_hi;
      const long long key = in ? ((long long)ulut[o >> lb] << lb) + (o & (block - 1)) : 0;
      const int cc = c < D ? c : 0;
      cp_async16(sK + r * LD + c, kbase + key * p.k_ss + cc, in && c < D);
      cp_async16(sV + r * LD + c, vbase + key * p.v_ss + cc, in && c < D);
    }
    if (tid < KT) {
      const int o = o0 + tid;
      const bool in = o < u_hi;
      sKey[st * KT + tid] = in ? (ulut[o >> lb] << lb) + (o & (block - 1)) : NO_KEY;
      sBits[st * KT + tid] = in ? umask[o >> lb] : 0;
    }
  };

  if (n_steps > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a(qf[kk], sQ, LD, warp * 16, kk * 16, lane);

  // row statistics in the log2 domain; m stays -1e30 and l 0 while the
  // row has seen no valid key (p = 0 on masked keys, as in the TPU kernel)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    const int st = t & 1;
    if (t + 1 < n_steps) load_kv(t + 1, st ^ 1);   // lands while this step computes
    cp_async_commit();
    const T* sK = sKV + st * 2 * KT * LD;
    const T* sV = sK + KT * LD;
    const int* key = sKey + st * KT;
    const int* bits = sBits + st * KT;

    // which of the step's keys this warp uses (its query block's slots, in
    // the piece), and where they lie against its rows: warp-uniform votes
    bool all_used = true, any_used = false, above = false, below = false;
#pragma unroll
    for (int c = lane; c < KT; c += 32) {
      const bool use = (bits[c] >> warp) & 1;
      all_used = all_used && use;
      any_used = any_used || use;
      above = above || (use && key[c] > qw);
      below = below || (use && key[c] <= qw + 15);
    }
    all_used = __all_sync(0xffffffffu, all_used);
    any_used = __any_sync(0xffffffffu, any_used);
    above = __any_sync(0xffffffffu, above);
    below = __any_sync(0xffffffffu, below);
    const bool skip = !any_used || (p.causal && !below);
    const bool need = !all_used || (p.causal && above);

    if (!skip) {
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
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale2;
          if (need) {
            const int c = j * 8 + 2 * t4 + (e & 1);
            const int row = qw + g + 8 * (e >> 1);
            bool ok = (bits[c] >> warp) & 1;
            if (p.causal) ok = ok && key[c] <= row;
            if (!ok) x = NEG_INF;
          }
          s[j][e] = x;
        }
      }

      // online softmax on the fragments (element e of a tile is row
      // qw + g + 8 (e / 2)); a masked score gives p = 0, so a row with no
      // valid key keeps l = 0 and writes zeros
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m[hh];
#pragma unroll
        for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        mx = quad_max(mx);
        const float alpha = exp2_ftz(m[hh] - mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
            s[j][e] = s[j][e] <= 0.5f * NEG_INF ? 0.f : exp2_ftz(s[j][e] - mx);
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
    }
    cp_async_wait_all();   // step t+1 has landed ...
    __syncthreads();       // ... for every thread, and stage st is free
  }

  // a row group of one piece writes o; a piece of a split group writes its
  // unnormalised sums, m and l for the combine pass
  const long long plane = (long long)p.B * GR;   // rows of one partial result
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh, row = q0 + r;
    if (row >= p.S) continue;
    if (partial < 0) {
      const float inv = 1.f / (l[hh] == 0.f ? 1.f : l[hh]);
      T* orow = static_cast<T*>(p.o) + (((long long)b * p.S + row) * p.H + h) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < DN; ++n)
        if (n * 8 < D)
          *reinterpret_cast<uint32_t*>(orow + n * 8) =
              pack2<T>(acc[n][2 * hh] * inv, acc[n][2 * hh + 1] * inv);
    } else {
      const long long at = partial * plane + (long long)b * GR + r;
      float* srow = p.scratch + at * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < DN; ++n)
        if (n * 8 < D)
          *reinterpret_cast<float2*>(srow + n * 8) = make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
      if (t4 == 0) {
        float* ms = p.scratch + (long long)p.n_part * plane * D;
        ms[at] = m[hh];
        ms[p.n_part * plane + at] = l[hh];
      }
    }
  }
}

// One split row group: o = sum_i 2^(m_i - M) acc_i / sum_i 2^(m_i - M) l_i
// over its pieces i, in piece order, with M the largest m_i (a row with no
// valid key in any piece has l = 0 and writes zeros).
template <typename T>
__global__ void __launch_bounds__(MMA_NT) blocksparse_combine_kernel(const Params p) {
  const int* c = p.combine + 4 * blockIdx.x;
  const int h = c[0], grp = c[1], first = c[2], n = c[3];
  const int b = blockIdx.y, D = p.D;
  const long long plane = (long long)p.B * GR;
  const float* ms = p.scratch + (long long)p.n_part * plane * D;
  const float* ls = ms + p.n_part * plane;
  for (int i = threadIdx.x; i < GR * D; i += MMA_NT) {
    const int r = i / D, col = i % D, row = grp * GR + r;
    if (row >= p.S) continue;
    const long long at0 = first * plane + (long long)b * GR + r;
    float mx = NEG_INF;
    for (int k = 0; k < n; ++k) mx = fmaxf(mx, ms[at0 + k * plane]);
    float sum = 0.f, out = 0.f;
    for (int k = 0; k < n; ++k) {
      const long long at = at0 + k * plane;
      const float wgt = exp2f(ms[at] - mx);
      sum += wgt * ls[at];
      out += wgt * p.scratch[at * D + col];
    }
    static_cast<T*>(p.o)[(((long long)b * p.S + row) * p.H + h) * D + col] =
        from_f<T>(out / (sum == 0.f ? 1.f : sum));
  }
}

template <typename T, int DP>
cudaError_t launch_mma_kernel(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(blocksparse_fwd_mma_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  blocksparse_fwd_mma_kernel<T, DP><<<dim3(p.n_work, p.B), MMA_NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 0) return err;
  blocksparse_combine_kernel<T><<<dim3(p.n_split, p.B), MMA_NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  if (p.ulut == nullptr || p.umask == nullptr || p.work == nullptr || p.n_work < 1 ||
      p.U < 1 || p.G != (p.S + GR - 1) / GR ||
      (p.n_split > 0 && (p.combine == nullptr || p.scratch == nullptr)))
    return cudaErrorInvalidValue;
  switch ((p.D + 15) / 16) {   // the head dim padded to a multiple of 16
    case 1: return launch_mma_kernel<T, 16>(p, stream);
    case 2: return launch_mma_kernel<T, 32>(p, stream);
    case 3: return launch_mma_kernel<T, 48>(p, stream);
    case 4: return launch_mma_kernel<T, 64>(p, stream);
    case 5: return launch_mma_kernel<T, 80>(p, stream);
    case 6: return launch_mma_kernel<T, 96>(p, stream);
    case 7: return launch_mma_kernel<T, 112>(p, stream);
    case 8: return launch_mma_kernel<T, 128>(p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. block: 16, 32, 64 or 128;
// head_dim: a multiple of 8 up to 128; S a multiple of block. lut
// [H, S / block, L] and nnz [H, S / block] int32 on the device (read by the
// float32 design). ulut and umask [H, G, U], work [n_work, 5] and combine
// [n_split, 4] int32 on the device, and scratch (n_part partial results of
// 64 rows: B * 64 * (head_dim + 2) floats each), the tables of
// blocksparse.py KernelPlan, are read by the bfloat16 / float16 design;
// the float32 design takes them as null and zeros. The strides are in
// elements and, like the pointers, must keep every row 16 bytes aligned.
// Returns the CUDA error of the launch (0 on success).
extern "C" int ds_blocksparse_fwd(const void* q, const void* k, const void* v, const int* lut,
                                  const int* nnz, void* o, int dtype, int B, int S, int H,
                                  int head_dim, int block, int L, long long q_sb, long long q_ss,
                                  long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh, float scale,
                                  int causal, const int* ulut, const int* umask, const int* work,
                                  const int* combine, float* scratch, int G, int U, int n_work,
                                  int n_split, int n_part, void* stream) {
  if ((block != 16 && block != 32 && block != 64 && block != 128) || head_dim % 8 != 0 ||
      head_dim <= 0 || head_dim > 128 || S % block != 0 || L < 1)
    return cudaErrorInvalidValue;
  Params p{q, k, v, lut, nnz, o, B, S, H, head_dim, block, L,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal != 0,
           ulut, umask, work, combine, scratch, G, U, n_work, n_split, n_part,
           __builtin_ctz(block)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the design by dtype: float32 on the CUDA cores (TF32 would miss its
  // tolerance), bfloat16 and float16 on the tensor cores
  if (dtype == 0) return launch_fma<float>(p, s);
  if (dtype == 1) return launch_mma<__nv_bfloat16>(p, s);
  if (dtype == 2) return launch_mma<__half>(p, s);
  return cudaErrorInvalidValue;
}
