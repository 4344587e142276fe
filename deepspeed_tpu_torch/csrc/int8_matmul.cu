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
// any value (the edges of each tile are masked here).
//
// What bounds it on an H100. Serving decode (M = 8 slots, or 1) reads
// each int8 weight once and does 2*M flops with it, far below the 295
// flop/byte ridge: the least time is the weight bytes over 3.35 TB/s (one
// llama-7b layer, 202.4 M weights: 60 us). A prefill chunk (M = 256) does
// 512 flops per weight byte: the least time is the flops over the bf16
// tensor-core rate.
//
// What this design does about it. For bfloat16 x the products run on the
// tensor cores (`mma.sync` m16n8k16, bf16 in, fp32 accumulators): int8 ->
// bf16 is exact, so the weight is widened in registers right before the
// product, the TPU kernel's in-VMEM dequant. One CTA owns BN = 128 output
// columns and BM rows (16 when M <= 16, else 64: one M tile covers every
// decode batch, so each weight byte is read from device memory once per
// call) and walks its share of K in BK = 64 row stages: 16-byte coalesced
// loads of the next stage go out before the current stage's products.
// Where the column and row tiles are too few to fill the card (decode;
// attn_out has 32 column tiles for 132 SMs) K is split over several CTAs,
// which write fp32 partials that a second kernel sums in split order
// (no atomics: two launches give the same bits) and scales. float32 x
// runs on the CUDA cores (`i8mm_f32_kernel`, 4 x 4 outputs per thread
// from shared memory): TF32 would lose the float32 path's precision.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per CTA, 4 warps
// tensor-core kernel (bf16 x)
constexpr int BN = 128;          // output columns per CTA
constexpr int BK = 64;           // k rows per stage
constexpr int XPAD = 8;          // bf16 of padding per shared x row
constexpr int WPAD = 16;         // bytes of padding per shared weight row
// CUDA-core kernel (float32 x)
constexpr int FBM = 32, FBN = 64, FBK = 32;

struct Params {
  const void* x; const int8_t* q; const float* scale; void* out; float* part;
  int M, N, K;
  int kps;                       // k stages per split
  int splits;
  int vec_x, vec_q;              // 16-byte loads allowed: aligned rows and base
};

__device__ __forceinline__ uint32_t pack_bf16(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn((float)lo, (float)hi);   // .x low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one output element: the scaled sum, or the split's fp32 partial
template <typename T>
__device__ __forceinline__ void put(const Params& p, int m, int n, float acc) {
  if (m >= p.M || n >= p.N) return;
  if (p.splits == 1) {
    static_cast<T*>(p.out)[(long long)m * p.N + n] = from_f<T>(acc * p.scale[n]);
  } else {
    p.part[((long long)blockIdx.z * p.M + m) * p.N + n] = acc;
  }
}

// grid (ceil(N / BN), ceil(M / BM), splits); warp w owns columns
// [32 w, 32 w + 32) of the CTA's tile (four n8 tiles) and all BM rows
template <int BM>
__global__ void __launch_bounds__(NT) i8mm_tc_kernel(const Params p) {
  constexpr int MT = BM / 16;                  // m16 tiles per warp
  constexpr int XCH = BM * (BK / 8) / NT;      // 16-byte x chunks per thread
  constexpr int WCH = BK * (BN / 16) / NT;     // 16-byte weight chunks per thread
  __shared__ __align__(16) __nv_bfloat16 xs[BM][BK + XPAD];
  __shared__ __align__(16) int8_t ws[BK][BN + WPAD];

  const __nv_bfloat16* __restrict__ x = static_cast<const __nv_bfloat16*>(p.x);
  const int8_t* __restrict__ q = p.q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int ktiles = (p.K + BK - 1) / BK;
  const int kt0 = blockIdx.z * p.kps;
  const int kt1 = min(kt0 + p.kps, ktiles);

  uint4 xr[XCH], wr[WCH];
  auto load = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int c = tid + i * NT, row = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int m = m0 + row, k = k0 + col;
      if (p.vec_x && m < p.M && k + 8 <= p.K) {
        xr[i] = *reinterpret_cast<const uint4*>(x + (long long)m * p.K + k);
      } else {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (m < p.M && k + e < p.K) ? x[(long long)m * p.K + k + e]
                                          : __float2bfloat16(0.f);
        xr[i] = *reinterpret_cast<uint4*>(v);
      }
    }
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int c = tid + i * NT, row = c / (BN / 16), col = (c % (BN / 16)) * 16;
      const int k = k0 + row, n = n0 + col;
      if (p.vec_q && k < p.K && n + 16 <= p.N) {
        wr[i] = *reinterpret_cast<const uint4*>(q + (long long)k * p.N + n);
      } else {
        __align__(16) int8_t v[16];
#pragma unroll
        for (int e = 0; e < 16; ++e)
          v[e] = (k < p.K && n + e < p.N) ? q[(long long)k * p.N + n + e] : 0;
        wr[i] = *reinterpret_cast<uint4*>(v);
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int wn = warp * 32;
  if (kt0 < kt1) load(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int c = tid + i * NT;
      *reinterpret_cast<uint4*>(&xs[c / (BK / 8)][(c % (BK / 8)) * 8]) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int c = tid + i * NT;
      *reinterpret_cast<uint4*>(&ws[c / (BN / 16)][(c % (BN / 16)) * 16]) = wr[i];
    }
    __syncthreads();
    if (kt + 1 < kt1) load(kt + 1);            // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 8 * j + g;
        b[j][0] = pack_bf16(ws[kk + 2 * t][n], ws[kk + 2 * t + 1][n]);
        b[j][1] = pack_bf16(ws[kk + 2 * t + 8][n], ws[kk + 2 * t + 9][n]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = i * 16 + g, c = kk + 2 * t;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(&xs[r][c]);
        a[1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][c]);
        a[2] = *reinterpret_cast<const uint32_t*>(&xs[r][c + 8]);
        a[3] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][c + 8]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
    __syncthreads();
  }

  // accumulator (i, j): rows m0 + 16 i + g (+8), columns n0 + wn + 8 j + 2 t (+1)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + i * 16 + g, n = n0 + wn + 8 * j + 2 * t;
      put<__nv_bfloat16>(p, m, n, acc[i][j][0]);
      put<__nv_bfloat16>(p, m, n + 1, acc[i][j][1]);
      put<__nv_bfloat16>(p, m + 8, n, acc[i][j][2]);
      put<__nv_bfloat16>(p, m + 8, n + 1, acc[i][j][3]);
    }
}

// grid (ceil(N / FBN), ceil(M / FBM), splits); thread (ty, tx) of 8 x 16
// owns rows ty + 8 i and columns tx + 16 j, i, j < 4
__global__ void __launch_bounds__(NT) i8mm_f32_kernel(const Params p) {
  __shared__ float xs[FBK][FBM + 1];           // transposed: row r of x is column r
  __shared__ float ws[FBK][FBN];
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * FBN, m0 = blockIdx.y * FBM;
  const int ktiles = (p.K + FBK - 1) / FBK;
  const int kt0 = blockIdx.z * p.kps;
  const int kt1 = min(kt0 + p.kps, ktiles);
  float acc[4][4] = {};
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * FBK;
    for (int e = tid; e < FBM * FBK; e += NT) {
      const int r = e / FBK, kk = e % FBK, m = m0 + r, k = k0 + kk;
      xs[kk][r] = (m < p.M && k < p.K) ? x[(long long)m * p.K + k] : 0.f;
    }
    for (int e = tid; e < FBK * FBN; e += NT) {
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
    for (int j = 0; j < 4; ++j) put<float>(p, m0 + ty + 8 * i, n0 + tx + 16 * j, acc[i][j]);
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

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// k stages per split and the number of splits: enough CTAs for about four
// per SM (enough weight loads in flight to cover the memory latency at
// decode), each split at least 4 stages long
void plan(int dtype, int M, int N, int K, int* kps, int* splits) {
  const int bm = dtype == 0 ? FBM : (M <= 16 ? 16 : 64);
  const int bn = dtype == 0 ? FBN : BN, bk = dtype == 0 ? FBK : BK;
  const long long tiles = (long long)((N + bn - 1) / bn) * ((M + bm - 1) / bm);
  const int ktiles = (K + bk - 1) / bk;
  long long want = (4LL * num_sms() + tiles - 1) / tiles;
  int s = (int)(want < 1 ? 1 : want);
  const int most = ktiles / 4 > 1 ? ktiles / 4 : 1;
  if (s > most) s = most;
  *kps = (ktiles + s - 1) / s;
  *splits = (ktiles + *kps - 1) / *kps;
}

}  // namespace

// The number of K splits the launch of this shape uses (1: no partial
// buffer; else the caller passes fp32 scratch of splits * M * N).
// dtype: 0 = float32 x, 1 = bfloat16 x.
extern "C" int ds_int8_matmul_splits(int dtype, int M, int N, int K) {
  int kps, splits;
  plan(dtype, M, N, K, &kps, &splits);
  return splits;
}

// Returns the CUDA error of the launches (0 on success).
extern "C" int ds_int8_matmul(const void* x, const void* q, const void* scale, void* out,
                              void* part, int dtype, int M, int N, int K, int vec_x,
                              int vec_q, void* stream) {
  Params p{x, static_cast<const int8_t*>(q), static_cast<const float*>(scale), out,
           static_cast<float*>(part), M, N, K, 0, 1, vec_x, vec_q};
  plan(dtype, M, N, K, &p.kps, &p.splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    i8mm_f32_kernel<<<dim3((N + FBN - 1) / FBN, (M + FBM - 1) / FBM, p.splits), NT, 0, s>>>(p);
  } else if (dtype == 1) {
    const dim3 grid((N + BN - 1) / BN, 1, p.splits);
    if (M <= 16) {
      i8mm_tc_kernel<16><<<grid, NT, 0, s>>>(p);
    } else {
      i8mm_tc_kernel<64><<<dim3(grid.x, (M + 63) / 64, p.splits), NT, 0, s>>>(p);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long total = (long long)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  if (dtype == 0) {
    i8mm_reduce_kernel<float><<<blocks, 256, 0, s>>>(p);
  } else {
    i8mm_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(p);
  }
  return cudaGetLastError();
}
