// Fused block dequant + matmul: out (M, N) = x (M, K) @ dequantize(W), for
// every block format (q8_0, q4_0, q4_1, q5_0, q5_1, q4_k).
//
// Replaces: ggml_experiments_tpu/quant/pallas_kernels.py `_qmatmul_2d`
// (pallas_call at :253) with its six bodies: `_q8_kernel` :106, `_q4_kernel`
// :117, `_q4_1_kernel` :129, `_q5_0_kernel` :144, `_q5_1_kernel` :156 and
// `_q4_k_kernel` :173.
//
// Layout (quant/qtensor.py), ldc = the lane-padded column count, N <= ldc:
//   codes   int8 (Kp, ldc) for q8_0, else uint8 (Kp/2, ldc): byte row
//           blk*16 + (t & 15) of block blk = k >> 5 holds block-local rows
//           t (low nibble, t < 16) and t + 16 (high nibble)
//   scales  f32 (Kp/32, ldc); q4_k: uint8 sub-block scale codes
//   mins    f32 (Kp/32, ldc) q4_1/q5_1; uint8 min codes for q4_k
//   hibits  uint8 (Kp/8, ldc) q5_0/q5_1: row blk*4 + (t & 3), bit t >> 2
//   supers  f32 (2*ns, ldc) q4_k: D = supers[blk >> 3], Mn = supers[ns + (blk >> 3)]
//
// Bound on an H100 at the reference shape (M=1024, K=1024, N=3072): 6.4
// GFLOP against 1.6-3.2 MB of planes + 4 MB of x + 12.6 MB of output. At f32
// (CUDA cores, 67 TFLOP/s) the operations bound it (~96 us); at bf16 the
// tensor cores would make it memory-bound (~6 us).
//
// Design: one kernel templated on a per-format weight decoder. One 64x64
// output tile per block, 256 threads with a 4x4 register tile each. K is
// walked one whole 32-row block at a time: the packed planes of the tile are
// read once and decoded into shared memory, so weights cross the memory bus
// in their compressed form, as on the TPU. The decoders keep the roundings of
// the plain version (multiply, round, then add the offset: never one fused
// multiply-add), so a decoded weight is bit-equal to the plain version's
// before it is rounded to bf16. Both operands are rounded to bf16 when bf16
// is set (the TPU kernel's `_dot` semantics); every product and sum is f32.
// K and N are guarded, so nothing depends on what the padding decodes to.
// The q4_k decoder walks 32-row blocks like the others and so has no need of
// whole 256-row super-blocks; the Python router still sends Kp % 256 != 0 to
// dequantize + matmul, as the TPU package does.
// This is the simple, correct form: CUDA-core FMAs, no mma/wgmma, no async
// copies.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTM = 64;
constexpr int kTN = 64;
constexpr int kTK = 32;  // one quantization block
constexpr int kThreads = 256;

__device__ __forceinline__ float round_cd(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// The planes of one weight; a decoder reads the ones its format has.
struct Planes {
  const void* codes;
  const void* scales;
  const void* mins;
  const uint8_t* hibits;
  const float* supers;
  int ldc;
  int ns;  // q4_k: super-block rows per half of `supers`

  __device__ __forceinline__ int nibble(int k, int n) const {
    const int blk = k >> 5, t = k & 31;
    const int byte = static_cast<const uint8_t*>(codes)[(size_t)(blk * 16 + (t & 15)) * ldc + n];
    return t < 16 ? (byte & 15) : (byte >> 4);
  }
  __device__ __forceinline__ int hibit(int k, int n) const {
    const int blk = k >> 5, t = k & 31;
    return (hibits[(size_t)(blk * 4 + (t & 3)) * ldc + n] >> (t >> 2)) & 1;
  }
  __device__ __forceinline__ float scale(int k, int n) const {
    return static_cast<const float*>(scales)[(size_t)(k >> 5) * ldc + n];
  }
  __device__ __forceinline__ float minv(int k, int n) const {
    return static_cast<const float*>(mins)[(size_t)(k >> 5) * ldc + n];
  }
};

struct DecQ8_0 {
  static __device__ __forceinline__ float at(const Planes& p, int k, int n) {
    const int q = static_cast<const int8_t*>(p.codes)[(size_t)k * p.ldc + n];
    return __fmul_rn((float)q, p.scale(k, n));
  }
};
struct DecQ4_0 {
  static __device__ __forceinline__ float at(const Planes& p, int k, int n) {
    return __fmul_rn((float)(p.nibble(k, n) - 8), p.scale(k, n));
  }
};
struct DecQ4_1 {
  static __device__ __forceinline__ float at(const Planes& p, int k, int n) {
    return __fadd_rn(__fmul_rn((float)p.nibble(k, n), p.scale(k, n)), p.minv(k, n));
  }
};
struct DecQ5_0 {
  static __device__ __forceinline__ float at(const Planes& p, int k, int n) {
    return __fmul_rn((float)(p.nibble(k, n) + 16 * p.hibit(k, n) - 16), p.scale(k, n));
  }
};
struct DecQ5_1 {
  static __device__ __forceinline__ float at(const Planes& p, int k, int n) {
    return __fadd_rn(__fmul_rn((float)(p.nibble(k, n) + 16 * p.hibit(k, n)), p.scale(k, n)),
                     p.minv(k, n));
  }
};
struct DecQ4_K {
  static __device__ __forceinline__ float at(const Planes& p, int k, int n) {
    const int blk = k >> 5;
    const size_t row = (size_t)blk * p.ldc + n;
    const int sb = min(blk >> 3, p.ns - 1);
    const float sc = (float)static_cast<const uint8_t*>(p.scales)[row];
    const float mc = (float)static_cast<const uint8_t*>(p.mins)[row];
    // eff_d and eff_m are their own f32 products, as in the plain version
    const float eff_d = __fmul_rn(p.supers[(size_t)sb * p.ldc + n], sc);
    const float eff_m = __fmul_rn(p.supers[(size_t)(p.ns + sb) * p.ldc + n], mc);
    return __fsub_rn(__fmul_rn((float)p.nibble(k, n), eff_d), eff_m);
  }
};

template <class Dec>
__global__ void __launch_bounds__(kThreads) qmatmul_kernel(
    const float* __restrict__ x, Planes p, float* __restrict__ out, int M, int K, int N,
    int bf16) {
  __shared__ float xs[kTK][kTM + 1];  // x tile, transposed: xs[k][m]; +1: no bank conflicts
  __shared__ float ws[kTK][kTN];      // decoded weight tile
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx + 16 * j
  const int ty = tid / 16;  // output rows ty + 16 * i
  const int m0 = blockIdx.y * kTM;
  const int n0 = blockIdx.x * kTN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kTK) {
    for (int i = tid; i < kTM * kTK; i += kThreads) {
      const int r = i / kTK, kk = i % kTK;
      const int m = m0 + r, k = k0 + kk;
      const float v = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
      xs[kk][r] = round_cd(v, bf16);
    }
    for (int i = tid; i < kTK * kTN; i += kThreads) {
      const int kk = i / kTN, c = i % kTN;
      const int n = n0 + c, k = k0 + kk;
      const float v = (n < N && k < K) ? Dec::at(p, k, n) : 0.f;
      ws[kk][c] = round_cd(v, bf16);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
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
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

template <class Dec>
int launch(const float* x, const Planes& p, float* out, int M, int K, int N, int bf16,
           void* stream) {
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  qmatmul_kernel<Dec><<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, p, out, M, K, N, bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// One entry per format. Planes a format lacks are passed as null.
#define GXT_QMATMUL_ENTRY(name, Dec)                                                        \
  extern "C" int gxt_qmatmul_##name(const float* x, const void* codes, const void* scales,   \
                                    const void* mins, const void* hibits, const void* supers, \
                                    float* out, int M, int K, int N, int ldc, int ns,        \
                                    int bf16, void* stream) {                                \
    Planes p{codes, scales, mins, static_cast<const uint8_t*>(hibits),                       \
             static_cast<const float*>(supers), ldc, ns};                                    \
    return launch<Dec>(x, p, out, M, K, N, bf16, stream);                                    \
  }

GXT_QMATMUL_ENTRY(q8_0, DecQ8_0)
GXT_QMATMUL_ENTRY(q4_0, DecQ4_0)
GXT_QMATMUL_ENTRY(q4_1, DecQ4_1)
GXT_QMATMUL_ENTRY(q5_0, DecQ5_0)
GXT_QMATMUL_ENTRY(q5_1, DecQ5_1)
GXT_QMATMUL_ENTRY(q4_k, DecQ4_K)

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
