// Fused q8_0 dequant + matmul: out (M, N) = x (M, K) @ (codes * scales).
//
// Replaces: ggml_experiments_tpu/quant/pallas_kernels.py `_qmatmul_2d`
// (pallas_call at :253, body `_q8_kernel` :106) for qtype q8_0.
//
// Layout (quant/qtensor.py): codes int8 (Kp, ldc), scales f32 (Kp/32, ldc),
// Kp % 32 == 0; ldc is the lane-padded column count, N <= ldc the logical one.
//
// Bound on an H100 at the reference shape (M=1024, K=1024, N=3072): 6.4
// GFLOP against 3.2 MB of codes + 4 MB of x + 12.6 MB of output. At f32
// (CUDA cores, 67 TFLOP/s) the operations bound it (~96 us); at bf16 the
// tensor cores would make it memory-bound (~6 us).
//
// Design: one 64x64 output tile per block, 256 threads with a 4x4 register
// tile each. K is walked one whole q8_0 block (32 rows) at a time: the int8
// codes and their row of scales are read once into shared memory and
// dequantized there, so weights cross the memory bus in their compressed
// form, as on the TPU. Both operands are rounded to bf16 when bf16 is set
// (the TPU kernel's `_dot` semantics); every product and sum is f32. This is
// the simple, correct form: CUDA-core FMAs, no mma/wgmma, no async copies.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTM = 64;
constexpr int kTN = 64;
constexpr int kTK = 32;  // one q8_0 block
constexpr int kThreads = 256;

__device__ __forceinline__ float round_cd(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__global__ void __launch_bounds__(kThreads) qmatmul_q8_0_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ codes,
    const float* __restrict__ scales, float* __restrict__ out, int M, int K,
    int N, int ldc, int bf16) {
  __shared__ float xs[kTK][kTM + 1];  // x tile, transposed: xs[k][m]; +1: no bank conflicts
  __shared__ float ws[kTK][kTN];  // dequantized weight tile
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
      float v = 0.f;
      if (n < N && k < K) {
        v = (float)codes[(size_t)k * ldc + n] * scales[(size_t)(k / 32) * ldc + n];
      }
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

}  // namespace

extern "C" int gxt_qmatmul_q8_0(const float* x, const int8_t* codes,
                                const float* scales, float* out, int M, int K,
                                int N, int ldc, int bf16, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  qmatmul_q8_0_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, codes, scales, out, M, K, N, ldc, bf16);
  return (int)cudaGetLastError();
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
