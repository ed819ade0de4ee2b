// Single-pass multi-head attention over whole rows (L <= a few hundred).
//
//   gxt_flash_mha  replaces ggml_experiments_tpu/ops/flash_attention.py
//                  `_flash_core_call` (pallas_call :104; body `_mha_kernel` :45)
//
// What it computes, per sequence i and head h, as the TPU body does: q is
// scaled in its own dtype (q * scale, the scale first rounded to that dtype);
// s = q . k_h^T summed in f32 and rounded to the compute dtype; p = exp(s -
// rowmax) in the compute dtype (the difference and the exp each rounded);
// denom = sum of p in f32; ctx = p . v_h in f32; out = ctx * (1 / denom),
// rounded to the compute dtype. At f32 nothing rounds. Heads are channel
// slices of width dh = C / H (the TPU kernel's masked full-width dots give
// the same sums).
//
// Bound on an H100 at the main path's shapes (bp = 512 sequences, L = 256 /
// 64 / 16, C = 144 / 192 / 240, 4 heads): 4 L^2 C operations a sequence
// against 4 L C values moved, so at L = 256 the operations bound it (at f32,
// the route that reaches this kernel on the main path, FMA on CUDA cores:
// 67 TFLOP/s; no TF32) and at L = 16 the bytes do.
//
// Design: a block of 128 threads takes G = max(1, 128 / L) consecutive
// (sequence, head) pairs; their k and v head slices are staged in shared
// memory as f32, each row padded with zeros to DHP (16, 32, 48 or 64)
// floats. A thread owns one query row: its scaled q slice and its f32
// context accumulator live in registers. Because p must be rounded after
// the subtraction of the TRUE row max, the row is walked twice: pass one
// computes the rounded scores and their max, pass two recomputes each score
// (the same operations in the same order give the same value), forms p,
// sums it and accumulates p . v. All threads of a pair read the same k and v
// row at a time, so the shared-memory reads are broadcasts. No tensor cores:
// the f32 route has no f32 tensor-core product without TF32, and the bf16
// route (off the main path) shares the code.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// rounding to the compute dtype, kept as f32
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int npairs;  // bp * H
  int L, C, H, dh, G;
  float scale;
};

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads) flash_mha_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
  const int L = a.L, C = a.C, H = a.H, dh = a.dh;
  const int pair0 = blockIdx.x * a.G;
  const int ng = min(a.G, a.npairs - pair0);
  float* ks = smem;                             // [G][L][DHP]
  float* vs = smem + (size_t)a.G * L * DHP;     // [G][L][DHP]

  for (int i = threadIdx.x; i < ng * L * DHP; i += blockDim.x) {
    const int d = i % DHP, j = (i / DHP) % L, g = i / (DHP * L);
    const int p = pair0 + g, seq = p / H, h = p % H;
    float kv = 0.f, vv = 0.f;
    if (d < dh) {
      const size_t off = ((size_t)seq * L + j) * C + (size_t)h * dh + d;
      kv = to_f(k[off]);
      vv = to_f(v[off]);
    }
    ks[i] = kv;
    vs[i] = vv;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < ng * L; r += blockDim.x) {
    const int g = r / L, row = r % L;
    const int p = pair0 + g, seq = p / H, h = p % H;
    const size_t qoff = ((size_t)seq * L + row) * C + (size_t)h * dh;
    float qv[DHP];
#pragma unroll
    for (int d = 0; d < DHP; ++d) qv[d] = d < dh ? rnd<T>(to_f(q[qoff + d]) * a.scale) : 0.f;
    const float4* kg = reinterpret_cast<const float4*>(ks + (size_t)g * L * DHP);
    const float4* vg = reinterpret_cast<const float4*>(vs + (size_t)g * L * DHP);

    float m = -INFINITY;
    for (int j = 0; j < L; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DHP / 4; ++d4) {
        const float4 kk = kg[j * (DHP / 4) + d4];
        s = fmaf(qv[4 * d4], kk.x, s);
        s = fmaf(qv[4 * d4 + 1], kk.y, s);
        s = fmaf(qv[4 * d4 + 2], kk.z, s);
        s = fmaf(qv[4 * d4 + 3], kk.w, s);
      }
      m = fmaxf(m, rnd<T>(s));
    }

    float acc[DHP];
#pragma unroll
    for (int d = 0; d < DHP; ++d) acc[d] = 0.f;
    float den = 0.f;
    for (int j = 0; j < L; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DHP / 4; ++d4) {
        const float4 kk = kg[j * (DHP / 4) + d4];
        s = fmaf(qv[4 * d4], kk.x, s);
        s = fmaf(qv[4 * d4 + 1], kk.y, s);
        s = fmaf(qv[4 * d4 + 2], kk.z, s);
        s = fmaf(qv[4 * d4 + 3], kk.w, s);
      }
      const float pj = rnd<T>(expf(rnd<T>(__fsub_rn(rnd<T>(s), m))));
      den = __fadd_rn(den, pj);
#pragma unroll
      for (int d4 = 0; d4 < DHP / 4; ++d4) {
        const float4 vv = vg[j * (DHP / 4) + d4];
        acc[4 * d4] = fmaf(pj, vv.x, acc[4 * d4]);
        acc[4 * d4 + 1] = fmaf(pj, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(pj, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(pj, vv.w, acc[4 * d4 + 3]);
      }
    }
    const float inv = __fdiv_rn(1.f, den);
#pragma unroll
    for (int d = 0; d < DHP; ++d)
      if (d < dh) out[qoff + d] = from_f<T>(__fmul_rn(acc[d], inv));
  }
}

int dh_pad(int dh) {
  if (dh <= 16) return 16;
  if (dh <= 32) return 32;
  if (dh <= 48) return 48;
  if (dh <= 64) return 64;
  return -1;
}

int group_of(int L) { return L >= kThreads ? 1 : kThreads / L; }

size_t smem_bytes(int L, int dh) {
  return (size_t)2 * group_of(L) * L * dh_pad(dh) * sizeof(float);
}

template <typename T, int DHP>
int launch_t(const Args& a, size_t smem, void* stream) {
  auto kernel = flash_mha_kernel<T, DHP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.npairs + a.G - 1) / a.G;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, size_t smem, void* stream) {
  switch (dh_pad(a.dh)) {
    case 16: return launch_t<T, 16>(a, smem, stream);
    case 32: return launch_t<T, 32>(a, smem, stream);
    case 48: return launch_t<T, 48>(a, smem, stream);
    case 64: return launch_t<T, 64>(a, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Bytes of dynamic shared memory a launch at (L, C, H) needs, or -1 where
// the head width is past the kernel's 64: the wrapper holds it against the
// device's limit before it launches.
extern "C" long long gxt_flash_mha_smem(int L, int C, int H) {
  if (L <= 0 || H <= 0 || C % H || dh_pad(C / H) < 0) return -1;
  return (long long)smem_bytes(L, C / H);
}

// q, k, v, out: (bp, L, C), f32 (is_bf16 = 0) or bf16; heads are channel
// slices of C / H. `scale` is 1/sqrt(C/H) already rounded to the dtype.
extern "C" int gxt_flash_mha(const void* q, const void* k, const void* v, void* out, int bp,
                             int L, int C, int H, float scale, int is_bf16, void* stream) {
  if (bp <= 0 || L <= 0) return 0;
  if (H <= 0 || C % H || dh_pad(C / H) < 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.npairs = bp * H;
  a.L = L; a.C = C; a.H = H; a.dh = C / H;
  a.G = group_of(L);
  a.scale = scale;
  const size_t smem = smem_bytes(L, a.dh);
  return is_bf16 ? launch<bf16>(a, smem, stream) : launch<float>(a, smem, stream);
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
