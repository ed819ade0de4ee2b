// Multi-head attention, k and v of a head staged in shared memory whole or
// streamed through it in chunks of keys.
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
// What bounds it on an H100 at the main path's shapes (bp = 512 sequences,
// L = 256 / 64 / 16, C = 144 / 192 / 240, 4 heads, f32; L = 1024 at C = 144
// for 512 px images): 4 L^2 C operations a sequence against 4 L C values
// moved. The products run as 3xTF32 on the tensor cores, whose bound is the
// tf32 rate / 3 (165 TFLOP/s): L >= 256 is bound by operations, L = 64 and
// 16 by bytes. What limits the kernel is the work around the mmas: each k
// and v fragment is split into its two tf32 parts by every warp that reads
// it, and each 32-key step's row max, exponentials and rescale form one
// dependent chain, with 2 blocks of 8 warps an SM (registers) to hide it.
//
// Design: a warp owns 16 query rows of one (sequence, head) pair; a block of
// 8 warps stages the k and v head slices of its pairs (8 pairs at L = 16, 2
// at L = 64, one pair split over L / 128 blocks past L = 128) in shared
// memory as f32 rows of S floats (dh rounded up to S = 4 x odd: 36 stays 36,
// 48 -> 52, 60 stays 60, so fragment loads hit 32 distinct banks), with
// 16-byte cp.async copies. Up to kWholeKeys keys a pair's rows are staged
// whole; past that the block streams them through the same buffer in
// chunks of kWholeKeys keys (all warps stage a chunk, meet, take its keys,
// meet again), so the shared memory no longer grows with L (73 KB at dh =
// 36, 139 KB at 64) and any L runs. Chunks end on the key loop's 32-key
// steps, so the arithmetic is the whole rows' (at bf16 the same bits); at
// f32 a streamed launch also takes each step's P.v as a fresh sum added in
// f32, which holds the longer chain of sums to f32 accuracy.
// Scores and context are mma.sync m16n8k8 tf32 tiles (the head width padded
// to the k-step of 8 only inside the fragments, with q zero there): a thread
// holds a 16-row x 32-key score tile spread over the warp, and the same
// registers become p . v's A operand (keys 2t, 2t + 1 of each 8-key tile
// stand for k-columns t, t + 4, with v read in the same order). At f32
// every product is 3xTF32 (each operand split into a tf32 high part and its
// remainder, three products, small terms first), so the sums keep f32
// accuracy, and every score is computed once: a running row max rescales
// the context and the denominator (online softmax, with the fast
// exponential), which is what lets the keys stream in one pass. At bf16 the
// operands are exact in tf32, so one product suffices, and p must be
// rounded after subtracting the TRUE row max: the keys are walked twice
// (streamed twice past kWholeKeys), the first pass taking the max of the
// rounded scores, the second recomputing them (the same operations in the
// same order give the same values) to form p, its sum and p . v. Row sums
// go across the 4 lanes of a quad in a fixed order, so two launches are
// bit-equal.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace {

using gxt::bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 4;  // 8-key tiles per step of the key loop
constexpr int kWholeKeys = 256;   // keys staged at once (a multiple of 8 kChunk)

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
  int L, C, H, dh;
  int S;       // staged row stride (floats)
  int G;       // pairs a block stages (when a pair fits one block)
  int bpp;     // blocks a pair is split over (1: G pairs a block)
  int KC;      // keys staged at once: Lp (whole rows) or kWholeKeys (streamed)
  int vec;     // k and v rows load in groups of 4 elements
  float scale;
};

// Stage keys j0 .. j0 + n - 1 of k and v of pairs pair0 .. pair0 + ng - 1
// as f32 rows of S floats, a pair's k and v in buffers of KC rows: keys past
// L and columns past dh are zeros.
template <typename T>
__device__ __forceinline__ void stage(const Args& a, float* smem, int pair0, int ng, int j0,
                                      int n) {
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const size_t buf = (size_t)a.KC * a.S;
  if (a.vec) {
    const int s4 = a.S / 4;
    for (int i = threadIdx.x; i < ng * n * s4; i += kThreads) {
      const int c4 = i % s4, j = (i / s4) % n, gp = i / (s4 * n);
      const int p = pair0 + gp, seq = p / a.H, h = p % a.H, d = 4 * c4;
      const bool ok = j0 + j < a.L && d < a.dh;
      const size_t off = ok ? ((size_t)seq * a.L + j0 + j) * a.C + (size_t)h * a.dh + d : 0;
      float* kd = smem + (size_t)gp * 2 * buf + (size_t)j * a.S + d;
      if constexpr (std::is_same<T, float>::value) {
        gxt::cp_async16(kd, kp + off, ok ? 16 : 0);
        gxt::cp_async16(kd + buf, vp + off, ok ? 16 : 0);
      } else {
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
        if (ok) {
          const uint2 kr = __ldg(reinterpret_cast<const uint2*>(kp + off));
          const uint2 vr = __ldg(reinterpret_cast<const uint2*>(vp + off));
          kv = make_float4(__uint_as_float(kr.x << 16), __uint_as_float(kr.x & 0xffff0000u),
                           __uint_as_float(kr.y << 16), __uint_as_float(kr.y & 0xffff0000u));
          vv = make_float4(__uint_as_float(vr.x << 16), __uint_as_float(vr.x & 0xffff0000u),
                           __uint_as_float(vr.y << 16), __uint_as_float(vr.y & 0xffff0000u));
        }
        *reinterpret_cast<float4*>(kd) = kv;
        *reinterpret_cast<float4*>(kd + buf) = vv;
      }
    }
    gxt::cp_async_commit();
    gxt::cp_async_wait<0>();
  } else {
    for (int i = threadIdx.x; i < ng * n * a.S; i += kThreads) {
      const int d = i % a.S, j = (i / a.S) % n, gp = i / (a.S * n);
      const int p = pair0 + gp, seq = p / a.H, h = p % a.H;
      float kv = 0.f, vv = 0.f;
      if (j0 + j < a.L && d < a.dh) {
        const size_t off = ((size_t)seq * a.L + j0 + j) * a.C + (size_t)h * a.dh + d;
        kv = to_f(kp[off]);
        vv = to_f(vp[off]);
      }
      float* kd = smem + (size_t)gp * 2 * buf + (size_t)j * a.S + d;
      kd[0] = kv;
      kd[buf] = vv;
    }
  }
}

// STREAM: the keys come in chunks of KC (a pair split over blocks, KC < Lp)
template <typename T, int DHP, bool STREAM>
__global__ void __launch_bounds__(kThreads) flash_mha_kernel(Args a) {
  constexpr int KS = DHP / 8;  // k-steps of q . k^T, 8-column tiles of p . v
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kFresh = kF32 && STREAM;   // P.v a fresh sum a 32-key step
  extern __shared__ __align__(16) float smem[];
  const int L = a.L, S = a.S, Lp = (L + 7) & ~7;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wpp = (L + 15) >> 4;  // 16-row tiles of a pair
  int pair0, ng, gw, tile;
  if (a.bpp == 1) {
    pair0 = blockIdx.x * a.G;
    ng = min(a.G, a.npairs - pair0);
    gw = warp / wpp;
    tile = warp % wpp;
  } else {
    pair0 = blockIdx.x / a.bpp;
    ng = 1;
    gw = 0;
    tile = (blockIdx.x % a.bpp) * kWarps + warp;
  }
  // whole rows: staged once; streamed: every warp stages each chunk, also
  // one whose rows are past L
  constexpr bool whole = !STREAM;
  if constexpr (whole) {
    stage<T>(a, smem, pair0, ng, 0, Lp);
    __syncthreads();
    if (gw >= ng || tile * 16 >= L) return;
  }
  const bool active = gw < ng && tile * 16 < L;

  const size_t buf = (size_t)a.KC * S;
  const float* ks = smem + (size_t)gw * 2 * buf;
  const float* vs = ks + buf;
  const int p = pair0 + gw, seq = p / a.H, h = p % a.H;
  const int row0 = tile * 16;
  const size_t base = (size_t)seq * L * a.C + (size_t)h * a.dh;

  // q fragments, scaled in q's dtype; zero past dh and past L
  uint32_t qh[KS][4], ql[KS][4];
  {
    const T* qp = static_cast<const T*>(a.q);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + g + (i & 1) * 8, d = kk * 8 + t + (i >> 1) * 4;
        float v = 0.f;
        if (row < L && d < a.dh) v = rnd<T>(__fmul_rn(to_f(qp[base + (size_t)row * a.C + d]),
                                                     a.scale));
        if constexpr (kF32) {
          gxt::split_tf32(v, qh[kk][i], ql[kk][i]);
        } else {
          qh[kk][i] = __float_as_uint(v);
          ql[kk][i] = 0u;
        }
      }
  }

  // the scores of keys j0 .. j0 + 8 * kChunk - 1 (staged from row jr),
  // rounded to the compute dtype; keys past L are -inf
  auto scores = [&](int j0, int jr, float (&s)[kChunk][4]) {
#pragma unroll
    for (int nt = 0; nt < kChunk; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      if (j0 + nt * 8 < Lp) {
        const float* kr = ks + (size_t)(jr + nt * 8 + g) * S + t;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t bh0, bh1, bl0 = 0u, bl1 = 0u;
          if constexpr (kF32) {
            gxt::split_tf32(kr[kk * 8], bh0, bl0);
            gxt::split_tf32(kr[kk * 8 + 4], bh1, bl1);
          } else {
            bh0 = __float_as_uint(kr[kk * 8]);
            bh1 = __float_as_uint(kr[kk * 8 + 4]);
          }
          gxt::mma_tf32x<kF32>(s[nt], qh[kk], ql[kk], bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = j0 + nt * 8 + 2 * t + (i & 1);
        s[nt][i] = key < L ? rnd<T>(s[nt][i]) : -INFINITY;
      }
    }
  };

  // acc += p . v over the step's keys: score tile nt is the k-step, its
  // keys 2t and 2t + 1 the k-columns t and t + 4. Streamed at f32, the
  // step's sum is fresh on the tensor cores, then added to acc in f32:
  // chained over every key, the tensor cores' sums drift (1.1e-5 of the
  // largest value against the plain version at L = 1024 on an H100, 4.7e-6
  // at 256). Whole rows (L <= 256) chain them: the fresh sum's registers
  // take the second block off a multiprocessor (0.72 -> 1.05 ms at L = 256)
  float acc[KS][4];
#pragma unroll
  for (int dt = 0; dt < KS; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  auto accumulate = [&](int j0, int jr, const float (&pm)[kChunk][4]) {
    float part[KS][4];
#pragma unroll
    for (int dt = 0; dt < KS; ++dt) part[dt][0] = part[dt][1] = part[dt][2] = part[dt][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kChunk; ++nt) {
      if (j0 + nt * 8 >= Lp) continue;
      uint32_t ph[4], pl[4] = {0u, 0u, 0u, 0u};
      const float pv[4] = {pm[nt][0], pm[nt][2], pm[nt][1], pm[nt][3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kF32) {
          gxt::split_tf32(pv[i], ph[i], pl[i]);
        } else {
          ph[i] = __float_as_uint(pv[i]);
        }
      }
      const float* vr = vs + (size_t)(jr + nt * 8 + 2 * t) * S + g;
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        uint32_t bh0, bh1, bl0 = 0u, bl1 = 0u;
        if constexpr (kF32) {
          gxt::split_tf32(vr[dt * 8], bh0, bl0);
          gxt::split_tf32(vr[S + dt * 8], bh1, bl1);
        } else {
          bh0 = __float_as_uint(vr[dt * 8]);
          bh1 = __float_as_uint(vr[S + dt * 8]);
        }
        if constexpr (kFresh) {
          gxt::mma_tf32x<true>(part[dt], ph, pl, bh0, bh1, bl0, bl1);
        } else {
          gxt::mma_tf32x<kF32>(acc[dt], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    }
    if constexpr (kFresh) {
#pragma unroll
      for (int dt = 0; dt < KS; ++dt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[dt][i] = __fadd_rn(acc[dt][i], part[dt][i]);
    }
  };

  // body(j0, jr) for each 32-key step j0 of the keys, jr its staged row:
  // whole rows as staged, else chunk by chunk (the block meets before and
  // after staging each)
  auto walk = [&](auto&& body) {
    for (int c0 = 0; c0 < Lp; c0 += a.KC) {
      const int n = min(a.KC, Lp - c0);
      if constexpr (!whole) {
        __syncthreads();
        stage<T>(a, smem, pair0, ng, c0, n);
        __syncthreads();
      }
      if (active)
        for (int j0 = c0; j0 < c0 + n; j0 += 8 * kChunk) body(j0, j0 - c0);
    }
  };

  auto quad_max = [](float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  };

  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8
  float den0 = 0.f, den1 = 0.f;          // this thread's share of the row sums
  float s[kChunk][4];
  if constexpr (kF32) {
    // one pass: a running max rescales what has been summed so far
    walk([&](int j0, int jr) {
      scores(j0, jr, s);
      float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kChunk; ++nt) {
        c0 = fmaxf(c0, fmaxf(s[nt][0], s[nt][1]));
        c1 = fmaxf(c1, fmaxf(s[nt][2], s[nt][3]));
      }
      // the chunk's first key is < L, so the new maxima are finite
      const float n0 = fmaxf(m0, quad_max(c0)), n1 = fmaxf(m1, quad_max(c1));
      // __expf: a few ulp from expf, inside f32's 1e-5 check (the bf16
      // route below keeps expf, whose result it rounds)
      const float r0 = __expf(m0 - n0), r1 = __expf(m1 - n1);
      m0 = n0;
      m1 = n1;
      den0 = __fmul_rn(den0, r0);
      den1 = __fmul_rn(den1, r1);
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        acc[dt][0] = __fmul_rn(acc[dt][0], r0);
        acc[dt][1] = __fmul_rn(acc[dt][1], r0);
        acc[dt][2] = __fmul_rn(acc[dt][2], r1);
        acc[dt][3] = __fmul_rn(acc[dt][3], r1);
      }
#pragma unroll
      for (int nt = 0; nt < kChunk; ++nt) {
        s[nt][0] = __expf(__fsub_rn(s[nt][0], m0));
        s[nt][1] = __expf(__fsub_rn(s[nt][1], m0));
        s[nt][2] = __expf(__fsub_rn(s[nt][2], m1));
        s[nt][3] = __expf(__fsub_rn(s[nt][3], m1));
        den0 = __fadd_rn(den0, __fadd_rn(s[nt][0], s[nt][1]));
        den1 = __fadd_rn(den1, __fadd_rn(s[nt][2], s[nt][3]));
      }
      accumulate(j0, jr, s);
    });
  } else {
    // pass one: the true row max of the rounded scores
    walk([&](int j0, int jr) {
      scores(j0, jr, s);
#pragma unroll
      for (int nt = 0; nt < kChunk; ++nt) {
        m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
        m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
      }
    });
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    // pass two: the same scores again, p rounded after the true max
    walk([&](int j0, int jr) {
      scores(j0, jr, s);
#pragma unroll
      for (int nt = 0; nt < kChunk; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float m = i < 2 ? m0 : m1;
          s[nt][i] = rnd<T>(expf(rnd<T>(__fsub_rn(s[nt][i], m))));
        }
        den0 = __fadd_rn(den0, __fadd_rn(s[nt][0], s[nt][1]));
        den1 = __fadd_rn(den1, __fadd_rn(s[nt][2], s[nt][3]));
      }
      accumulate(j0, jr, s);
    });
  }
  den0 = __fadd_rn(den0, __shfl_xor_sync(0xffffffffu, den0, 1));
  den0 = __fadd_rn(den0, __shfl_xor_sync(0xffffffffu, den0, 2));
  den1 = __fadd_rn(den1, __shfl_xor_sync(0xffffffffu, den1, 1));
  den1 = __fadd_rn(den1, __shfl_xor_sync(0xffffffffu, den1, 2));
  if (!active) return;
  const float inv0 = __fdiv_rn(1.f, den0), inv1 = __fdiv_rn(1.f, den1);
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int dt = 0; dt < KS; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + (i >> 1) * 8, d = dt * 8 + 2 * t + (i & 1);
      if (row < L && d < a.dh)
        out[base + (size_t)row * a.C + d] = from_f<T>(__fmul_rn(acc[dt][i], i < 2 ? inv0 : inv1));
    }
}

// the staged row stride: dh rounded up to 4 x an odd number of floats
int row_stride(int dh) {
  int s = (dh + 3) & ~3;
  return (s / 4) % 2 ? s : s + 4;
}

struct Launch {
  int G, bpp, KC, blocks;
  size_t smem;
};

// A pair's rows whole up to kWholeKeys keys, else streamed in chunks of
// kWholeKeys (only where a pair is split over blocks: L > 128)
Launch plan(int npairs, int L, int dh) {
  const int Lp = (L + 7) & ~7, wpp = (L + 15) / 16;
  Launch l;
  l.KC = Lp <= kWholeKeys ? Lp : kWholeKeys;
  if (wpp <= kWarps) {
    l.G = kWarps / wpp;
    l.bpp = 1;
    l.blocks = (npairs + l.G - 1) / l.G;
  } else {
    l.G = 1;
    l.bpp = (wpp + kWarps - 1) / kWarps;
    l.blocks = npairs * l.bpp;
  }
  // + 8 floats: the last k row's fragment reads may run up to 4 past it
  l.smem = ((size_t)l.G * 2 * l.KC * row_stride(dh) + 8) * sizeof(float);
  return l;
}

template <typename T, int DHP>
int launch_t(const Args& a, const Launch& l, void* stream) {
  auto kernel = l.KC < ((a.L + 7) & ~7) ? flash_mha_kernel<T, DHP, true>
                                         : flash_mha_kernel<T, DHP, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<l.blocks, kThreads, l.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, const Launch& l, void* stream) {
  switch ((a.dh + 7) / 8) {
    case 1: return launch_t<T, 8>(a, l, stream);
    case 2: return launch_t<T, 16>(a, l, stream);
    case 3: return launch_t<T, 24>(a, l, stream);
    case 4: return launch_t<T, 32>(a, l, stream);
    case 5: return launch_t<T, 40>(a, l, stream);
    case 6: return launch_t<T, 48>(a, l, stream);
    case 7: return launch_t<T, 56>(a, l, stream);
    case 8: return launch_t<T, 64>(a, l, stream);
  }
  return (int)cudaErrorInvalidValue;
}

bool takes(int L, int C, int H) { return L > 0 && H > 0 && C % H == 0 && C / H <= 64; }

}  // namespace

// Bytes of dynamic shared memory a launch at (L, C, H) needs (at most 139
// KB: streamed keys past kWholeKeys), or -1 where the head width is past the
// kernel's 64: the wrapper holds it against the device's limit before it
// launches.
extern "C" long long gxt_flash_mha_smem(int L, int C, int H) {
  if (!takes(L, C, H)) return -1;
  return (long long)plan(1, L, C / H).smem;
}

// q, k, v, out: (bp, L, C), f32 (is_bf16 = 0) or bf16; heads are channel
// slices of C / H. `scale` is 1/sqrt(C/H) already rounded to the dtype.
extern "C" int gxt_flash_mha(const void* q, const void* k, const void* v, void* out, int bp,
                             int L, int C, int H, float scale, int is_bf16, void* stream) {
  if (bp <= 0 || L <= 0) return 0;
  if (!takes(L, C, H)) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.npairs = bp * H;
  a.L = L; a.C = C; a.H = H; a.dh = C / H;
  a.S = row_stride(a.dh);
  const Launch l = plan(a.npairs, L, a.dh);
  a.G = l.G;
  a.bpp = l.bpp;
  a.KC = l.KC;
  const uintptr_t align = is_bf16 ? 8 : 16;
  a.vec = a.dh % 4 == 0 && C % 4 == 0 && reinterpret_cast<uintptr_t>(k) % align == 0 &&
          reinterpret_cast<uintptr_t>(v) % align == 0;
  a.scale = scale;
  return is_bf16 ? launch<bf16>(a, l, stream) : launch<float>(a, l, stream);
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
