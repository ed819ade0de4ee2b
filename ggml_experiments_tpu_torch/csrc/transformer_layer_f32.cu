// The pre-LN ViT encoder layer at f32 on Hopper, as three kernels.
//
//   gxt_layer_ln_qkv_f32     \  together replace ggml_experiments_tpu/ops/
//   gxt_layer_attention_f32   > fused_transformer_layer.py `_fused_layer_call`
//   gxt_layer_proj_ffn_f32   /  at compute_dtype=float32 (pallas_call :184;
//                               body `_layer_kernel` :64)
//
// What the three compute (bp sequences of L tokens, T = bp*L rows; C
// channels, H heads of width dh = C/H, FFN width F): the twelve steps of the
// Python module's docstring with every rounding to the compute dtype a
// no-op, in the split of transformer_layer.cu (the bf16 form):
//   A  ln_qkv:    xf = x or x.Win; a = LN(xf); q = (a.Wq + bq) * scale,
//                 k = a.Wk + bk, v = a.Wv + bv, stored as one (T, 3*H*dhp)
//                 f32 array, heads padded to dhp = dh rounded up to 16 with
//                 zero columns;
//   B  attention: per (sequence, head) s = q.k^T, p = exp(s - rowmax) after
//                 the TRUE row max over all L keys, denom the sum of p, ctx
//                 = (p.v) * (1/denom), stored as (T, C) with the head's
//                 columns in place;
//   C  proj_ffn:  xf again (x, or x.Win recomputed); x1 = xf + ctx.Wo + bo;
//                 y = LN(x1); h1 = SiLU(y.Wi + bi); o = x1 + h1.Wo2 + bo2;
//                 optional block-final LN (block eps); optional o.Wout *
//                 bn_scale + bn_bias and SiLU.
// Every product runs as 3xTF32 on mma.sync m16n8k8 (each operand split into
// a tf32 high part and its remainder, three products, small terms first), so
// the sums keep f32 accuracy. LN statistics (mean, then the mean squared
// deviation), softmax and SiLU are f32 with every rounding written out
// (__fadd_rn / __fmul_rn, the correctly rounded reciprocal and square
// root, expf), so nothing is contracted that the plain version computes in
// two steps. No atomics and a fixed order of sums: two launches give the
// same bits.
//
// Bound on an H100 at the main path's shapes (bp = 512; (L, C, F) = (256,
// 144, 288), (64, 192, 384), (16, 240, 480)): the operations, about 232
// GFLOP a forward's nine layers at 3xTF32's 165 TFLOP/s (1.4 ms), against
// 12 bytes a token and channel in and out of each kernel.
//
// Design. At f32 one sequence's k and v at L = 256, C = 144 take 295 KB, so
// the per-sequence design of transformer_layer_seq.cu does not fit; the
// bf16 form's split does:
//   * A and C are row tiles of 32 rows over all T tokens, a block of 8
//     warps, two blocks a multiprocessor (at most 128 registers a thread).
//     The block's operands live in shared memory as f32 rows of round8(K)
//     + 4 floats (4 x odd: the tf32 fragment loads of 8 rows x 4 lanes hit
//     32 distinct banks): x (and x.Win), LN's output, ctx, x1 and the whole
//     FFN intermediate h1 (at C = 240, F = 480, Cin = 160: 124 KB). A
//     product is items of 32 rows x 32 output columns spread over the
//     warps; a warp splits each A fragment once for its 4 n-tiles and reads
//     the weights straight from global memory (L2 and L1 serve them: a
//     layer's are under 3 MB), pre-split by the wrapper into tf32 pairs in
//     the fragment order, one 16-byte load a fragment: [n][K/8][t] = (hi(k =
//     8kk + t), hi(8kk + t + 4), lo(8kk + t), lo(8kk + t + 4)). Measured on
//     an H100 (PERF.md §6), 16- and 64-row tiles, three blocks a
//     multiprocessor and loading the next k-step's weights ahead were each
//     slower.
//   * B is flash_attention.cu's f32 design on the q/k/v array: a warp owns
//     16 query rows of one (sequence, head), a block stages k and v of its
//     pairs as f32 rows of 8 ceil(dh/8) + 4 floats by cp.async (8 pairs a
//     block at L = 16, 2 at L = 64, one pair over two blocks at L = 256; a
//     16-row tile never spans two sequences, so no mask is needed), heads of
//     36 and 60 walk ceil(dh/8) k-steps with q zero past dh. The keys are
//     walked twice: once for the true row max, once (the same operations in
//     the same order give the same scores) to form p, its sum and p.v.
//   * Rows past T read zeros and are not stored.
#include "mma_common.cuh"

// Field order and types match the ctypes Structure _F32Args in
// ops/fused_transformer_layer.py.
struct LayerF32Args {
  const void *x, *qkv, *ctx, *out;
  const void *win, *wqkv, *wo, *wi, *wo2, *wout;
  const void *ln1g, *ln1b, *bqkv, *bo, *ln2g, *ln2b, *bi, *bo2, *ln3g, *ln3b, *osc, *obi;
  int T, L, Cin, ldx, C, H, dh, dhp, ldc, F, Cout, ldo, in_proj, final_ln, out_proj, out_act;
  float eps, final_eps, scale;
};

namespace {

using namespace gxt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 2;       // m-tiles of 16 rows a row tile
constexpr int kBM = 16 * kMT;
constexpr int kChunk = 4;    // 8-key tiles a step of the attention's key loop

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int k8(int k) { return cdiv(k, 8); }
// row stride (floats) of a shared f32 operand of K columns: round8(K) + 4,
// a multiple of 4 whose quarter is odd
__host__ __device__ inline int ld32(int k) { return 8 * k8(k) + 4; }

bool takes(const LayerF32Args& a) {
  return a.T >= 0 && a.L > 0 && a.T % a.L == 0 && a.H > 0 && a.C == a.H * a.dh && a.dh > 0 &&
         a.dh <= 64 && a.dhp == pad16(a.dh) && a.Cin > 0 && a.F > 0 && a.Cout > 0 &&
         (a.in_proj || a.Cin == a.C) && (a.out_proj || a.Cout == a.C);
}

size_t smem_ln_qkv(const LayerF32Args& a) {
  return (size_t)kBM * 4 * (2 * ld32(a.C) + (a.in_proj ? ld32(a.Cin) : 0));
}

__host__ __device__ inline int ld_h(const LayerF32Args& a) {
  const int h = ld32(a.F);
  return a.in_proj && ld32(a.Cin) > h ? ld32(a.Cin) : h;
}

size_t smem_proj_ffn(const LayerF32Args& a) {
  return (size_t)kBM * 4 * (2 * ld32(a.C) + ld_h(a));
}

struct AttnPlan {
  int G;       // pairs a block stages (when a pair fits one block)
  int bpp;     // blocks a pair is split over (1: G pairs a block)
  int blocks;
  int S;       // staged row stride (floats)
  size_t smem;
};

AttnPlan attn_plan(const LayerF32Args& a) {
  const int Lp = (a.L + 7) & ~7, wpp = cdiv(a.L, 16);
  const int npairs = (a.T / a.L) * a.H;
  AttnPlan p;
  if (wpp <= kWarps) {
    p.G = kWarps / wpp;
    p.bpp = 1;
    p.blocks = cdiv(npairs, p.G);
  } else {
    p.G = 1;
    p.bpp = cdiv(wpp, kWarps);
    p.blocks = npairs * p.bpp;
  }
  p.S = ld32(a.dh);
  p.smem = (size_t)p.G * 2 * Lp * p.S * sizeof(float);
  return p;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = addf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the four tf32 A fragments (rows g, g + 8; columns t, t + 4) of the 16 x 8
// block at p (row stride ld), split into high parts and remainders
__device__ __forceinline__ void a_frags(const float* p, int ld, int g, int t, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const float* r = p + g * ld + t;
  split_tf32(r[0], hi[0], lo[0]);
  split_tf32(r[8 * ld], hi[1], lo[1]);
  split_tf32(r[4], hi[2], lo[2]);
  split_tf32(r[8 * ld + 4], hi[3], lo[3]);
}

// The 32 block rows of A (shared, row stride lda, K8 8-column steps, zero
// or finite past K) times the pre-split weight B (N padded to 32 rows of
// K8 x 4 uint4), in items of 32 output columns spread over the warps;
// epi(row, col, sum) for every col < N.
template <typename Epi>
__device__ __forceinline__ void tile_gemm(const float* A, int lda, const void* Bv, int K8, int N,
                                          Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const uint4* B = static_cast<const uint4*>(Bv);
  const size_t nstep = (size_t)8 * K8 * 4;   // 8 weight rows
  for (int n0 = warp * 32; n0 < N; n0 += kWarps * 32) {
    float acc[kMT][4][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
                                          acc[mt][nt][3] = 0.f;
    const uint4* bp = B + (size_t)(n0 + g) * K8 * 4 + t;
#pragma unroll 2
    for (int kk = 0; kk < K8; ++kk) {
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        a_frags(A + mt * 16 * lda + kk * 8, lda, g, t, ah[mt], al[mt]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint4 b = __ldg(bp + nt * nstep + kk * 4);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          mma_tf32x<true>(acc[mt][nt], ah[mt], al[mt], b.x, b.y, b.z, b.w);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n0 + nt * 8 + 2 * t + (i & 1);
          if (col < N) epi(mt * 16 + g + (i >> 1) * 8, col, acc[mt][nt][i]);
        }
  }
}

// rows r0 .. r0 + 31 of src (row stride lds, K columns) into dst (row stride
// ldd), zero past T rows and in the columns up to round8(K)
__device__ __forceinline__ void load_rows(const float* src, int lds, int K, int r0, int T,
                                          float* dst, int ldd) {
  const int w = 8 * k8(K);
  for (int i = threadIdx.x; i < kBM * w; i += kThreads) {
    const int r = i / w, c = i - r * w;
    dst[r * ldd + c] = (r0 + r < T && c < K) ? __ldg(src + (size_t)(r0 + r) * lds + c) : 0.f;
  }
}

// zero columns K .. round8(K) - 1 of the 32 rows (a product's A operand)
__device__ __forceinline__ void zero_pad(float* buf, int ld, int K) {
  const int w = 8 * k8(K) - K;
  for (int i = threadIdx.x; i < kBM * w; i += kThreads) buf[(i / w) * ld + K + i % w] = 0.f;
}

// LN of the 32 rows of x over C columns (statistics in f32: the mean, then
// the mean squared deviation) into dst (may be x), zero in the columns up to
// round8(C); a warp a row
__device__ __forceinline__ void ln_rows(const float* x, int ldx, int C, const float* gam,
                                        const float* bet, float eps, float* dst, int ldd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, pad = 8 * k8(C);
  for (int r = warp; r < kBM; r += kWarps) {
    const float* xr = x + r * ldx;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s = addf(s, xr[c]);
    const float mean = __fdiv_rn(warp_sum(s), (float)C);
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = __fsub_rn(xr[c], mean);
      v = addf(v, mulf(d, d));
    }
    const float var = __fdiv_rn(warp_sum(v), (float)C);
    const float inv = __fdiv_rn(1.f, __fsqrt_rn(addf(var, eps)));
    float* dr = dst + r * ldd;
    for (int c = lane; c < pad; c += 32)
      dr[c] = c < C ? addf(mulf(mulf(__fsub_rn(xr[c], mean), inv), gam[c]), bet[c]) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    layer_ln_qkv_f32_kernel(const __grid_constant__ LayerF32Args a) {
  extern __shared__ __align__(16) float smem[];
  const int ldC = ld32(a.C), ldI = ld32(a.Cin), r0 = blockIdx.x * kBM;
  float* xf = smem;                 // [32][ldC] xf
  float* an = xf + kBM * ldC;        // [32][ldC] LN(xf)
  float* xs = an + kBM * ldC;        // [32][ldI] x, with the input projection
  const float* x = static_cast<const float*>(a.x);
  if (a.in_proj) {
    load_rows(x, a.ldx, a.Cin, r0, a.T, xs, ldI);
    __syncthreads();
    tile_gemm(xs, ldI, a.win, k8(a.Cin), a.C,
                  [&](int r, int c, float v) { xf[r * ldC + c] = v; });
  } else {
    load_rows(x, a.ldx, a.C, r0, a.T, xf, ldC);
  }
  __syncthreads();
  ln_rows(xf, ldC, a.C, static_cast<const float*>(a.ln1g),
              static_cast<const float*>(a.ln1b), a.eps, an, ldC);
  __syncthreads();
  const int nq = 3 * a.H * a.dhp, hq = a.H * a.dhp;
  float* qkv = static_cast<float*>(const_cast<void*>(a.qkv));
  const float* bqkv = static_cast<const float*>(a.bqkv);
  tile_gemm(an, ldC, a.wqkv, k8(a.C), nq, [&](int r, int c, float v) {
    if (r0 + r >= a.T) return;
    float s = addf(v, bqkv[c]);
    if (c < hq) s = mulf(s, a.scale);
    qkv[(size_t)(r0 + r) * nq + c] = s;
  });
}

__global__ void __launch_bounds__(kThreads, 2)
    layer_proj_ffn_f32_kernel(const __grid_constant__ LayerF32Args a) {
  extern __shared__ __align__(16) float smem[];
  const int ldC = ld32(a.C), ldH = ld_h(a), r0 = blockIdx.x * kBM;
  float* x1 = smem;                 // [32][ldC] xf, then x1, then o
  float* an = x1 + kBM * ldC;        // [32][ldC] ctx, then LN(x1)
  float* hs = an + kBM * ldC;        // [32][ldH] x with the input projection, then h1
  const float* x = static_cast<const float*>(a.x);
  if (a.in_proj) {
    load_rows(x, a.ldx, a.Cin, r0, a.T, hs, ldH);
    __syncthreads();
    tile_gemm(hs, ldH, a.win, k8(a.Cin), a.C,
                  [&](int r, int c, float v) { x1[r * ldC + c] = v; });
    zero_pad(x1, ldC, a.C);
    __syncthreads();
  } else {
    load_rows(x, a.ldx, a.C, r0, a.T, x1, ldC);
  }
  load_rows(static_cast<const float*>(a.ctx), a.ldc, a.C, r0, a.T, an, ldC);
  __syncthreads();
  const float* bo = static_cast<const float*>(a.bo);
  tile_gemm(an, ldC, a.wo, k8(a.C), a.C, [&](int r, int c, float v) {
    float* p = x1 + r * ldC + c;
    *p = addf(addf(*p, v), bo[c]);
  });
  __syncthreads();
  ln_rows(x1, ldC, a.C, static_cast<const float*>(a.ln2g),
              static_cast<const float*>(a.ln2b), a.eps, an, ldC);
  __syncthreads();
  const float* bi = static_cast<const float*>(a.bi);
  tile_gemm(an, ldC, a.wi, k8(a.C), a.F,
                [&](int r, int c, float v) { hs[r * ldH + c] = silu(addf(v, bi[c])); });
  zero_pad(hs, ldH, a.F);
  __syncthreads();
  const float* bo2 = static_cast<const float*>(a.bo2);
  tile_gemm(hs, ldH, a.wo2, k8(a.F), a.C, [&](int r, int c, float v) {
    float* p = x1 + r * ldC + c;
    *p = addf(addf(*p, v), bo2[c]);
  });
  __syncthreads();
  if (a.final_ln) {
    ln_rows(x1, ldC, a.C, static_cast<const float*>(a.ln3g),
                static_cast<const float*>(a.ln3b), a.final_eps, x1, ldC);
    __syncthreads();
  }
  float* out = static_cast<float*>(const_cast<void*>(a.out));
  if (a.out_proj) {
    const float* osc = static_cast<const float*>(a.osc);
    const float* obi = static_cast<const float*>(a.obi);
    tile_gemm(x1, ldC, a.wout, k8(a.C), a.Cout, [&](int r, int c, float v) {
      if (r0 + r >= a.T) return;
      float o = addf(mulf(v, osc[c]), obi[c]);
      if (a.out_act) o = silu(o);
      out[(size_t)(r0 + r) * a.ldo + c] = o;
    });
  } else {
    for (int i = threadIdx.x; i < kBM * a.C; i += kThreads) {
      const int r = i / a.C, c = i - r * a.C;
      if (r0 + r < a.T) out[(size_t)(r0 + r) * a.ldo + c] = x1[r * ldC + c];
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(kThreads)
    layer_attention_f32_kernel(const __grid_constant__ LayerF32Args a, const AttnPlan pl) {
  extern __shared__ __align__(16) float smem[];
  const int L = a.L, S = pl.S, H = a.H, Lp = (L + 7) & ~7;
  const int nq = 3 * H * a.dhp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wpp = (L + 15) >> 4;   // 16-row tiles of a pair
  const int npairs = (a.T / L) * H;
  int pair0, ng, gw, tile;
  if (pl.bpp == 1) {
    pair0 = blockIdx.x * pl.G;
    ng = min(pl.G, npairs - pair0);
    gw = warp / wpp;
    tile = warp % wpp;
  } else {
    pair0 = blockIdx.x / pl.bpp;
    ng = 1;
    gw = 0;
    tile = (blockIdx.x % pl.bpp) * kWarps + warp;
  }
  const float* qkv = static_cast<const float*>(a.qkv);

  // k and v of the block's pairs as f32 rows of S floats: columns 8 KS of
  // the head's dhp (zeros past dh), rows past L zero
  const size_t buf = (size_t)Lp * S;
  for (int i = threadIdx.x; i < ng * Lp * 2 * KS; i += kThreads) {
    const int c = i % (2 * KS), j = (i / (2 * KS)) % Lp, gp = i / (2 * KS * Lp);
    const int p = pair0 + gp, seq = p / H, h = p % H;
    const bool ok = j < L;
    const size_t off = ok ? ((size_t)seq * L + j) * nq + (size_t)(H + h) * a.dhp + 4 * c : 0;
    float* kd = smem + (size_t)gp * 2 * buf + (size_t)j * S + 4 * c;
    cp_async16(kd, qkv + off, ok ? 16 : 0);
    cp_async16(kd + buf, qkv + off + (ok ? (size_t)H * a.dhp : 0), ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (gw >= ng || tile * 16 >= L) return;

  const float* ks = smem + (size_t)gw * 2 * buf;
  const float* vs = ks + buf;
  const int p = pair0 + gw, seq = p / H, h = p % H;
  const int row0 = tile * 16;

  // q fragments (q arrives scaled), zero past dh and past L
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + (i & 1) * 8, d = kk * 8 + t + (i >> 1) * 4;
      float v = 0.f;
      if (row < L && d < a.dh) v = qkv[((size_t)seq * L + row) * nq + (size_t)h * a.dhp + d];
      split_tf32(v, qh[kk][i], ql[kk][i]);
    }

  // the scores of keys j0 .. j0 + 8 kChunk - 1; keys past L are -inf
  auto scores = [&](int j0, float (&s)[kChunk][4]) {
#pragma unroll
    for (int nt = 0; nt < kChunk; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      if (j0 + nt * 8 < Lp) {
        const float* kr = ks + (size_t)(j0 + nt * 8 + g) * S + t;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t bh0, bh1, bl0, bl1;
          split_tf32(kr[kk * 8], bh0, bl0);
          split_tf32(kr[kk * 8 + 4], bh1, bl1);
          mma_tf32x<true>(s[nt], qh[kk], ql[kk], bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = j0 + nt * 8 + 2 * t + (i & 1);
        if (key >= L) s[nt][i] = -INFINITY;
      }
    }
  };

  // acc += p . v over the chunk's keys: score tile nt is the k-step, its
  // keys 2t and 2t + 1 the k-columns t and t + 4 (v read in that order)
  float acc[KS][4];
#pragma unroll
  for (int dt = 0; dt < KS; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  auto accumulate = [&](int j0, const float (&pm)[kChunk][4]) {
#pragma unroll
    for (int nt = 0; nt < kChunk; ++nt) {
      if (j0 + nt * 8 >= Lp) continue;
      uint32_t ph[4], pl4[4];
      const float pv[4] = {pm[nt][0], pm[nt][2], pm[nt][1], pm[nt][3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(pv[i], ph[i], pl4[i]);
      const float* vr = vs + (size_t)(j0 + nt * 8 + 2 * t) * S + g;
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        uint32_t bh0, bh1, bl0, bl1;
        split_tf32(vr[dt * 8], bh0, bl0);
        split_tf32(vr[S + dt * 8], bh1, bl1);
        mma_tf32x<true>(acc[dt], ph, pl4, bh0, bh1, bl0, bl1);
      }
    }
  };

  // pass one: the true row max over all L keys
  float m0 = -INFINITY, m1 = -INFINITY;   // rows g and g + 8
  float s[kChunk][4];
  for (int j0 = 0; j0 < Lp; j0 += 8 * kChunk) {
    scores(j0, s);
#pragma unroll
    for (int nt = 0; nt < kChunk; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  // pass two: the same scores again, p = exp(s - max), its sum and p . v
  float den0 = 0.f, den1 = 0.f;   // this thread's share of the row sums
  for (int j0 = 0; j0 < Lp; j0 += 8 * kChunk) {
    scores(j0, s);
#pragma unroll
    for (int nt = 0; nt < kChunk; ++nt) {
      s[nt][0] = expf(__fsub_rn(s[nt][0], m0));
      s[nt][1] = expf(__fsub_rn(s[nt][1], m0));
      s[nt][2] = expf(__fsub_rn(s[nt][2], m1));
      s[nt][3] = expf(__fsub_rn(s[nt][3], m1));
      den0 = addf(den0, addf(s[nt][0], s[nt][1]));
      den1 = addf(den1, addf(s[nt][2], s[nt][3]));
    }
    accumulate(j0, s);
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    den0 = addf(den0, __shfl_xor_sync(0xffffffffu, den0, o));
    den1 = addf(den1, __shfl_xor_sync(0xffffffffu, den1, o));
  }
  const float inv0 = __fdiv_rn(1.f, den0), inv1 = __fdiv_rn(1.f, den1);
  float* ctx = static_cast<float*>(const_cast<void*>(a.ctx));
#pragma unroll
  for (int dt = 0; dt < KS; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + (i >> 1) * 8, d = dt * 8 + 2 * t + (i & 1);
      if (row < L && d < a.dh)
        ctx[((size_t)seq * L + row) * a.ldc + (size_t)h * a.dh + d] =
            mulf(acc[dt][i], i < 2 ? inv0 : inv1);
    }
}

template <typename Kernel, typename... P>
int launch(Kernel kernel, int blocks, size_t smem, void* stream, const P&... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_attn(const LayerF32Args& a, const AttnPlan& p, void* stream) {
  return launch(layer_attention_f32_kernel<KS>, p.blocks, p.smem, stream, a, p);
}

}  // namespace

// Bytes of dynamic shared memory a launch of kernel `kind` (0 ln_qkv, 1
// attention, 2 proj_ffn) at these widths needs, -1 where the kernels do not
// take the layer (a head past 64, C not H heads of dh, dhp not dh rounded up
// to 16, T not a multiple of L): the wrapper holds its own reckoning
// (layer_f32_smem) against it.
extern "C" long long gxt_layer_f32_smem(const LayerF32Args* a, int kind) {
  if (!takes(*a)) return -1;
  switch (kind) {
    case 0: return (long long)smem_ln_qkv(*a);
    case 1: return (long long)attn_plan(*a).smem;
    case 2: return (long long)smem_proj_ffn(*a);
  }
  return -1;
}

// x (T, Cin) f32 with row stride ldx -> qkv (T, 3 H dhp) f32. The weights are
// the wrapper's tf32 pairs (win (C, Cin), wqkv (3 H dhp, C)); vectors f32.
extern "C" int gxt_layer_ln_qkv_f32(const LayerF32Args* a, void* stream) {
  if (a->T <= 0) return 0;
  if (!takes(*a)) return (int)cudaErrorInvalidValue;
  return launch(layer_ln_qkv_f32_kernel, cdiv(a->T, kBM), smem_ln_qkv(*a), stream, *a);
}

// qkv (T, 3 H dhp) f32 -> ctx (T, C) f32 with row stride ldc.
extern "C" int gxt_layer_attention_f32(const LayerF32Args* a, void* stream) {
  if (a->T <= 0) return 0;
  if (!takes(*a)) return (int)cudaErrorInvalidValue;
  const AttnPlan p = attn_plan(*a);
  switch (k8(a->dh)) {
    case 1: return launch_attn<1>(*a, p, stream);
    case 2: return launch_attn<2>(*a, p, stream);
    case 3: return launch_attn<3>(*a, p, stream);
    case 4: return launch_attn<4>(*a, p, stream);
    case 5: return launch_attn<5>(*a, p, stream);
    case 6: return launch_attn<6>(*a, p, stream);
    case 7: return launch_attn<7>(*a, p, stream);
    case 8: return launch_attn<8>(*a, p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// x (T, Cin) and ctx (T, C) f32 -> out (T, Cout) f32 with row stride ldo.
extern "C" int gxt_layer_proj_ffn_f32(const LayerF32Args* a, void* stream) {
  if (a->T <= 0) return 0;
  if (!takes(*a)) return (int)cudaErrorInvalidValue;
  return launch(layer_proj_ffn_f32_kernel, cdiv(a->T, kBM), smem_proj_ffn(*a), stream, *a);
}

// The three launches of a layer, in order, on one stream.
extern "C" int gxt_layer_forward_f32(const LayerF32Args* a, void* stream) {
  int code = gxt_layer_ln_qkv_f32(a, stream);
  if (code == 0) code = gxt_layer_attention_f32(a, stream);
  if (code == 0) code = gxt_layer_proj_ffn_f32(a, stream);
  return code;
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
