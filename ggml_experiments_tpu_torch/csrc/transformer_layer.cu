// A whole pre-LN ViT encoder layer, one block per sequence.
//
//   gxt_transformer_layer  replaces ggml_experiments_tpu/ops/
//                          fused_transformer_layer.py `_fused_layer_call`
//                          (pallas_call :184; body `_layer_kernel` :64)
//
// What it computes per sequence (L tokens, C channels, H heads of width
// dh = C/H, FFN width F), rounding to bf16 exactly where the TPU body does
// (the Python module's docstring lists the twelve steps): xf = x or x.Win
// (f32, never rounded); a = LN(xf) -> bf16; q = ((a.Wq + bq) * scale) ->
// bf16, k, v -> bf16; per head s = q.k_h^T -> bf16, p = exp(s - rowmax) in
// bf16, denom = f32 sum of p, ctx_h = (p.v_h) * (1/denom); ctx -> bf16;
// x1 = xf + ctx.Wo + bo (f32); y = LN(x1) -> bf16; h1 = SiLU(y.Wi + bi) ->
// bf16; o = x1 + h1.Wo2 + bo2; optional block-final LN (block eps); optional
// (o -> bf16).Wout * bn_scale + bn_bias, optional SiLU; output -> bf16.
// Every product runs on tensor cores (mma.sync m16n8k16, bf16 in, f32 sums);
// LN statistics, biases and activations are f32 with every rounding written
// out (__fadd_rn / __fmul_rn), so nothing is contracted that the plain
// version computes in two steps.
//
// Bound on an H100 at the main path's shapes (bp = 512 sequences; (L, C, F)
// = (256, 144, 288), (64, 192, 384), (16, 240, 480)): per sequence 4 L^2 C +
// 8 L C^2 + 4 L C F operations plus 2 L C Cin / 2 L C Cout for the
// projections, against 2 L (Cin + Cout) bytes of activations in and out (the
// weights, under 1 MB, are read once). At L = 256 that is about 145 MFLOP
// against 98 KB a sequence: the operations bound it. At L = 16 the bytes do.
//
// Design. The TPU kernel holds the whole per-sequence layer state in VMEM;
// a Hopper block has 227 KB, which at L = 256 holds k and v of one sequence
// (bf16, 154 KB with padding) and little else. So:
//   * one block per sequence; phase 1 runs LN and the k/v projections for
//     all rows, 16 rows per warp, and stores k as [key][C] and v transposed
//     as [C][key] in shared memory (the layouts the score and context mma
//     fragments read as 32-bit words);
//   * phase 2 gives each warp 16-row groups; it recomputes xf and LN for
//     its rows (cheaper than keeping them), then runs q, attention, the
//     output projection, LN, the FFN and the epilogues on its rows alone,
//     in per-warp shared buffers: xf/x1/o (f32), a/ctx/y (bf16), q/h1
//     (bf16). The number of warps is what shared memory leaves room for
//     (3 at L = 256, 4 at L = 64, 1 at L = 16);
//   * weights are read as B fragments straight from global memory (L2 and
//     L1 serve them: a layer's weights are under 1 MB and every block reads
//     the same ones), pre-transposed by the wrapper to [N][K16];
//   * heads are channel slices; head widths of 36 and 60 are not multiples
//     of 16, so the score product walks ceil(dh/16) k-steps and zeroes the
//     32-bit fragment pairs past the head (dh must be even);
//   * a row's scores against all keys are walked twice in 64-key chunks:
//     once for the rounded row max, once to form p (rounded after the
//     subtraction of the true max), its f32 sum, and p.v, where the score
//     accumulators of two 8-key tiles are the A fragment of the context mma;
//   * L is padded to a multiple of 16 with zero rows whose keys are masked
//     to -inf and whose outputs are not stored.
#include "mma_common.cuh"

// Field order and types match the ctypes Structure in
// ops/fused_transformer_layer.py.
struct LayerArgs {
  const void *x, *out, *wq, *wk, *wv, *wo, *wi, *wo2, *win, *wout;
  const void *ln1g, *ln1b, *bq, *bk, *bv, *bo, *ln2g, *ln2b, *bi, *bo2, *ln3g, *ln3b, *osc,
      *obi;
  int bp, L, Cin, C, F, Cout, H, final_ln, in_proj, out_proj, out_act, warps;
  float eps, final_eps, scale;
};

namespace {

using namespace gxt;

constexpr int kMaxWarps = 8;

struct Layout {
  int Lp, nrg, Kc, Kin, Kf, ldk, ldv, ldx, lda, ldq;
  size_t kv_bytes, warp_bytes;
};

__host__ __device__ inline Layout make_layout(const LayerArgs& a) {
  Layout s;
  s.Lp = pad16(a.L);
  s.nrg = s.Lp / 16;
  s.Kc = pad16(a.C);
  s.Kin = pad16(a.Cin);
  s.Kf = pad16(a.F);
  s.ldk = ld_bank(a.C);
  s.ldv = ld_bank(s.Lp);
  s.ldx = a.C + 4;
  s.lda = ld_bank(s.Kc > s.Kin ? s.Kc : s.Kin);
  s.ldq = ld_bank(s.Kc > s.Kf ? s.Kc : s.Kf);
  s.kv_bytes = ((size_t)s.Lp * s.ldk + (size_t)a.C * s.ldv) * sizeof(bf16);
  s.kv_bytes = (s.kv_bytes + 15) & ~(size_t)15;
  s.warp_bytes = (size_t)16 * s.ldx * sizeof(float) + (size_t)16 * (s.lda + s.ldq) * sizeof(bf16);
  s.warp_bytes = (s.warp_bytes + 15) & ~(size_t)15;
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the products of a layer: 16 rows by all N columns, 64 at a time
template <typename Epi>
__device__ __forceinline__ void gemm16(const bf16* A, int lda, const void* Bt, int K, int N,
                                       int lane, Epi epi) {
  warp_gemm<8>(A, lda, static_cast<const bf16*>(Bt), K, N, 0, N, lane, epi);
}

// LN of 16 f32 rows (stats in f32: mean, then the mean squared deviation),
// written as bf16 to dst (columns C..pad-1 zero) or in place in f32.
__device__ void ln_rows(float* xf, int ldx, int C, const float* gam, const float* bet, float eps,
                        bf16* dst, int ldd, int pad, int lane) {
  for (int r = 0; r < 16; ++r) {
    float* x = xf + r * ldx;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s = addf(s, x[c]);
    const float mean = __fdiv_rn(warp_sum(s), (float)C);
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = __fsub_rn(x[c], mean);
      v = addf(v, mulf(d, d));
    }
    const float var = __fdiv_rn(warp_sum(v), (float)C);
    const float inv = __fdiv_rn(1.f, __fsqrt_rn(addf(var, eps)));
    __syncwarp();
    for (int c = lane; c < pad; c += 32) {
      float y = 0.f;
      if (c < C) y = addf(mulf(mulf(__fsub_rn(x[c], mean), inv), gam[c]), bet[c]);
      if (dst) {
        dst[r * ldd + c] = __float2bfloat16_rn(y);
      } else if (c < C) {
        x[c] = y;
      }
    }
    __syncwarp();
  }
}

// One 64-key chunk of a head's scores for the warp's 16 rows: rounded to
// bf16, keys past L (and past Lp) at -inf.
__device__ __forceinline__ void head_scores(float (&s)[8][4], const uint32_t (&qa)[4][4], int nkt,
                                            const bf16* Ks, int ldk, int c0, int dh, int kb,
                                            int L, int Lp, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = -INFINITY;
    if (kb + nt * 8 >= Lp) continue;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* kr = Ks + (size_t)(kb + nt * 8 + g) * ldk + c0 + 2 * t;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks >= nkt) break;
      const int kk = ks * 16 + 2 * t;
      const uint32_t b0 = kk < dh ? lds32(kr + ks * 16) : 0u;
      const uint32_t b1 = kk + 8 < dh ? lds32(kr + ks * 16 + 8) : 0u;
      mma_bf16(acc, qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], b0, b1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = kb + nt * 8 + 2 * t + (i & 1);
      s[nt][i] = key < L ? bfr(acc[i]) : -INFINITY;
    }
  }
}

// Attention of the warp's 16 rows: q from qb, k from Ks, v^T from Vt; the
// bf16 context goes to columns [0, C) of ab.
__device__ void attention_rows(const bf16* qb, int ldq, bf16* ab, int lda, const bf16* Ks,
                               int ldk, const bf16* Vt, int ldv, int L, int Lp, int H, int dh,
                               int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int nkt = (dh + 15) / 16, nvt = (dh + 7) / 8;
  for (int h = 0; h < H; ++h) {
    const int c0 = h * dh;
    uint32_t qa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int kk = ks * 16 + 2 * t;
      const bf16* q0 = qb + g * ldq + c0 + kk;
      const bool in0 = ks < nkt && kk < dh, in1 = ks < nkt && kk + 8 < dh;
      qa[ks][0] = in0 ? lds32(q0) : 0u;
      qa[ks][1] = in0 ? lds32(q0 + 8 * ldq) : 0u;
      qa[ks][2] = in1 ? lds32(q0 + 8) : 0u;
      qa[ks][3] = in1 ? lds32(q0 + 8 * ldq + 8) : 0u;
    }
    float s[8][4];
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int kb = 0; kb < Lp; kb += 64) {
      head_scores(s, qa, nkt, Ks, ldk, c0, dh, kb, L, Lp, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
        m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float ctx[8][4];
#pragma unroll
    for (int vt = 0; vt < 8; ++vt) ctx[vt][0] = ctx[vt][1] = ctx[vt][2] = ctx[vt][3] = 0.f;
    float d0 = 0.f, d1 = 0.f;
    for (int kb = 0; kb < Lp; kb += 64) {
      head_scores(s, qa, nkt, Ks, ldk, c0, dh, kb, L, Lp, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float m = i < 2 ? m0 : m1;
          s[nt][i] = bfr(expf(bfr(__fsub_rn(s[nt][i], m))));
        }
        d0 = addf(d0, addf(s[nt][0], s[nt][1]));
        d1 = addf(d1, addf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kb + 16 * j >= Lp) break;
        const uint32_t a0 = pack_bf16(s[2 * j][0], s[2 * j][1]);
        const uint32_t a1 = pack_bf16(s[2 * j][2], s[2 * j][3]);
        const uint32_t a2 = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        const uint32_t a3 = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
        const int key = kb + 16 * j + 2 * t;
#pragma unroll
        for (int vt = 0; vt < 8; ++vt) {
          if (vt >= nvt) break;
          const int ch = vt * 8 + g;
          uint32_t b0 = 0u, b1 = 0u;
          if (ch < dh) {
            const bf16* vr = Vt + (size_t)(c0 + ch) * ldv + key;
            b0 = lds32(vr);
            b1 = lds32(vr + 8);
          }
          mma_bf16(ctx[vt], a0, a1, a2, a3, b0, b1);
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, o);
      d1 += __shfl_xor_sync(0xffffffffu, d1, o);
    }
    const float inv0 = __fdiv_rn(1.f, d0), inv1 = __fdiv_rn(1.f, d1);
#pragma unroll
    for (int vt = 0; vt < 8; ++vt) {
      if (vt >= nvt) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = vt * 8 + 2 * t + (i & 1);
        const int row = g + (i >> 1) * 8;
        if (col < dh)
          ab[row * lda + c0 + col] = __float2bfloat16_rn(mulf(ctx[vt][i], i < 2 ? inv0 : inv1));
      }
    }
  }
}

// xf (f32) of the warp's 16 rows starting at r0: x itself, or x.Win
// (staged through ab).
__device__ void load_xf(const LayerArgs& a, const Layout& lay, const bf16* x, int r0, float* xf,
                        bf16* ab, int lane) {
  const int L = a.L;
  if (a.in_proj) {
    for (int i = lane; i < 16 * lay.lda; i += 32) {
      const int r = i / lay.lda, c = i % lay.lda;
      ab[i] = (r0 + r < L && c < a.Cin) ? x[(size_t)(r0 + r) * a.Cin + c]
                                         : __float2bfloat16_rn(0.f);
    }
    __syncwarp();
    gemm16(ab, lay.lda, a.win, lay.Kin, a.C, lane,
              [&](int r, int c, float v) { xf[r * lay.ldx + c] = v; });
  } else {
    for (int i = lane; i < 16 * a.C; i += 32) {
      const int r = i / a.C, c = i % a.C;
      xf[r * lay.ldx + c] = r0 + r < L ? __bfloat162float(x[(size_t)(r0 + r) * a.C + c]) : 0.f;
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32 * kMaxWarps) layer_kernel(LayerArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = make_layout(a);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = a.warps;
  const int L = a.L, C = a.C, dh = a.C / a.H;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Ks + (size_t)lay.Lp * lay.ldk;
  unsigned char* wb = smem + lay.kv_bytes + (size_t)warp * lay.warp_bytes;
  float* xf = reinterpret_cast<float*>(wb);
  bf16* ab = reinterpret_cast<bf16*>(xf + 16 * lay.ldx);
  bf16* qb = ab + 16 * lay.lda;
  const bf16* x = static_cast<const bf16*>(a.x) + (size_t)blockIdx.x * L * a.Cin;
  bf16* out = static_cast<bf16*>(const_cast<void*>(a.out)) + (size_t)blockIdx.x * L * a.Cout;
  const float* bq = static_cast<const float*>(a.bq);
  const float* bk = static_cast<const float*>(a.bk);
  const float* bv = static_cast<const float*>(a.bv);
  const float* bo = static_cast<const float*>(a.bo);
  const float* bi = static_cast<const float*>(a.bi);
  const float* bo2 = static_cast<const float*>(a.bo2);
  const float* ln1g = static_cast<const float*>(a.ln1g);
  const float* ln1b = static_cast<const float*>(a.ln1b);

  // phase 1: k and v of every row into shared memory
  for (int rg = warp; rg < lay.nrg; rg += W) {
    const int r0 = rg * 16;
    load_xf(a, lay, x, r0, xf, ab, lane);
    ln_rows(xf, lay.ldx, C, ln1g, ln1b, a.eps, ab, lay.lda, lay.lda, lane);
    gemm16(ab, lay.lda, a.wk, lay.Kc, C, lane,
              [&](int r, int c, float v) {
                Ks[(size_t)(r0 + r) * lay.ldk + c] = __float2bfloat16_rn(addf(v, bk[c]));
              });
    gemm16(ab, lay.lda, a.wv, lay.Kc, C, lane,
              [&](int r, int c, float v) {
                Vt[(size_t)c * lay.ldv + r0 + r] = __float2bfloat16_rn(addf(v, bv[c]));
              });
    __syncwarp();
  }
  __syncthreads();

  // phase 2: everything else, 16 rows per warp at a time
  for (int rg = warp; rg < lay.nrg; rg += W) {
    const int r0 = rg * 16;
    load_xf(a, lay, x, r0, xf, ab, lane);
    ln_rows(xf, lay.ldx, C, ln1g, ln1b, a.eps, ab, lay.lda, lay.lda, lane);
    gemm16(ab, lay.lda, a.wq, lay.Kc, C, lane,
              [&](int r, int c, float v) {
                qb[r * lay.ldq + c] = __float2bfloat16_rn(mulf(addf(v, bq[c]), a.scale));
              });
    __syncwarp();
    attention_rows(qb, lay.ldq, ab, lay.lda, Ks, lay.ldk, Vt, lay.ldv, L, lay.Lp, a.H, dh, lane);
    __syncwarp();
    gemm16(ab, lay.lda, a.wo, lay.Kc, C, lane,
              [&](int r, int c, float v) {
                float* p = xf + r * lay.ldx + c;
                *p = addf(addf(*p, v), bo[c]);
              });
    __syncwarp();
    ln_rows(xf, lay.ldx, C, static_cast<const float*>(a.ln2g), static_cast<const float*>(a.ln2b),
            a.eps, ab, lay.lda, lay.lda, lane);
    gemm16(ab, lay.lda, a.wi, lay.Kc, a.F, lane,
              [&](int r, int c, float v) {
                qb[r * lay.ldq + c] = __float2bfloat16_rn(silu(addf(v, bi[c])));
              });
    for (int i = lane; i < 16 * (lay.Kf - a.F); i += 32) {
      const int w = lay.Kf - a.F;
      qb[(i / w) * lay.ldq + a.F + i % w] = __float2bfloat16_rn(0.f);
    }
    __syncwarp();
    gemm16(qb, lay.ldq, a.wo2, lay.Kf, C, lane,
              [&](int r, int c, float v) {
                float* p = xf + r * lay.ldx + c;
                *p = addf(addf(*p, v), bo2[c]);
              });
    __syncwarp();
    if (a.final_ln)
      ln_rows(xf, lay.ldx, C, static_cast<const float*>(a.ln3g),
              static_cast<const float*>(a.ln3b), a.final_eps, nullptr, 0, C, lane);
    if (a.out_proj) {
      for (int i = lane; i < 16 * lay.lda; i += 32) {
        const int r = i / lay.lda, c = i % lay.lda;
        ab[i] = __float2bfloat16_rn(c < C ? xf[r * lay.ldx + c] : 0.f);
      }
      __syncwarp();
      const float* osc = static_cast<const float*>(a.osc);
      const float* obi = static_cast<const float*>(a.obi);
      gemm16(ab, lay.lda, a.wout, lay.Kc, a.Cout, lane,
                [&](int r, int c, float v) {
                  float o = addf(mulf(v, osc[c]), obi[c]);
                  if (a.out_act) o = silu(o);
                  if (r0 + r < L) out[(size_t)(r0 + r) * a.Cout + c] = __float2bfloat16_rn(o);
                });
    } else {
      for (int i = lane; i < 16 * C; i += 32) {
        const int r = i / C, c = i % C;
        if (r0 + r < L) out[(size_t)(r0 + r) * C + c] = __float2bfloat16_rn(xf[r * lay.ldx + c]);
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Fills a->warps with the number of warps that fit `max_smem` bytes of
// shared memory beside k and v, and returns the launch's bytes of dynamic
// shared memory; 0 if not even one warp fits.
extern "C" int gxt_transformer_layer_plan(LayerArgs* a, int max_smem) {
  if (a->L <= 0 || a->H <= 0 || a->C % a->H || (a->C / a->H) % 2 || a->C / a->H > 64)
    return 0;
  const Layout lay = make_layout(*a);
  if (lay.kv_bytes + lay.warp_bytes > (size_t)max_smem) return 0;
  int w = (int)((max_smem - lay.kv_bytes) / lay.warp_bytes);
  if (w > kMaxWarps) w = kMaxWarps;
  if (w > lay.nrg) w = lay.nrg;
  a->warps = w;
  return (int)(lay.kv_bytes + (size_t)w * lay.warp_bytes);
}

extern "C" int gxt_transformer_layer(const LayerArgs* a, void* stream) {
  if (a->bp <= 0 || a->L <= 0) return 0;
  if (a->warps <= 0 || a->warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const Layout lay = make_layout(*a);
  const size_t smem = lay.kv_bytes + (size_t)a->warps * lay.warp_bytes;
  cudaError_t err = cudaFuncSetAttribute(layer_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  layer_kernel<<<a->bp, 32 * a->warps, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
