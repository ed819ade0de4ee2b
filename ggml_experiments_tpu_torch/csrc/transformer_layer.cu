// The pre-LN ViT encoder layer on Hopper, as three kernels.
//
//   gxt_layer_ln_qkv     \  together replace ggml_experiments_tpu/ops/
//   gxt_layer_attention   > fused_transformer_layer.py `_fused_layer_call`
//   gxt_layer_proj_ffn   /  (pallas_call :184; body `_layer_kernel` :64)
//
// What the three compute (bp sequences of L tokens, T = bp*L rows; C
// channels, H heads of width dh = C/H, FFN width F), rounding to bf16 exactly
// where the TPU body does (the Python module's docstring lists the twelve
// steps):
//   A  ln_qkv:    xf = x or x.Win (f32, never rounded); a = LN(xf) -> bf16;
//                 q = ((a.Wq + bq) * scale) -> bf16, k, v -> bf16, stored as
//                 one (T, 3*H*dhp) bf16 array, heads padded to dhp = dh
//                 rounded up to 16 with zero columns;
//   B  attention: per (sequence, head) s = q.k^T -> bf16, p = exp(s -
//                 rowmax) in bf16 after the TRUE row max over all L keys,
//                 denom the f32 sum of p, ctx = (p.v) * (1/denom) -> bf16,
//                 stored as (T, C) with the head's columns in place;
//   C  proj_ffn:  xf again (x, or x.Win recomputed: cheaper than an f32
//                 round trip); x1 = xf + ctx.Wo + bo (f32); y = LN(x1) ->
//                 bf16; per 64-column chunk of F, h1 = SiLU(y.Wi + bi) ->
//                 bf16 (it never leaves the block); o = x1 + h1.Wo2 + bo2;
//                 optional block-final LN (block eps); optional (o -> bf16)
//                 .Wout * bn_scale + bn_bias and SiLU; output -> bf16.
// Every product runs on wgmma (bf16 in, f32 sums). LN statistics, biases and
// the LN and softmax arithmetic are f32 with every rounding written out
// (__fadd_rn / __fmul_rn), so nothing is contracted that the plain version
// computes in two steps; exp (softmax, SiLU) and SiLU's reciprocal use the
// hardware approximations (a few f32 ulps before the bf16 rounding). No
// atomics and no order that depends on timing: two launches give the same
// bits.
//
// Bound on an H100 at the main path's shapes (bp = 512; (L, C, F) = (256,
// 144, 288), (64, 192, 384), (16, 240, 480); (1024, 144, 288) for layer_3
// at 512 px): the operations (about 145 MFLOP a sequence at L = 256 against
// 98 KB of activations in and out; at L = 1024 the attention's, q.k^T twice
// and P.v, and its 4 M exponentials a sequence and head on the MUFU). The
// split adds the q/k/v and ctx round trips (about 1.3 KB and 0.3-0.5 KB a
// token). What holds the kernels back is latency, not either bound: one
// block of two consumer warpgroups a multiprocessor (registers), each
// warpgroup a chain of dependent products and per-element epilogues
// (PERF.md: the split-step timings of the fused layer).
//
// Design. The TPU kernel holds a sequence's whole layer in VMEM. Here:
//   * A and C are row tiles over all T tokens: a block is two consumer
//     warpgroups of 64 rows each (one where 128-row tiles would leave
//     multiprocessors idle: L = 16) and a producer warpgroup (one thread of it
//     issues every copy; it hands most of its registers to the consumers,
//     whose C-wide accumulators take 72-144 of them). The producer brings
//     each warpgroup's x (and, in C, ctx) tile in by TMA (2-D tensor maps,
//     128-byte swizzle, 64 x 64 boxes) and streams the weights through a
//     ring of `stages` buffers by TMA bulk copies: the wrapper stores each
//     weight once as pre-swizzled K-major tiles (N rows x one K chunk) in
//     exactly the order the block consumes them. K chunks are 48 or 64
//     columns (KS = 3 or 4 k-steps, whichever pads C and Cin least), so
//     C = 144 and 240 cost no padded steps. Products of C output columns
//     keep their f32 sums in registers, NCH chunks of 48 columns
//     (m64n48k16), so x1 stays in registers from the out-projection to the
//     FFN's residual; the FFN walks F in 64-column chunks (m64n64k16 into a
//     32-register accumulator), each h1 chunk going to shared memory as the
//     A operand of its Wo2 slice; at C <= 144 chunk f + 1's y.Wi runs while
//     chunk f's SiLU does. Outputs go out through shared memory in whole
//     16-byte rows.
//   * Past C = 288 (kMaxNch chunks of 48) the C-wide rows no longer fit
//     registers: A and C run WIDE, the C columns in ngc groups of NW = 48 NCH
//     (NCH 4-6). Each C-wide f32 row (xf; x1, then o) goes to a global f32
//     scratch (rows x ngc NW, row-major) group by group, each lane writing
//     and reading back its own elements only (no barrier guards it), f32 as
//     in the plain version: exact. The LN statistics walk the scratch's
//     groups in column order with ln_stats' arithmetic, then the normalised
//     groups go to the A tile (K = C) in shared memory. The FFN runs once a
//     group of output columns, y.Wi and the SiLU again each time (h1 never
//     leaves the block); the weight stream holds Win^T, Wo^T and Wo2^T in
//     groups of NW rows, Wi^T once a group.
//   * B, resident (L <= 256): one head of one sequence a block (at L < 64,
//     64/L sequences of one head in one 64-row tile under a block-diagonal
//     mask). q, k and v of the head arrive by TMA as 64 x 64 boxes at the
//     head's column; columns past dhp belong to the next head and are never
//     read (S walks dhp/16 k-steps; ctx columns past dh are not stored). S =
//     q.k^T runs on m64n64k16 per 64-key chunk and stays in registers; p
//     feeds P.V as the register A operand with v as an MN-major B
//     (m64n64k16, transposed B).
//   * B, streamed (any L >= 64; the plan past 256 keys, where a row's
//     scores no longer fit registers): NQ = 4 query tiles of one head of one
//     sequence resident a block, the keys walked twice in 64-key chunks that
//     one thread sends by TMA through a ring (k alone in the first pass, k
//     and v in the second). The bf16 rounding of p after the TRUE row max
//     is why the keys are walked twice: an online max would round p against
//     a running max and give other bits. The products stay on wgmma as in
//     the resident form (the same issue_scores / probs / issue_pv), so a
//     streamed launch computes what a resident one does. At L = 1024 (512
//     px) a block reads each chunk once for its 256 rows instead of once for
//     every 64.
//   * Rows past T read zeros (TMA) and are not stored; keys past L, or of
//     another sequence in a packed tile, are -inf before the max.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper_common.cuh"
#include "mma_common.cuh"

// Field order and types match the ctypes Structure in
// ops/fused_transformer_layer.py.
struct LayerArgs {
  const void *x, *qkv, *ctx, *out, *wa, *wc, *scr;
  const void *ln1g, *ln1b, *bqkv, *bo, *ln2g, *ln2b, *bi, *bo2, *ln3g, *ln3b, *osc, *obi;
  int T, L, Cin, ldx, C, H, dh, dhp, ldc, nf, Cout, in_proj, final_ln, out_proj, out_act,
      stages_a, stages_c, ks, ldo, nwg, nw, pipe, attn, qsplit, fsplit;
  float eps, final_eps, scale;
};

namespace {

using namespace gxt;

constexpr int kRows = 64;                   // rows of a consumer warpgroup
constexpr int kMaxThreads = 384;            // two consumer warpgroups and a producer one
constexpr int kBox = 8192;                  // a 64 x 64 bf16 tile: 64 rows of 128 bytes
constexpr int kChunk = 48;                  // output columns of one C-wide wgmma
constexpr int kChunkBytes = kChunk * 128;   // its B rows in a weight tile
constexpr int kMaxNch = 6;                  // C <= 288: x1 in registers
constexpr int kMinWideNch = 4;              // a wide layer's groups: 4-6 chunks
constexpr int kMaxPipeNch = 3;              // C <= 144: registers for two FFN chunks
constexpr int kMaxStages = 6;
constexpr int kMaxQTiles = 4;               // the resident attention: L <= 256

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// shared memory, barriers, TMA, wgmma
// ---------------------------------------------------------------------------

// the four warps of consumer warpgroup `wg` meet (named barrier 1 + wg)
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// one TMA copy of a (64, 64) box of a 2-D tensor map, completing on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* tm, int c0, int c1,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// d (64 x N, f32, the warpgroup's fragment) += a . b; scale_d == 0
// overwrites d instead. Lane (warp w of the group, g = lane / 4, q = lane %
// 4) holds rows 16w + g (+8) and columns 8j + 2q (+1) in d[4j + {0, 1}] and
// d[4j + {2, 3}]. _rs: a from registers (the same rows, k = 2q (+1, +8, +9)
// as mma.sync's A fragment) and b MN-major.
__device__ __forceinline__ void wgmma_n48(float (&d)[24], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// pieces shared by the row-tile kernels (A and C)
// ---------------------------------------------------------------------------

// The weight ring: `stages` buffers of `sb` bytes. The block's i-th tile
// (tile `src` of the stream, at src * sb bytes of it) goes to buffer i %
// stages; the producer waits for the consumer warps to release the buffer's
// previous tile.
struct Ring {
  unsigned char* buf;
  uint64_t* full;
  uint64_t* empty;
  int stages, sb;
};

__device__ __forceinline__ void ring_fill(const Ring& r, int i, const unsigned char* stream,
                                          int src, int bytes) {
  const int s = i % r.stages;
  if (i >= r.stages) mbar_wait(r.empty + s, (i / r.stages - 1) & 1);
  mbar_expect(r.full + s, bytes);
  bulk_load(r.buf + (size_t)s * r.sb, stream + (size_t)src * r.sb, bytes, r.full + s);
}

// acc (+)= A . the next nkc ring tiles. A is the warpgroup's K-major tile at
// `a`: nkc chunks of 16 KS columns of K, each in a 64-wide swizzled box; a
// ring tile holds NCH chunks of 48 B rows (output columns n0 + 48 ch ...)
// for the same K chunk. `zero_first`: the first step overwrites acc. Each
// tile's products finish before the next tile's start (issuing the next
// tile's first and releasing a tile one step late made ptxas serialise the
// wgmmas and ln_qkv slower: PERF.md). Every wgmma is issued
// unconditionally and the accumulators are defined by branch-free code
// only: a wgmma under a branch, or an accumulator defined on a divergent
// path, makes ptxas serialise every wgmma of the kernel.
__device__ __forceinline__ void ring_release(const Ring& r, int it, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(r.empty + it % r.stages);
}

template <int NCH, int KS>
__device__ __forceinline__ void ring_product(float (&acc)[NCH][24], uint32_t a, int nkc,
                                             bool zero_first, const Ring& r, int& it, int lane) {
  for (int kc = 0; kc < nkc; ++kc, ++it) {
    const int s = it % r.stages;
    mbar_wait(r.full + s, (it / r.stages) & 1);
    const uint32_t bt = smem_u32(r.buf + (size_t)s * r.sb), at = a + kc * kBox;
    const int keep = zero_first && kc == 0 ? 0 : 1;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        wgmma_n48(acc[ch], desc_k(at + 32 * ks), desc_k(bt + ch * kChunkBytes + 32 * ks),
                  ks > 0 ? 1 : keep);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) wg_pin(acc[ch]);
    ring_release(r, it, lane);
  }
}

// h = A . the next nkc ring tiles of 64 B rows (one FFN chunk of Wi)
template <int KS>
__device__ __forceinline__ void ring_product64(float (&h)[32], uint32_t a, int nkc, const Ring& r,
                                               int& it, int lane) {
  for (int kc = 0; kc < nkc; ++kc, ++it) {
    const int s = it % r.stages;
    mbar_wait(r.full + s, (it / r.stages) & 1);
    const uint32_t bt = smem_u32(r.buf + (size_t)s * r.sb), at = a + kc * kBox;
    const int keep = kc == 0 ? 0 : 1;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_n64(h, desc_k(at + 32 * ks), desc_k(bt + 32 * ks), ks > 0 ? 1 : keep);
    wg_commit();
    wg_wait<0>();
    wg_pin(h);
    ring_release(r, it, lane);
  }
}

// zeros over [p, p + bytes): the columns of an A tile past K must hold
// finite values (the B tiles' zero rows multiply them)
__device__ __forceinline__ void zero_smem(unsigned char* p, int bytes, int tid, int nthreads) {
  for (int i = 16 * tid; i < bytes; i += 16 * nthreads)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0u, 0u, 0u, 0u);
}

// The lane's column col = 48 ch + 8 j + 2 q + e of a C-wide accumulator is
// acc[ch][4 j + 2 hf + e] of row rl + 8 hf; the loops below walk (ch, j).

// The code below that defines accumulators is branch-free: loads from
// clamped addresses, then selects.

// acc = xf (add: acc += xf) of the lane's two rows, x (T, C) bf16 at row
// stride ld; zeros past C and past T
template <int NCH>
__device__ __forceinline__ void load_rows(float (&acc)[NCH][24], const bf16* x, int ld, int C,
                                          int T, int row, int q, bool add) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int col = ch * kChunk + 8 * j + 2 * q;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = row + 8 * hf;
        const uint32_t w0 = ldg32(x + (size_t)min(r, T - 1) * ld + min(col, C - 2));
        const uint32_t w = col < C && r < T ? w0 : 0u;
        float& lo = acc[ch][4 * j + 2 * hf];
        float& hi = acc[ch][4 * j + 2 * hf + 1];
        lo = add ? addf(lo, __uint_as_float(w << 16)) : __uint_as_float(w << 16);
        hi = add ? addf(hi, __uint_as_float(w & 0xffff0000u)) : __uint_as_float(w & 0xffff0000u);
      }
    }
}

// acc += v[col] in f32 on columns < C; zero past C
template <int NCH>
__device__ __forceinline__ void add_bias(float (&acc)[NCH][24], const float* v, int C, int q) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int col = ch * kChunk + 8 * j + 2 * q;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = v[min(col, C - 2) + e];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float& x = acc[ch][4 * j + 2 * hf + e];
          x = col < C ? addf(x, b) : 0.f;
        }
      }
    }
}

// LN statistics of the lane's two rows over C columns (f32: the mean, then
// the mean squared deviation; the four lanes of a row add in a fixed order)
template <int NCH>
__device__ __forceinline__ void ln_stats(const float (&acc)[NCH][24], int C, int q, float eps,
                                         float (&mean)[2], float (&inv)[2]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float s = 0.f;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (ch * kChunk + 8 * j + 2 * q + e < C) s = addf(s, acc[ch][4 * j + 2 * hf + e]);
    s = addf(s, __shfl_xor_sync(0xffffffffu, s, 1));
    s = addf(s, __shfl_xor_sync(0xffffffffu, s, 2));
    const float m = __fdiv_rn(s, (float)C);
    float v = 0.f;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (ch * kChunk + 8 * j + 2 * q + e < C) {
            const float d = __fsub_rn(acc[ch][4 * j + 2 * hf + e], m);
            v = addf(v, mulf(d, d));
          }
    v = addf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = addf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    mean[hf] = m;
    inv[hf] = __fdiv_rn(1.f, __fsqrt_rn(addf(__fdiv_rn(v, (float)C), eps)));
  }
}

__device__ __forceinline__ float ln_val(float x, float m, float inv, float g, float b) {
  return addf(mulf(mulf(__fsub_rn(x, m), inv), g), b);
}

// acc = LN(acc) in f32 on columns < C with the statistics of the lane's rows
// (acc holds columns n0 .. of a row C wide)
template <int NCH>
__device__ __forceinline__ void ln_apply(float (&acc)[NCH][24], int n0, int C, int q,
                                         const float (&mean)[2], const float (&inv)[2],
                                         const float* gam, const float* bet) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int col = n0 + ch * kChunk + 8 * j + 2 * q, cc = min(col, C - 2);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = acc[ch][4 * j + 2 * hf + e];
          const float y = ln_val(x, mean[hf], inv[hf], gam[cc + e], bet[cc + e]);
          x = col < C ? y : 0.f;
        }
    }
}

// acc = LN(acc) in f32 on columns < C
template <int NCH>
__device__ __forceinline__ void ln_inplace(float (&acc)[NCH][24], int C, int q, float eps,
                                           const float* gam, const float* bet) {
  float mean[2], inv[2];
  ln_stats<NCH>(acc, C, q, eps, mean, inv);
  ln_apply<NCH>(acc, 0, C, q, mean, inv, gam, bet);
}

// The lane's rows rl, rl + 8, columns n0 .. n0 + NW - 1 of a row C wide, as
// bf16 into the warpgroup's K-major A tile (chunks of KW = 16 KS columns,
// each a 64-wide box of 64 rows): LN(acc) with `gam` and the rows'
// statistics, acc itself without; columns past C (to KW nkc) zero.
template <int NCH, int KS>
__device__ __forceinline__ void store_a_cols(unsigned char* tile, const float (&acc)[NCH][24],
                                             int n0, int C, int nkc, int rl, int q,
                                             const float (&mean)[2], const float (&inv)[2],
                                             const float* gam, const float* bet) {
  constexpr int KW = 16 * KS;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int col = n0 + ch * kChunk + 8 * j + 2 * q;
      if (col >= KW * nkc) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float y[2] = {0.f, 0.f};
        if (col < C) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = acc[ch][4 * j + 2 * hf + e];
            y[e] = gam ? ln_val(x, mean[hf], inv[hf], gam[col + e], bet[col + e]) : x;
          }
        }
        *reinterpret_cast<uint32_t*>(tile + (col / KW) * kBox + swz(rl + 8 * hf, col % KW)) =
            pack_bf16(y[0], y[1]);
      }
    }
}

// store_a_cols of a whole row (C <= NW): LN(acc) with `gam` (its statistics
// from acc), acc itself without
template <int NCH, int KS>
__device__ __forceinline__ void store_a(unsigned char* tile, const float (&acc)[NCH][24], int C,
                                        int nkc, int rl, int q, float eps, const float* gam,
                                        const float* bet) {
  float mean[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  if (gam) ln_stats<NCH>(acc, C, q, eps, mean, inv);
  store_a_cols<NCH, KS>(tile, acc, 0, C, nkc, rl, q, mean, inv, gam, bet);
}

// The wide layers' scratch: the lane's elements of columns n0 .. n0 + NW - 1
// of its rows `row`, `row + 8` of a (rows, ld) f32 array (rows cover every
// row tile: no bound to check)
template <int NCH>
__device__ __forceinline__ void scr_store(float* scr, int ld, int row, int n0,
                                          const float (&acc)[NCH][24], int q) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(scr + (size_t)(row + 8 * hf) * ld + n0 + ch * kChunk + 8 * j +
                                   2 * q) =
            make_float2(acc[ch][4 * j + 2 * hf], acc[ch][4 * j + 2 * hf + 1]);
}

template <int NCH>
__device__ __forceinline__ void scr_load(float (&acc)[NCH][24], const float* scr, int ld, int row,
                                         int n0, int q) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 v = *reinterpret_cast<const float2*>(
            scr + (size_t)(row + 8 * hf) * ld + n0 + ch * kChunk + 8 * j + 2 * q);
        acc[ch][4 * j + 2 * hf] = v.x;
        acc[ch][4 * j + 2 * hf + 1] = v.y;
      }
}

// LN statistics of the lane's two rows of a C-wide row in the scratch (ngc
// groups of NW = 48 NCH columns): ln_stats' sums, over the groups' columns
// in order (acc is the caller's, overwritten)
template <int NCH>
__device__ __forceinline__ void scr_stats(float (&acc)[NCH][24], const float* scr, int ld,
                                          int row, int C, int ngc, int q, float eps,
                                          float (&mean)[2], float (&inv)[2]) {
  constexpr int NW = NCH * kChunk;
  float s[2] = {0.f, 0.f}, v[2] = {0.f, 0.f};
  for (int g = 0; g < ngc; ++g) {
    scr_load<NCH>(acc, scr, ld, row, g * NW, q);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (g * NW + ch * kChunk + 8 * j + 2 * q + e < C)
              s[hf] = addf(s[hf], acc[ch][4 * j + 2 * hf + e]);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    s[hf] = addf(s[hf], __shfl_xor_sync(0xffffffffu, s[hf], 1));
    s[hf] = addf(s[hf], __shfl_xor_sync(0xffffffffu, s[hf], 2));
    mean[hf] = __fdiv_rn(s[hf], (float)C);
  }
  for (int g = 0; g < ngc; ++g) {
    scr_load<NCH>(acc, scr, ld, row, g * NW, q);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (g * NW + ch * kChunk + 8 * j + 2 * q + e < C) {
              const float d = __fsub_rn(acc[ch][4 * j + 2 * hf + e], mean[hf]);
              v[hf] = addf(v[hf], mulf(d, d));
            }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    v[hf] = addf(v[hf], __shfl_xor_sync(0xffffffffu, v[hf], 1));
    v[hf] = addf(v[hf], __shfl_xor_sync(0xffffffffu, v[hf], 2));
    inv[hf] = __fdiv_rn(1.f, __fsqrt_rn(addf(__fdiv_rn(v[hf], (float)C), eps)));
  }
}

// Output tiles go to global memory through shared memory: the lanes' pairs
// land in a (64, NW) bf16 staging tile (row stride NW + 8 elements: the 32
// words of a store fall in 32 banks), then the warpgroup copies whole rows
// out in 16-byte pieces. A warp storing its pairs straight from registers
// touches eight rows of 16 bytes an instruction, and those stores took most
// of ln_qkv's time (PERF.md, the fused layer's split-step timings).
template <int NCH>
__device__ __forceinline__ void stage_pair(bf16* st, int rl, int col, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(st + rl * (NCH * kChunk + 8) + col) = pack_bf16(v0, v1);
}

// rows [0, 64) x columns [0, ncols) of the staging tile to dst (row stride
// ld elements) for rows below `rows`; ncols and the addresses 16-byte aligned
template <int NCH>
__device__ __forceinline__ void copy_out(const bf16* st, bf16* dst, size_t ld, int rows,
                                         int ncols, int tid) {
  const int per_row = ncols / 8;
  for (int i = tid; i < 64 * per_row; i += 128) {
    const int r = i / per_row, c = 8 * (i % per_row);
    if (r < rows)
      *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c) =
          *reinterpret_cast<const uint4*>(st + r * (NCH * kChunk + 8) + c);
  }
}

// ---------------------------------------------------------------------------
// A: x (or x.Win) -> LN1 -> q, k, v
// ---------------------------------------------------------------------------

struct QkvParams {
  CUtensorMap tm_x;           // x (T, Cin) in 64 x 64 boxes; with in_proj
  const bf16* x;              // (T, C) without in_proj
  const unsigned char* ws;    // weight stream: Win^T tiles (by groups), then Wqkv^T tiles
  const float *ln_g, *ln_b, *bias;
  bf16* qkv;                  // (T, nqkv) out, nqkv = 3 hdp
  float* scr;                 // wide: xf, gridDim.y x (row tiles x 64 rows, ngc NW) f32
  int T, Cin, ldx, C, nqkv, hdp, in_proj, kc_in, kc, sb, stages, nwg, ngc;
  float eps, scale;
};

__host__ __device__ inline int qkv_tile_chunks(int in_proj, int kc_in, int kc) {
  return in_proj && kc_in > kc ? kc_in : kc;
}

// bytes of one warpgroup's staging tile, (64, NW + 8) bf16, 16-byte rounded
__host__ __device__ inline int qkv_stage_bytes(int nch) {
  return (64 * (nch * kChunk + 8) * 2 + 1023) / 1024 * 1024;
}

template <int NCH, int KS, bool WIDE>
__global__ void __launch_bounds__(kMaxThreads, 1)
    layer_ln_qkv_kernel(const __grid_constant__ QkvParams p) {
  constexpr int NW = NCH * kChunk, KW = 16 * KS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int S = p.stages, kb = qkv_tile_chunks(p.in_proj, p.kc_in, p.kc);
  const int nwg = p.nwg, cwarps = 4 * nwg;                // consumer warpgroups, warps
  unsigned char* abuf = base + (size_t)S * p.sb;           // nwg x kb boxes
  unsigned char* stage = abuf + (size_t)nwg * kb * kBox;   // nwg staging tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + nwg * qkv_stage_bytes(NCH));
  uint64_t* empty = full + S;
  uint64_t* xbar = empty + S;
  const Ring ring{base, full, empty, S, p.sb};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile0 = blockIdx.x * nwg * kRows;
  const int ng = cdiv(p.nqkv, NW);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, cwarps);
    }
    mbar_init(xbar, 1);
    mbar_init(xbar + 1, 1);
    mbar_init_fence();
  }
  zero_smem(abuf, nwg * kb * kBox, tid, blockDim.x);
  fence_async_smem();
  __syncthreads();

  if (warp >= cwarps) {   // producer warpgroup: one thread issues the copies
    regs_dec<kProducerRegs>();
    if (warp == cwarps && lane == 0) {
      if (p.in_proj)
        for (int w = 0; w < nwg; ++w) {
          if (tile0 + w * kRows >= p.T) {   // no rows: complete the phase with no copy
            mbar_arrive(xbar + w);
            continue;
          }
          mbar_expect(xbar + w, p.kc_in * kBox);
          for (int kc = 0; kc < p.kc_in; ++kc)
            tma_box(abuf + ((size_t)w * kb + kc) * kBox, &p.tm_x, KW * kc, tile0 + w * kRows,
                    xbar + w);
        }
      // Win^T's tiles, then those of the block's [q | k | v] groups
      const int xin = p.in_proj ? p.kc_in * p.ngc : 0;
      int i = 0;
      for (; i < xin; ++i) ring_fill(ring, i, p.ws, i, p.sb);
      for (int grp = WIDE ? blockIdx.y : 0; grp < ng; grp += WIDE ? gridDim.y : 1)
        for (int k = 0; k < p.kc; ++k, ++i) ring_fill(ring, i, p.ws, xin + grp * p.kc + k, p.sb);
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q = lane & 3;
  const int rl = 16 * wq + g;                 // the lane's rows rl, rl + 8 of the tile
  const int row = tile0 + wg * kRows + rl;
  unsigned char* ab = abuf + (size_t)wg * kb * kBox;
  const uint32_t ab_u = smem_u32(ab);
  bf16* st = reinterpret_cast<bf16*>(stage + wg * qkv_stage_bytes(NCH));
  const int wrows = p.T - (tile0 + wg * kRows);   // the warpgroup's rows below T
  float acc[NCH][24];
  int it = 0;

  // xf, then a = LN(xf) -> bf16 into ab (over x's tile); wide, xf's groups
  // of NW columns through the block's copy of the scratch
  float* const scr = WIDE ? p.scr + (size_t)blockIdx.y * gridDim.x * nwg * kRows * p.ngc * NW
                          : nullptr;
  if (p.in_proj) mbar_wait(xbar + wg, 0);
  for (int gc = 0; gc < (WIDE ? p.ngc : 1); ++gc) {
    if (p.in_proj) {
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int i = 0; i < 24; ++i) acc[ch][i] = 0.f;
      ring_product<NCH, KS>(acc, ab_u, p.kc_in, true, ring, it, lane);
    } else {
      load_rows<NCH>(acc, p.x + gc * NW, p.ldx, p.C - gc * NW, p.T, row, q, false);
    }
    if constexpr (WIDE) scr_store<NCH>(scr, p.ngc * NW, row, gc * NW, acc, q);
  }
  if constexpr (WIDE) {
    float mean[2], inv[2];
    scr_stats<NCH>(acc, scr, p.ngc * NW, row, p.C, p.ngc, q, p.eps, mean, inv);
    wg_bar(wg);   // every warp's x.Win has read ab
    for (int gc = 0; gc < p.ngc; ++gc) {
      scr_load<NCH>(acc, scr, p.ngc * NW, row, gc * NW, q);
      store_a_cols<NCH, KS>(ab, acc, gc * NW, p.C, p.kc, rl, q, mean, inv, p.ln_g, p.ln_b);
    }
  } else {
    wg_bar(wg);   // every warp's x.Win has read ab
    store_a<NCH, KS>(ab, acc, p.C, p.kc, rl, q, p.eps, p.ln_g, p.ln_b);
  }
  fence_async_smem();
  wg_bar(wg);

  // [q | k | v] in groups of NW columns: + bias, q scaled, -> bf16; the
  // block's groups (wide: dealt to gridDim.y blocks a row tile, each with
  // its own xf and LN, the same bits in each)
  for (int grp = WIDE ? blockIdx.y : 0; grp < ng; grp += WIDE ? gridDim.y : 1) {
    const int n0 = grp * NW;
    ring_product<NCH, KS>(acc, ab_u, p.kc, true, ring, it, lane);
    wg_bar(wg);   // the previous group's copy-out has read st
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int c = ch * kChunk + 8 * j + 2 * q, n = min(n0 + c, p.nqkv - 2);
        const float b0 = p.bias[n], b1 = p.bias[n + 1];
        const float sc = n < p.hdp ? p.scale : 1.f;   // x * 1 is x: k and v unscaled
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          stage_pair<NCH>(st, rl + 8 * hf, c, mulf(addf(acc[ch][4 * j + 2 * hf], b0), sc),
                          mulf(addf(acc[ch][4 * j + 2 * hf + 1], b1), sc));
      }
    wg_bar(wg);
    copy_out<NCH>(st, p.qkv + (size_t)(tile0 + wg * kRows) * p.nqkv + n0, p.nqkv, wrows,
                  min(NW, p.nqkv - n0), tid & 127);
  }
}

// ---------------------------------------------------------------------------
// B: attention of one head of one sequence (or 64/L packed sequences)
// ---------------------------------------------------------------------------

struct AttnParams {
  CUtensorMap tm_qkv;   // qkv (T, nqkv) in 64 x 64 boxes
  bf16* ctx;            // (T, ldc) out, columns h dh + d
  int T, L, H, dh, dhp, ldc, G, nt;
  int nqg;              // the streamed kernel's groups of query tiles a sequence
};

// the scores of 64 keys at `ka` for the query tile at `qa` (KD k-steps of
// the head's dhp = 16 KD columns), issued
template <int KD>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t qa, uint32_t ka) {
#pragma unroll
  for (int ks = 0; ks < KD; ++ks) wgmma_n64(s, desc_k(qa + 32 * ks), desc_k(ka + 32 * ks), ks > 0);
}

// the two bf16 halves of a packed pair as f32
__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// scores of key chunk c rounded to bf16 (a lane's two neighbours with one
// conversion: conversions run at a quarter of the f32 rate); keys outside
// [lo, hi) of the row at -inf; the row maxima folded into m
__device__ __forceinline__ void mask_scores(float (&s)[32], int c, int q, const int (&lo)[2],
                                            const int (&hi)[2], float (&m)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = 64 * c + 8 * j + 2 * q, i = 4 * j + 2 * hf;
      const uint32_t r = pack_bf16(s[i], s[i + 1]);
      s[i] = key >= lo[hf] && key < hi[hf] ? lo_f(r) : -INFINITY;
      s[i + 1] = key + 1 >= lo[hf] && key + 1 < hi[hf] ? hi_f(r) : -INFINITY;
      m[hf] = fmaxf(m[hf], fmaxf(s[i], s[i + 1]));
    }
}

// p = exp(s - m) in bf16 (s - m rounded first) added into d (f32) and packed
// as the A fragments of P.V, one per 16-key step. The exp is the hardware
// exp2 of x log2(e): within a few f32 ulps, then rounded to bf16.
__device__ __forceinline__ void probs(const float (&s)[32], const float (&m)[2], float (&d)[2],
                                      uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 4 * (2 * kk + half) + 2 * hf;
        const uint32_t x = pack_bf16(__fsub_rn(s[i], m[hf]), __fsub_rn(s[i + 1], m[hf]));
        const uint32_t pp = pack_bf16(__expf(lo_f(x)), __expf(hi_f(x)));
        d[hf] = addf(addf(d[hf], lo_f(pp)), hi_f(pp));
        pa[kk][2 * half + hf] = pp;
      }
}

// o (+)= P . v over a chunk's four 16-key steps (p is 0 past the keys)
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[4][4], uint32_t va,
                                         bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_n64_rs(o, pa[kk], desc_mn(va + 2048 * kk), first && kk == 0 ? 0 : 1);
}

__device__ __forceinline__ void quad_max(float (&m)[2]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
    m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
    if (m[hf] == -INFINITY) m[hf] = 0.f;   // a packed tile's rows past its sequences
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.f;
}

// NKC key chunks held as scores in registers (L <= 64 NKC), the keys
// walked once; longer sequences take the streamed kernel. KD = dhp / 16.
template <int NKC, int KD>
__global__ void __launch_bounds__(128) layer_attention_kernel(const __grid_constant__ AttnParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int nt = p.nt, L = p.L, h = blockIdx.x % p.H;
  unsigned char* qs = base;
  unsigned char* ks = qs + (size_t)nt * kBox;
  unsigned char* vs = ks + (size_t)nt * kBox;
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + (size_t)nt * kBox);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int row0 = blockIdx.x / p.H * p.G * L;    // the block's first token
  const int lk = p.G > 1 ? p.G * L : L;           // tile columns that hold keys
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    mbar_expect(bar, 3 * nt * kBox);
    for (int t = 0; t < nt; ++t) {
      tma_box(qs + (size_t)t * kBox, &p.tm_qkv, h * p.dhp, row0 + 64 * t, bar);
      tma_box(ks + (size_t)t * kBox, &p.tm_qkv, (p.H + h) * p.dhp, row0 + 64 * t, bar);
      tma_box(vs + (size_t)t * kBox, &p.tm_qkv, (2 * p.H + h) * p.dhp, row0 + 64 * t, bar);
    }
  }
  __syncthreads();
  mbar_wait(bar, 0);
  const uint32_t kb = smem_u32(ks), vb = smem_u32(vs);
  const int rl = 16 * warp + g;                   // the lane's rows rl, rl + 8 of a tile
  int lo[2], hi[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (p.G > 1) {   // packed: the row's own sequence
      lo[hf] = (rl + 8 * hf) / L * L;
      hi[hf] = min(lo[hf] + L, lk);
    } else {
      lo[hf] = 0;
      hi[hf] = L;
    }
  }
  for (int t = 0; t < nt; ++t) {
    const uint32_t qa = smem_u32(qs + (size_t)t * kBox);
    float m[2] = {-INFINITY, -INFINITY}, d[2] = {0.f, 0.f};
    float o[32];
    zero(o);   // accumulators are defined outside the wgmma pipeline
    float s[NKC][32];
#pragma unroll
    for (int c = 0; c < NKC; ++c) zero(s[c]);
    wg_fence();
#pragma unroll
    for (int c = 0; c < NKC; ++c) issue_scores<KD>(s[c], qa, kb + c * kBox);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NKC; ++c) {
      wg_pin(s[c]);
      mask_scores(s[c], c, q, lo, hi, m);
    }
    quad_max(m);
    uint32_t pa[NKC][4][4];
#pragma unroll
    for (int c = 0; c < NKC; ++c) probs(s[c], m, d, pa[c]);
    wg_fence();
#pragma unroll
    for (int c = 0; c < NKC; ++c) issue_pv(o, pa[c], vb + c * kBox, c == 0);
    wg_commit();
    wg_wait<0>();
    wg_pin(o);
    // ctx -> bf16 into the q tile (its products are done; 128-byte swizzled
    // rows), then whole rows of the head out as 4-byte words
    unsigned char* ct = qs + (size_t)t * kBox;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      d[hf] = addf(d[hf], __shfl_xor_sync(0xffffffffu, d[hf], 1));
      d[hf] = addf(d[hf], __shfl_xor_sync(0xffffffffu, d[hf], 2));
      const float inv = __fdiv_rn(1.f, d[hf]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(ct + swz(rl + 8 * hf, 8 * j + 2 * q)) =
            pack_bf16(mulf(o[4 * j + 2 * hf], inv), mulf(o[4 * j + 2 * hf + 1], inv));
    }
    __syncthreads();
    const int words = p.dh / 2;
    for (int i = tid; i < 64 * words; i += 128) {
      const int r = i / words, col = 2 * (i % words);
      const bool ok = p.G > 1 ? r < lk : 64 * t + r < L;
      const int tok = row0 + (p.G > 1 ? r : 64 * t + r);
      if (ok && tok < p.T)
        *reinterpret_cast<uint32_t*>(p.ctx + (size_t)tok * p.ldc + h * p.dh + col) =
            *reinterpret_cast<const uint32_t*>(ct + swz(r, col));
    }
  }
}

// The streamed form (any L >= 64): a block keeps NQ 64-row query tiles of
// one head of one sequence resident and walks the sequence's keys twice in
// 64-key chunks, which one thread of the block sends by TMA through a ring
// of kRing buffers (k alone in the first pass, k and v in the second): the
// first pass takes the rounded scores' true row max, the second forms p
// after it, its f32 sum and P.v, with the resident kernel's arithmetic.
// The block meets once a chunk (its warps have read the buffer), then the
// thread sends the chunk kRing ahead into it. Query
// tiles past the sequence's last repeat it and are not stored, so every
// wgmma is issued unconditionally.
constexpr int kRing = 4;     // chunk buffers (each a k box and a v box)
constexpr int kStreamQ = 4;  // query tiles a block

template <int NQ, int KD>
__global__ void __launch_bounds__(128) layer_attention_stream_kernel(
    const __grid_constant__ AttnParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int nt = p.nt, L = p.L, h = blockIdx.x % p.H;
  const int qg = blockIdx.x / p.H % p.nqg, seq = blockIdx.x / p.H / p.nqg;
  unsigned char* qs = base;                                // NQ query tiles
  unsigned char* ring = qs + (size_t)NQ * kBox;            // kRing x (k box, v box)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)kRing * 2 * kBox);
  uint64_t* qbar = full + kRing;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int row0 = seq * L;                                // the sequence's first token
  const int kc = (p.H + h) * p.dhp, vc = (2 * p.H + h) * p.dhp;
  // item i of the stream: chunk i's k (first pass), then chunk i - nt's k and v
  auto send = [&](int i) {
    unsigned char* dst = ring + (size_t)(i % kRing) * 2 * kBox;
    const int c = i < nt ? i : i - nt;
    mbar_expect(full + i % kRing, i < nt ? kBox : 2 * kBox);
    tma_box(dst, &p.tm_qkv, kc, row0 + 64 * c, full + i % kRing);
    if (i >= nt) tma_box(dst + kBox, &p.tm_qkv, vc, row0 + 64 * c, full + i % kRing);
  };
  if (tid == 0) {
    for (int r = 0; r < kRing; ++r) mbar_init(full + r, 1);
    mbar_init(qbar, 1);
    mbar_init_fence();
    mbar_expect(qbar, NQ * kBox);
    for (int j = 0; j < NQ; ++j)
      tma_box(qs + (size_t)j * kBox, &p.tm_qkv, h * p.dhp,
              row0 + 64 * min(qg * NQ + j, nt - 1), qbar);
    for (int i = 0; i < kRing && i < 2 * nt; ++i) send(i);
  }
  __syncthreads();
  mbar_wait(qbar, 0);
  const uint32_t qb = smem_u32(qs);
  const int rl = 16 * warp + g;
  const int lo[2] = {0, 0}, hi[2] = {L, L};
  float m[NQ][2], d[NQ][2];
#pragma unroll
  for (int j = 0; j < NQ; ++j) m[j][0] = m[j][1] = -INFINITY, d[j][0] = d[j][1] = 0.f;
  // the chunk's buffer is read by every warp: send the item kRing ahead
  auto release = [&](int i) {
    __syncthreads();
    if (tid == 0 && i + kRing < 2 * nt) send(i + kRing);
  };
  for (int c = 0; c < nt; ++c) {   // the true row max first
    mbar_wait(full + c % kRing, (c / kRing) & 1);
    const uint32_t ka = smem_u32(ring + (size_t)(c % kRing) * 2 * kBox);
    float s[NQ][32];
#pragma unroll
    for (int j = 0; j < NQ; ++j) zero(s[j]);
    wg_fence();
#pragma unroll
    for (int j = 0; j < NQ; ++j) issue_scores<KD>(s[j], qb + j * kBox, ka);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      wg_pin(s[j]);
      mask_scores(s[j], c, q, lo, hi, m[j]);
    }
    release(c);
  }
#pragma unroll
  for (int j = 0; j < NQ; ++j) quad_max(m[j]);
  float o[NQ][32];
#pragma unroll
  for (int j = 0; j < NQ; ++j) zero(o[j]);   // accumulators are defined outside the pipeline
  for (int c = 0; c < nt; ++c) {
    const int i = nt + c;
    mbar_wait(full + i % kRing, (i / kRing) & 1);
    const uint32_t ka = smem_u32(ring + (size_t)(i % kRing) * 2 * kBox), va = ka + kBox;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      float s[32], unused[2] = {0.f, 0.f};
      uint32_t pa[4][4];
      zero(s);
      wg_fence();
      issue_scores<KD>(s, qb + j * kBox, ka);
      wg_commit();
      wg_wait<0>();   // also tile j - 1's P.v, whose p registers are written again
      wg_pin(s);
      mask_scores(s, c, q, lo, hi, unused);
      probs(s, m[j], d[j], pa);
      wg_fence();
      issue_pv(o[j], pa, va, c == 0);
      wg_commit();
    }
    wg_wait<0>();
#pragma unroll
    for (int j = 0; j < NQ; ++j) wg_pin(o[j]);
    release(i);
  }
  // ctx -> bf16 into the query tiles (128-byte swizzled rows), then whole
  // rows of the head out as 4-byte words
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    unsigned char* ct = qs + (size_t)j * kBox;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float dd = d[j][hf];
      dd = addf(dd, __shfl_xor_sync(0xffffffffu, dd, 1));
      dd = addf(dd, __shfl_xor_sync(0xffffffffu, dd, 2));
      const float inv = __fdiv_rn(1.f, dd);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<uint32_t*>(ct + swz(rl + 8 * hf, 8 * jj + 2 * q)) =
            pack_bf16(mulf(o[j][4 * jj + 2 * hf], inv), mulf(o[j][4 * jj + 2 * hf + 1], inv));
    }
  }
  __syncthreads();
  const int words = p.dh / 2;
  for (int i = tid; i < NQ * 64 * words; i += 128) {
    const int j = i / (64 * words), r = i / words % 64, col = 2 * (i % words);
    const int lr = 64 * (qg * NQ + j) + r;   // the row within the sequence
    if (lr < L && row0 + lr < p.T)
      *reinterpret_cast<uint32_t*>(p.ctx + (size_t)(row0 + lr) * p.ldc + h * p.dh + col) =
          *reinterpret_cast<const uint32_t*>(qs + (size_t)j * kBox + swz(r, col));
  }
}

// ---------------------------------------------------------------------------
// C: xf + ctx.Wo -> LN2 -> FFN -> (final LN) -> (out-projection)
// ---------------------------------------------------------------------------

struct FfnParams {
  CUtensorMap tm_x;           // x (T, Cin) in 64 x 64 boxes; with in_proj
  CUtensorMap tm_ctx;         // ctx (T, C)
  const bf16* x;              // (T, C) without in_proj
  // Win^T, Wo^T (wide: both by groups of NW rows), per F chunk Wi^T (kc
  // tiles) and Wo2^T (wide: per group, every F chunk), Wout^T
  const unsigned char* ws;
  const float *bo, *ln2g, *ln2b, *bi, *bo2, *ln3g, *ln3b, *osc, *obi;
  bf16* out;                  // (T, Cout) at row stride ldo (a multiple of 8)
  float* scr;                 // wide: x1, then o, gridDim.y x (row tiles x 64 rows, ngc NW) f32
  int T, Cin, ldx, C, Cout, ldo, nf, in_proj, final_ln, out_proj, out_act, kc_in, kc, sb, stages,
      nwg, ngc;
  float eps, final_eps;
};

// The FFN's order in the weight stream: Wi(f) before Wo2(f); or, pipelined
// where C <= 144 (NCH <= kMaxPipeNch) leaves the registers for two h
// accumulators (chunk f + 1's y.Wi runs while chunk f's SiLU does), Wi(0),
// then Wi(f + 1) before Wo2(f), then Wo2(nf - 1). The wrapper lays the
// stream out in one order or the other (ffn_pipelined in
// ops/fused_transformer_layer.py) and says which (`pipe`); the plan refuses
// an order the kernel is not built for.

// shared memory of one consumer warpgroup: x's tile, ctx's (then y's, then
// o's) tile, one h1 chunk
__host__ __device__ inline int ffn_wg_boxes(int in_proj, int kc_in, int kc) {
  return (in_proj ? kc_in : 0) + kc + 1;
}

// bytes of stream tile i: a Wi tile is one box (64 F columns), every other
// tile sb (the FFN's tiles: nf chunks, ngc times over when wide)
__device__ __forceinline__ int ffn_tile_bytes(const FfnParams& p, int i, bool pipelined,
                                              int ngc) {
  const int j = i - ngc * ((p.in_proj ? p.kc_in : 0) + p.kc);   // position in the FFN's tiles
  if (j < 0 || j >= ngc * p.nf * (p.kc + 1)) return p.sb;
  if (!pipelined) return j % (p.kc + 1) < p.kc ? kBox : p.sb;
  if (j < p.kc) return kBox;
  return (j - p.kc) % (p.kc + 1) < p.kc && j < p.nf * (p.kc + 1) - 1 ? kBox : p.sb;
}

// issue (no wait) h = A . the next nkc ring tiles of 64 B rows
template <int KS>
__device__ __forceinline__ void issue_product64(float (&h)[32], uint32_t a, int nkc,
                                                const Ring& r, int& it) {
  for (int kc = 0; kc < nkc; ++kc, ++it) {
    const int s = it % r.stages;
    mbar_wait(r.full + s, (it / r.stages) & 1);
    const uint32_t bt = smem_u32(r.buf + (size_t)s * r.sb), at = a + kc * kBox;
    const int keep = kc == 0 ? 0 : 1;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_n64(h, desc_k(at + 32 * ks), desc_k(bt + 32 * ks), ks > 0 ? 1 : keep);
    wg_commit();
  }
}

// issue (no wait) acc += A (64 K) . the next ring tile
template <int NCH>
__device__ __forceinline__ void issue_product48(float (&acc)[NCH][24], uint32_t a,
                                                const Ring& r, int& it) {
  const int s = it % r.stages;
  mbar_wait(r.full + s, (it / r.stages) & 1);
  const uint32_t bt = smem_u32(r.buf + (size_t)s * r.sb);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
      wgmma_n48(acc[ch], desc_k(a + 32 * ks), desc_k(bt + ch * kChunkBytes + 32 * ks), 1);
  wg_commit();
  ++it;
}

template <int NCH, int KS, bool WIDE>
__global__ void __launch_bounds__(kMaxThreads, 1)
    layer_proj_ffn_kernel(const __grid_constant__ FfnParams p) {
  constexpr int NW = NCH * kChunk, KW = 16 * KS;
  constexpr bool PIPE = !WIDE && NCH <= kMaxPipeNch;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int S = p.stages, xk = p.in_proj ? p.kc_in : 0;
  const int wgb = ffn_wg_boxes(p.in_proj, p.kc_in, p.kc);
  const int nwg = p.nwg, cwarps = 4 * nwg;                // consumer warpgroups, warps
  unsigned char* wbuf = base + (size_t)S * p.sb;          // nwg x wgb boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(wbuf + (size_t)nwg * wgb * kBox);
  uint64_t* empty = full + S;
  uint64_t* xbar = empty + S;
  uint64_t* cbar = xbar + 2;
  const Ring ring{base, full, empty, S, p.sb};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile0 = blockIdx.x * nwg * kRows;
  const int nog = cdiv(p.Cout, NW);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, cwarps);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(xbar + w, 1);
      mbar_init(cbar + w, 1);
    }
    mbar_init_fence();
  }
  zero_smem(wbuf, nwg * wgb * kBox, tid, blockDim.x);
  fence_async_smem();
  __syncthreads();

  if (warp >= cwarps) {   // producer warpgroup: one thread issues the copies
    regs_dec<kProducerRegs>();
    if (warp == cwarps && lane == 0) {
      for (int w = 0; w < nwg; ++w) {
        const int r0 = tile0 + w * kRows;
        if (r0 >= p.T) {   // no rows: complete the phases with no copy
          mbar_arrive(xbar + w);
          mbar_arrive(cbar + w);
          continue;
        }
        unsigned char* wb = wbuf + (size_t)w * wgb * kBox;
        if (p.in_proj) {
          mbar_expect(xbar + w, p.kc_in * kBox);
          for (int kc = 0; kc < p.kc_in; ++kc)
            tma_box(wb + (size_t)kc * kBox, &p.tm_x, KW * kc, r0, xbar + w);
        }
        mbar_expect(cbar + w, p.kc * kBox);
        for (int kc = 0; kc < p.kc; ++kc)
          tma_box(wb + (size_t)(xk + kc) * kBox, &p.tm_ctx, KW * kc, r0, cbar + w);
      }
      if constexpr (WIDE) {
        // x1's tiles, then the FFN's of the block's groups of output
        // columns, then Wout^T's
        const int x1t = p.ngc * (xk + p.kc), ffn = p.nf * (p.kc + 1);
        int i = 0;
        for (; i < x1t; ++i) ring_fill(ring, i, p.ws, i, p.sb);
        for (int g = blockIdx.y; g < p.ngc; g += gridDim.y)
          for (int t = 0; t < ffn; ++t, ++i) {
            const int src = x1t + g * ffn + t;
            ring_fill(ring, i, p.ws, src, ffn_tile_bytes(p, src, false, p.ngc));
          }
        for (int t = 0; t < (p.out_proj ? nog * p.kc : 0); ++t, ++i)
          ring_fill(ring, i, p.ws, x1t + p.ngc * ffn + t, p.sb);
      } else {
        const int nt = xk + p.kc + p.nf * (p.kc + 1) + (p.out_proj ? nog * p.kc : 0);
        for (int i = 0; i < nt; ++i) ring_fill(ring, i, p.ws, i, ffn_tile_bytes(p, i, PIPE, 1));
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q = lane & 3;
  const int rl = 16 * wq + g;
  const int row = tile0 + wg * kRows + rl;
  unsigned char* wb = wbuf + (size_t)wg * wgb * kBox;
  unsigned char* cb = wb + (size_t)xk * kBox;             // ctx, then y, then o -> bf16
  unsigned char* hb = cb + (size_t)p.kc * kBox;           // one h1 chunk
  const uint32_t xb_u = smem_u32(wb), cb_u = smem_u32(cb), hb_u = smem_u32(hb);
  float acc[NCH][24];
  int it = 0;

  // x1 = xf + ctx.Wo + bo, kept in acc to the end of the FFN (wide: in the
  // block's copy of the scratch, group by group): with in_proj the products
  // of ctx.Wo add onto xf = x.Win, else xf is added after them. One group of
  // C keeps code of its own here and below: the wide loops run once were
  // 4-11% slower at the model's widths on an H100 (PERF.md)
  float* const scr = WIDE ? p.scr + (size_t)blockIdx.y * gridDim.x * nwg * kRows * p.ngc * NW
                          : nullptr;
  if constexpr (WIDE) {
    for (int gc = 0; gc < p.ngc; ++gc) {
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int i = 0; i < 24; ++i) acc[ch][i] = 0.f;
      if (p.in_proj) {
        mbar_wait(xbar + wg, 0);   // (a phase once complete stays so: no wait after the first)
        ring_product<NCH, KS>(acc, xb_u, p.kc_in, true, ring, it, lane);
      }
      mbar_wait(cbar + wg, 0);
      ring_product<NCH, KS>(acc, cb_u, p.kc, !p.in_proj, ring, it, lane);
      if (!p.in_proj) load_rows<NCH>(acc, p.x + gc * NW, p.ldx, p.C - gc * NW, p.T, row, q, true);
      add_bias<NCH>(acc, p.bo + gc * NW, p.C - gc * NW, q);
      scr_store<NCH>(scr, p.ngc * NW, row, gc * NW, acc, q);
    }
    // y = LN2(x1) -> bf16 into cb
    float mean[2], inv[2];
    scr_stats<NCH>(acc, scr, p.ngc * NW, row, p.C, p.ngc, q, p.eps, mean, inv);
    wg_bar(wg);   // every warp's ctx.Wo has read cb
    for (int gc = 0; gc < p.ngc; ++gc) {
      scr_load<NCH>(acc, scr, p.ngc * NW, row, gc * NW, q);
      store_a_cols<NCH, KS>(cb, acc, gc * NW, p.C, p.kc, rl, q, mean, inv, p.ln2g, p.ln2b);
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int i = 0; i < 24; ++i) acc[ch][i] = 0.f;
    if (p.in_proj) {
      mbar_wait(xbar + wg, 0);
      ring_product<NCH, KS>(acc, xb_u, p.kc_in, true, ring, it, lane);
    }
    mbar_wait(cbar + wg, 0);
    ring_product<NCH, KS>(acc, cb_u, p.kc, !p.in_proj, ring, it, lane);
    if (!p.in_proj) load_rows<NCH>(acc, p.x, p.ldx, p.C, p.T, row, q, true);
    add_bias<NCH>(acc, p.bo, p.C, q);
    wg_bar(wg);   // every warp's ctx.Wo has read cb
    store_a<NCH, KS>(cb, acc, p.C, p.kc, rl, q, p.eps, p.ln2g, p.ln2b);   // y = LN2(x1)
  }
  fence_async_smem();
  wg_bar(wg);

  // the FFN, 64 columns of F at a time: h1 = SiLU(y.Wi + bi) -> bf16 in hb, acc += h1.Wo2
  auto silu_chunk = [&](const float (&h)[32], int f) {
    wg_bar(wg);   // every warp's previous h1.Wo2 has read hb
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * q;
      const float b0 = p.bi[64 * f + col], b1 = p.bi[64 * f + col + 1];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<uint32_t*>(hb + swz(rl + 8 * hf, col)) =
            pack_bf16(silu_fast(addf(h[4 * j + 2 * hf], b0)),
                      silu_fast(addf(h[4 * j + 2 * hf + 1], b1)));
    }
    fence_async_smem();
    wg_bar(wg);
  };
  if constexpr (PIPE) {
    float h0[32], h1[32];
    // chunk f's SiLU beside chunk f + 1's y.Wi; then h1.Wo2; tiles go back
    // once both are done
    auto step = [&](const float (&cur)[32], float (&nxt)[32], int f) {
      const int t0 = it;
      zero(nxt);   // defined outside the wgmma pipeline
      issue_product64<KS>(nxt, cb_u, p.kc, ring, it);
      silu_chunk(cur, f);
      issue_product48<NCH>(acc, hb_u, ring, it);
      wg_wait<0>();
      wg_pin(nxt);
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) wg_pin(acc[ch]);
      for (int i = t0; i < it; ++i) ring_release(ring, i, lane);
    };
    auto last = [&](const float (&cur)[32], int f) {
      silu_chunk(cur, f);
      issue_product48<NCH>(acc, hb_u, ring, it);
      wg_wait<0>();
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) wg_pin(acc[ch]);
      ring_release(ring, it - 1, lane);
    };
    zero(h0);
    ring_product64<KS>(h0, cb_u, p.kc, ring, it, lane);
    int f = 0;
    for (; f + 2 < p.nf; f += 2) {
      step(h0, h1, f);
      step(h1, h0, f + 1);
    }
    if (p.nf - f == 2) {
      step(h0, h1, f);
      last(h1, f + 1);
    } else {
      last(h0, f);
    }
  } else {
    auto ffn = [&]() {
      for (int f = 0; f < p.nf; ++f) {
        float hacc[32];
        zero(hacc);   // defined outside the wgmma pipeline
        ring_product64<KS>(hacc, cb_u, p.kc, ring, it, lane);
        silu_chunk(hacc, f);
        ring_product<NCH, 4>(acc, hb_u, 1, false, ring, it, lane);
      }
    };
    if constexpr (WIDE) {
      // the block's groups of output columns in turn (all of them, or dealt
      // to gridDim.y blocks a row tile where neither the final LN nor the
      // out-projection needs the whole row), each from x1 in the scratch,
      // y.Wi and its SiLU again for each; o back into the scratch
      for (int gc = blockIdx.y; gc < p.ngc; gc += gridDim.y) {
        scr_load<NCH>(acc, scr, p.ngc * NW, row, gc * NW, q);
        ffn();
        add_bias<NCH>(acc, p.bo2 + gc * NW, p.C - gc * NW, q);
        scr_store<NCH>(scr, p.ngc * NW, row, gc * NW, acc, q);
      }
    } else {
      ffn();
    }
  }

  // o = x1 + h1.Wo2 + bo2, the block's final LN; out (without the
  // out-projection) or o -> bf16 into cb, the out-projection's A tile,
  // staged in cb and hb (free now; (kc + 1) boxes hold (64, NW + 8)). Wide,
  // group by group from the scratch
  if constexpr (WIDE) {
    float mean[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
    if (p.final_ln)
      scr_stats<NCH>(acc, scr, p.ngc * NW, row, p.C, p.ngc, q, p.final_eps, mean, inv);
    wg_bar(wg);   // every warp's last products have read cb and hb
    for (int gc = blockIdx.y; gc < p.ngc; gc += gridDim.y) {
      const int n0 = gc * NW;
      scr_load<NCH>(acc, scr, p.ngc * NW, row, n0, q);
      if (p.final_ln) ln_apply<NCH>(acc, n0, p.C, q, mean, inv, p.ln3g, p.ln3b);
      if (p.out_proj) {
        store_a_cols<NCH, KS>(cb, acc, n0, p.C, p.kc, rl, q, mean, inv, nullptr, nullptr);
        continue;
      }
      bf16* st = reinterpret_cast<bf16*>(cb);
      if (gc > (int)blockIdx.y) wg_bar(wg);   // the previous group's copy-out has read st
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            stage_pair<NCH>(st, rl + 8 * hf, ch * kChunk + 8 * j + 2 * q,
                            acc[ch][4 * j + 2 * hf], acc[ch][4 * j + 2 * hf + 1]);
      wg_bar(wg);
      copy_out<NCH>(st, p.out + (size_t)(tile0 + wg * kRows) * p.ldo + n0, p.ldo,
                    p.T - (tile0 + wg * kRows), min(NW, (p.C - n0 + 7) / 8 * 8), tid & 127);
    }
    if (!p.out_proj) return;
  } else {
    add_bias<NCH>(acc, p.bo2, p.C, q);
    if (p.final_ln) ln_inplace<NCH>(acc, p.C, q, p.final_eps, p.ln3g, p.ln3b);
    if (!p.out_proj) {
      bf16* st = reinterpret_cast<bf16*>(cb);
      wg_bar(wg);   // every warp's last products have read cb and hb
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            stage_pair<NCH>(st, rl + 8 * hf, ch * kChunk + 8 * j + 2 * q,
                            acc[ch][4 * j + 2 * hf], acc[ch][4 * j + 2 * hf + 1]);
      wg_bar(wg);
      copy_out<NCH>(st, p.out + (size_t)(tile0 + wg * kRows) * p.ldo, p.ldo,
                    p.T - (tile0 + wg * kRows), (p.C + 7) / 8 * 8, tid & 127);
      return;
    }
    wg_bar(wg);   // every warp's last y.Wi has read cb
    store_a<NCH, KS>(cb, acc, p.C, p.kc, rl, q, 0.f, nullptr, nullptr);
  }

  // the out-projection: (o -> bf16) . Wout * bn_scale + bn_bias (, SiLU)
  fence_async_smem();
  wg_bar(wg);
  for (int og = 0; og < nog; ++og) {
    const int n0 = og * NW;
    ring_product<NCH, KS>(acc, cb_u, p.kc, true, ring, it, lane);
    // the last group (the only one where Cout <= NW) goes out through cb and
    // hb, free once its products are done; an earlier one from registers
    const bool staged = og == nog - 1;
    bf16* st = reinterpret_cast<bf16*>(cb);
    if (staged) wg_bar(wg);   // every warp's products have read cb
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int c = ch * kChunk + 8 * j + 2 * q, n = min(n0 + c, p.Cout - 1);
        float v[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ne = min(n + e, p.Cout - 1);
          const float sc = p.osc[ne], bi = p.obi[ne];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            v[hf][e] = addf(mulf(acc[ch][4 * j + 2 * hf + e], sc), bi);
            if (p.out_act) v[hf][e] = silu_fast(v[hf][e]);
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (staged) {
            stage_pair<NCH>(st, rl + 8 * hf, c, v[hf][0], v[hf][1]);
            continue;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (row + 8 * hf < p.T && n0 + c + e < p.Cout)
              p.out[(size_t)(row + 8 * hf) * p.ldo + n0 + c + e] = __float2bfloat16_rn(v[hf][e]);
        }
      }
    if (staged) {
      wg_bar(wg);
      copy_out<NCH>(st, p.out + (size_t)(tile0 + wg * kRows) * p.ldo + n0, p.ldo,
                    p.T - (tile0 + wg * kRows), (p.Cout - n0 + 7) / 8 * 8, tid & 127);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// a (rows, cols) bf16 array with row stride `ld` as a tensor map read in
// 64 x 64 boxes with the 128-byte swizzle; reads past the array give zeros
int make_map(CUtensorMap* m, const void* ptr, int cols, int rows, int ld) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t es[2] = {1, 1};
  const CUresult res = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                          strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the launch's sizes, from the layer's shapes
struct Sizes {
  int nch, sb, kc_in, kc, hdp, nqkv, G, nt, nqg, ngc;
};

Sizes sizes(const LayerArgs& a) {
  Sizes z;
  const int kw = 16 * a.ks;
  z.nch = a.nw / kChunk;
  z.sb = (z.nch * kChunk > 64 ? z.nch * kChunk : 64) * 128;
  z.kc_in = cdiv(a.Cin, kw);
  z.kc = cdiv(a.C, kw);
  z.hdp = a.H * a.dhp;
  z.nqkv = 3 * z.hdp;
  z.G = a.L < 64 ? 64 / a.L : 1;
  z.nt = z.G > 1 ? 1 : cdiv(a.L, 64);
  z.nqg = cdiv(z.nt, kStreamQ);   // the streamed attention's blocks a sequence and head
  z.ngc = a.nw > 0 ? cdiv(a.C, a.nw) : 0;   // groups of C's columns: 1, or wide 2 or more
  return z;
}

// the attention's plans: 1 resident (a head's q, k and v whole in shared
// memory), 2 streamed (NQ query tiles resident, the keys through a ring)
constexpr int kResident = 1, kStreamed = 2;

size_t attn_smem(const Sizes& z, int plan) {
  if (plan == kStreamed) return 1024 + (size_t)(kStreamQ + 2 * kRing) * kBox + (kRing + 1) * 8;
  return 1024 + (size_t)3 * z.nt * kBox + 8;
}

size_t smem_fixed(const LayerArgs& a, const Sizes& z, int kind) {
  if (kind == 0)
    return 1024 + (size_t)a.nwg * qkv_tile_chunks(a.in_proj, z.kc_in, z.kc) * kBox +
           (size_t)a.nwg * qkv_stage_bytes(z.nch) + (2 * kMaxStages + 2) * 8;
  if (kind == 2)
    return 1024 + (size_t)a.nwg * ffn_wg_boxes(a.in_proj, z.kc_in, z.kc) * kBox +
           (2 * kMaxStages + 4) * 8;
  return attn_smem(z, a.attn);
}

// ring depth: the caller's, else `least`; 0 if that does not fit. The sweep
// (PERF.md) found no gain from a deeper ring than the kernel needs: ln_qkv is
// fastest at two buffers, proj_ffn within 3% at any depth.
int plan_stages(size_t fixed, int sb, int want, int least, int max_smem) {
  if (fixed > (size_t)max_smem) return 0;
  int most = (int)((max_smem - fixed) / sb);
  if (most > kMaxStages) most = kMaxStages;
  const int s = want ? want : least;
  return s >= least && s <= most ? s : 0;
}

// bytes of dynamic shared memory of a launch: kind 0 ln_qkv, 1 attention,
// 2 proj_ffn (at the planned ring depth)
size_t smem_bytes(const LayerArgs& a, int kind) {
  const Sizes z = sizes(a);
  const int stages = kind == 0 ? a.stages_a : a.stages_c;
  return smem_fixed(a, z, kind) + (kind == 1 ? 0 : (size_t)stages * z.sb);
}

template <typename P>
int launch(void (*kernel)(P), const P& p, dim3 grid, int threads, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<P*>(&p)};
  err = cudaLaunchKernel((void*)kernel, grid, threads, args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// kernels by (NCH, KS, WIDE) and (NKC, KD)
// the row-tile kernels: nwg consumer warpgroups of 64 rows and a producer one
template <int NCH, bool WIDE>
int launch_qkv(int ks, const QkvParams& p, dim3 grid, size_t smem, void* stream) {
  const int threads = 128 * p.nwg + 128;
  return ks == 3 ? launch(layer_ln_qkv_kernel<NCH, 3, WIDE>, p, grid, threads, smem, stream)
                 : launch(layer_ln_qkv_kernel<NCH, 4, WIDE>, p, grid, threads, smem, stream);
}
template <int NCH, bool WIDE>
int launch_ffn(int ks, const FfnParams& p, dim3 grid, size_t smem, void* stream) {
  const int threads = 128 * p.nwg + 128;
  return ks == 3 ? launch(layer_proj_ffn_kernel<NCH, 3, WIDE>, p, grid, threads, smem, stream)
                 : launch(layer_proj_ffn_kernel<NCH, 4, WIDE>, p, grid, threads, smem, stream);
}

template <int NQ>
int launch_stream(int kd, const AttnParams& p, dim3 grid, size_t smem, void* stream) {
  switch (kd) {
    case 1: return launch(layer_attention_stream_kernel<NQ, 1>, p, grid, 128, smem, stream);
    case 2: return launch(layer_attention_stream_kernel<NQ, 2>, p, grid, 128, smem, stream);
    case 3: return launch(layer_attention_stream_kernel<NQ, 3>, p, grid, 128, smem, stream);
    case 4: return launch(layer_attention_stream_kernel<NQ, 4>, p, grid, 128, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}
template <int NKC>
int launch_attn(int kd, const AttnParams& p, dim3 grid, size_t smem, void* stream) {
  switch (kd) {
    case 1: return launch(layer_attention_kernel<NKC, 1>, p, grid, 128, smem, stream);
    case 2: return launch(layer_attention_kernel<NKC, 2>, p, grid, 128, smem, stream);
    case 3: return launch(layer_attention_kernel<NKC, 3>, p, grid, 128, smem, stream);
    case 4: return launch(layer_attention_kernel<NKC, 4>, p, grid, 128, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Checks the shapes the kernels take and the wrapper's stream layout (nw
// output columns a C-wide product, in kChunk-column wgmma chunks: C rounded
// up to kChunk, or wide groups of 4-6 chunks whose columns cover the K
// chunks; K chunks of 16 ks; `pipe`, the FFN's order) and fills the two
// rings' depths (a nonzero depth asked for is kept if it fits `max_smem`);
// 1 if the layer fits, else 0.
extern "C" int gxt_layer_plan(LayerArgs* a, int max_smem) {
  if (a->L <= 0 || a->L % 8 || a->H <= 0 || a->C % a->H || a->dh != a->C / a->H || a->dh % 2 ||
      a->dh > 64 || a->dhp != (a->dh + 15) / 16 * 16 || a->Cin <= 0 || a->Cout <= 0 ||
      a->nf <= 0 || (a->ks != 3 && a->ks != 4) || (a->nwg != 1 && a->nwg != 2) ||
      (!a->in_proj && a->Cin != a->C) || (!a->out_proj && a->Cout != a->C) ||
      a->nw <= 0 || a->nw % kChunk || a->nw >= a->C + kChunk || (a->pipe != 0 && a->pipe != 1))
    return 0;
  const Sizes z = sizes(*a);
  if (z.nch > kMaxNch) return 0;
  if (z.ngc > 1 ? a->pipe || z.nch < kMinWideNch || z.ngc * a->nw < z.kc * 16 * a->ks
                : (a->pipe != 0) != (z.nch <= kMaxPipeNch))
    return 0;
  // the attention: resident up to kMaxQTiles query tiles, streamed past
  // them (L >= 64: one sequence a tile; at 576 keys it ran 1% faster than
  // the resident kernel walking the keys twice, on an H100: PERF.md); a
  // plan asked for is kept if it fits
  const bool resident = z.nt <= kMaxQTiles && attn_smem(z, kResident) <= (size_t)max_smem;
  const bool streamed = z.G == 1 && attn_smem(z, kStreamed) <= (size_t)max_smem;
  if (a->attn == 0) a->attn = resident ? kResident : kStreamed;
  if ((a->attn == kResident && !resident) || (a->attn == kStreamed && !streamed) ||
      (a->attn != kResident && a->attn != kStreamed))
    return 0;
  a->stages_a = plan_stages(smem_fixed(*a, z, 0), z.sb, a->stages_a, 2, max_smem);
  // the pipelined FFN holds kc + 1 tiles while it waits for the next
  a->stages_c = plan_stages(smem_fixed(*a, z, 2), z.sb, a->stages_c, a->pipe ? z.kc + 2 : 2,
                            max_smem);
  return a->stages_a && a->stages_c ? 1 : 0;
}

extern "C" int gxt_layer_ln_qkv(const LayerArgs* a, void* stream) {
  if (a->T <= 0) return 0;
  const Sizes z = sizes(*a);
  QkvParams p;
  memset(&p, 0, sizeof(p));
  int code;
  if (a->in_proj && (code = make_map(&p.tm_x, a->x, a->Cin, a->T, a->ldx))) return code;
  p.x = static_cast<const bf16*>(a->x);
  p.ws = static_cast<const unsigned char*>(a->wa);
  p.ln_g = static_cast<const float*>(a->ln1g);
  p.ln_b = static_cast<const float*>(a->ln1b);
  p.bias = static_cast<const float*>(a->bqkv);
  p.qkv = static_cast<bf16*>(const_cast<void*>(a->qkv));
  p.scr = static_cast<float*>(const_cast<void*>(a->scr));
  p.T = a->T; p.Cin = a->Cin; p.ldx = a->ldx; p.C = a->C; p.nqkv = z.nqkv; p.hdp = z.hdp;
  p.in_proj = a->in_proj; p.kc_in = z.kc_in; p.kc = z.kc; p.sb = z.sb; p.stages = a->stages_a;
  p.eps = a->eps; p.scale = a->scale; p.nwg = a->nwg; p.ngc = z.ngc;
  if (p.stages < 2 || p.stages > kMaxStages || (p.nwg != 1 && p.nwg != 2) || p.ngc < 1 ||
      (p.ngc > 1 && !p.scr))
    return (int)cudaErrorInvalidValue;
  // wide: the [q | k | v] groups dealt to qsplit blocks a row tile (the
  // wrapper's choice; each block its own copy of the scratch)
  if (a->qsplit < 1 || a->qsplit > cdiv(z.nqkv, z.nch * kChunk) || (z.ngc == 1 && a->qsplit != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(a->T, p.nwg * kRows), a->qsplit);
  const size_t smem = smem_bytes(*a, 0);
  if (z.ngc > 1) {
    switch (z.nch) {
      case 4: return launch_qkv<4, true>(a->ks, p, grid, smem, stream);
      case 5: return launch_qkv<5, true>(a->ks, p, grid, smem, stream);
      case 6: return launch_qkv<6, true>(a->ks, p, grid, smem, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (z.nch) {
    case 1: return launch_qkv<1, false>(a->ks, p, grid, smem, stream);
    case 2: return launch_qkv<2, false>(a->ks, p, grid, smem, stream);
    case 3: return launch_qkv<3, false>(a->ks, p, grid, smem, stream);
    case 4: return launch_qkv<4, false>(a->ks, p, grid, smem, stream);
    case 5: return launch_qkv<5, false>(a->ks, p, grid, smem, stream);
    case 6: return launch_qkv<6, false>(a->ks, p, grid, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int gxt_layer_attention(const LayerArgs* a, void* stream) {
  if (a->T <= 0) return 0;
  const Sizes z = sizes(*a);
  AttnParams p;
  memset(&p, 0, sizeof(p));
  int code;
  if ((code = make_map(&p.tm_qkv, a->qkv, z.nqkv, a->T, z.nqkv))) return code;
  p.ctx = static_cast<bf16*>(const_cast<void*>(a->ctx));
  p.T = a->T; p.L = a->L; p.H = a->H; p.dh = a->dh; p.dhp = a->dhp; p.ldc = a->ldc;
  p.G = z.G; p.nt = z.nt; p.nqg = z.nqg;
  // a sequence's heads in neighbouring blocks: each box also reads the next
  // head's first columns, which that head's block then finds in L2
  const int bp = a->T / a->L, kd = a->dhp / 16;
  const size_t smem = smem_bytes(*a, 1);
  if (a->attn == kStreamed) {
    if (z.G != 1) return (int)cudaErrorInvalidValue;
    return launch_stream<kStreamQ>(kd, p, dim3(a->H * z.nqg * bp), smem, stream);
  }
  if (a->attn != kResident || z.nt > kMaxQTiles) return (int)cudaErrorInvalidValue;
  const dim3 grid(a->H * cdiv(bp, z.G));
  switch (z.nt) {
    case 1: return launch_attn<1>(kd, p, grid, smem, stream);
    case 2: return launch_attn<2>(kd, p, grid, smem, stream);
    case 3: return launch_attn<3>(kd, p, grid, smem, stream);
    case 4: return launch_attn<4>(kd, p, grid, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int gxt_layer_proj_ffn(const LayerArgs* a, void* stream) {
  if (a->T <= 0) return 0;
  const Sizes z = sizes(*a);
  FfnParams p;
  memset(&p, 0, sizeof(p));
  int code;
  if (a->in_proj && (code = make_map(&p.tm_x, a->x, a->Cin, a->T, a->ldx))) return code;
  if ((code = make_map(&p.tm_ctx, a->ctx, a->C, a->T, a->ldc))) return code;
  p.x = static_cast<const bf16*>(a->x);
  p.ws = static_cast<const unsigned char*>(a->wc);
  p.bo = static_cast<const float*>(a->bo);
  p.ln2g = static_cast<const float*>(a->ln2g);
  p.ln2b = static_cast<const float*>(a->ln2b);
  p.bi = static_cast<const float*>(a->bi);
  p.bo2 = static_cast<const float*>(a->bo2);
  p.ln3g = static_cast<const float*>(a->ln3g);
  p.ln3b = static_cast<const float*>(a->ln3b);
  p.osc = static_cast<const float*>(a->osc);
  p.obi = static_cast<const float*>(a->obi);
  p.out = static_cast<bf16*>(const_cast<void*>(a->out));
  p.scr = static_cast<float*>(const_cast<void*>(a->scr));
  p.T = a->T; p.Cin = a->Cin; p.ldx = a->ldx; p.C = a->C; p.Cout = a->Cout; p.ldo = a->ldo;
  p.nf = a->nf;
  p.in_proj = a->in_proj; p.final_ln = a->final_ln; p.out_proj = a->out_proj;
  p.out_act = a->out_act; p.kc_in = z.kc_in; p.kc = z.kc; p.sb = z.sb; p.stages = a->stages_c;
  p.eps = a->eps; p.final_eps = a->final_eps; p.nwg = a->nwg; p.ngc = z.ngc;
  if (p.stages < 2 || p.stages > kMaxStages || p.ldo % 8 || p.ldo < p.Cout ||
      (p.nwg != 1 && p.nwg != 2) || p.ngc < 1 || (p.ngc > 1 && (!p.scr || a->pipe)) ||
      (p.ngc == 1 && (a->pipe != 0) != (z.nch <= kMaxPipeNch)) ||
      (a->pipe && p.stages < z.kc + 2))
    return (int)cudaErrorInvalidValue;
  // wide, without the final LN and the out-projection: the FFN's groups of
  // output columns dealt to fsplit blocks a row tile (the wrapper's choice;
  // each block its own copy of the scratch)
  if (a->fsplit < 1 || a->fsplit > z.ngc ||
      (a->fsplit > 1 && (a->final_ln || a->out_proj)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(a->T, p.nwg * kRows), a->fsplit);
  const size_t smem = smem_bytes(*a, 2);
  if (z.ngc > 1) {
    switch (z.nch) {
      case 4: return launch_ffn<4, true>(a->ks, p, grid, smem, stream);
      case 5: return launch_ffn<5, true>(a->ks, p, grid, smem, stream);
      case 6: return launch_ffn<6, true>(a->ks, p, grid, smem, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (z.nch) {
    case 1: return launch_ffn<1, false>(a->ks, p, grid, smem, stream);
    case 2: return launch_ffn<2, false>(a->ks, p, grid, smem, stream);
    case 3: return launch_ffn<3, false>(a->ks, p, grid, smem, stream);
    case 4: return launch_ffn<4, false>(a->ks, p, grid, smem, stream);
    case 5: return launch_ffn<5, false>(a->ks, p, grid, smem, stream);
    case 6: return launch_ffn<6, false>(a->ks, p, grid, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The layer: ln_qkv, attention, proj_ffn on one stream, in order.
extern "C" int gxt_layer_forward(const LayerArgs* a, void* stream) {
  int code = gxt_layer_ln_qkv(a, stream);
  if (!code) code = gxt_layer_attention(a, stream);
  if (!code) code = gxt_layer_proj_ffn(a, stream);
  return code;
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
