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
// Every product runs as 3xTF32 (each operand split into a tf32 high part
// and its remainder, three products, small terms first), so the sums keep
// f32 accuracy. LN statistics (mean, then the mean squared deviation),
// softmax and SiLU are f32 with every rounding written out (__fadd_rn /
// __fmul_rn, the correctly rounded reciprocal and square root), so nothing
// is contracted that the plain version computes in two steps, but for the
// attention's exponent, one fma into the MUFU's exp2 (design of B). No
// atomics and a fixed order of sums: two launches give the same bits.
//
// Bound on an H100 at the main path's shapes (bp = 512; (L, C, F) = (256,
// 144, 288), (64, 192, 384), (16, 240, 480)): the operations, about 232
// GFLOP a forward's nine layers at 3xTF32's 165 TFLOP/s (1.4 ms), against
// 12 bytes a token and channel in and out of each kernel; at 512 px layer_3
// (L = 1024) adds 310 GFLOP of attention a layer (1.9 ms).
//
// Design of A and C (the row tiles). A block is one or two consumer
// warpgroups of 64 rows each (one where T / 128 tiles would leave
// multiprocessors idle, or where two do not fit shared memory: the wrapper's
// plan, nwg_a / nwg_c) and a producer warpgroup, one thread of which issues
// every copy and whose registers go to the consumers (setmaxnreg 40 / 232).
//   * Weights: the wrapper splits each once into tf32 hi and lo planes of
//     B^T (output columns x K), K-major, in tiles of one 32-wide K chunk
//     (128-byte rows, the 128-byte swizzle wgmma reads) by W output columns,
//     stored in the order the block consumes them: a stream the producer
//     copies tile by tile (bulk copies) into a ring of `stages` buffers, one
//     copy serving the block's 64 or 128 rows. A tile goes back once the
//     block's products have read it.
//   * x (with the input projection) and ctx arrive by TMA (2-D tensor maps,
//     32-column f32 boxes of 64 rows, 128-byte swizzle; rows past T read as
//     zeros and are not stored); x without the projection is read into
//     registers. LN's output (the A operand of q/k/v, of Wi, of Wout) and
//     each SiLU'd FFN chunk go into the warpgroup's own tiles in the same
//     layout, a warp writing and reading its own 16 rows only.
//   * Products: tf32 wgmma m64nWk8 with A in registers, B in the ring.
//     A's fragments are read from the swizzled tile and split into tf32 hi
//     and lo once a k-step of a product (by truncation: split_tf32_rz),
//     then lo.hi + hi.lo + hi.hi issued for all W columns. C-wide products
//     (Win, Wo, Wo2, Wout) run in NCH chunks of W columns (C padded to 48
//     NC: C = 144 as 2 x 72, 192 as 2 x 96, 240 as 3 x 80), q/k/v in chunks
//     of 144 of the 3C real columns (heads' zero padding is not computed:
//     it is written as zeros), the FFN in chunks of 96. Each chunk's sum is
//     fresh (chained on the tensor cores over its K only), then added in
//     f32 where the plain version adds: xf, x1 = xf + ctx.Wo + bo and o =
//     x1 + sum of the FFN chunks' h1.Wo2 + bo2 stay in registers (C <=
//     240), LN's statistics come from them (the four lanes of a row add in
//     a fixed order), and the FFN walks F in 96-column chunks: y.Wi -> SiLU
//     -> the chunk's tile -> its Wo2 sums added to x1, so h1 is never whole
//     in shared memory.
//   * q/k/v go out as f32 pairs from registers (each warp's store fills
//     whole 32-byte sectors), through a table of each real column's place
//     in the padded array; the heads' padding as float4 zeros after.
//   * The rows' vectors (LN gamma and beta, the biases, BN scale and bias)
//     and that table are staged in shared memory at a block's start: read
//     from global memory beside the C-wide sums they were loaded one by one
//     and held the LN, bias and SiLU passes back. The SiLUs are silu_rn
//     (mma_common.cuh): 0 below z = -86.64, where the plain version gives
//     about -1e-36.
// On an H100 the products run near the tensor rate inside a block; the
// passes between them (LN, SiLU, the q/k/v stores) are serial per
// warpgroup, and the two warpgroups keep step on the shared ring (PERF.md
// §6 row 6).
// Design of B (attention). A block owns one head of a window of whole
// sequences: one sequence of L >= 64 tokens (all of its query rows), or
// G = 64 / L sequences packed into one 64-row tile (L < 64; each row's
// keys bounded to its own sequence, as the bf16 form's mask_scores). Its
// rows are its keys, at most 256: the scores of whole rows stay in
// registers, so the keys are walked once, against the true row max.
//   * q, k and v arrive by TMA from the q/k/v array (a 2-D tensor map of
//     8-column boxes of 64 rows, the 32-byte swizzle: one k-step of tf32 a
//     box, so a head of 36 takes 5 k-steps, not two 32-wide boxes): k and v
//     of all the window's keys once, q a 64-row tile at a time into each
//     consumer warpgroup's buffer (the next tile's copy issued as soon as
//     the warpgroup's q.k^T has read the last).
//   * k serves as its own tf32 hi plane (the tensor cores read an f32
//     word's top bits); the block writes k's lo remainder once, over v's
//     staging area, after one transposing pass has written v^T K-major
//     (keys contiguous) as raw values and lo remainders. Within each 8-key
//     k-step, key 2c goes to k-column c and key 2c + 1 to column c + 4, so
//     that the score accumulator is the A fragment of P.v as it stands.
//   * S = q.k^T: tf32 wgmma m64nNKk8 with A in registers, q's fragment
//     split by truncation once a k-step (split_tf32_rz) into lo.hi + hi.lo
//     + hi.hi, NK = the keys rounded up to 64, 128 or 256 (128 scores a
//     thread at 256), keys outside a row's sequence at -inf. The row max
//     from registers and quad shuffles.
//   * p = exp(s - max) as 2^(s log2(e) - max log2(e)): one fma into the
//     MUFU's exp2, where expf(s - max) took about ten instructions (10% of
//     L = 256's time on an H100). The result stays within a few f32 ulps of
//     the plain version's torch.exp where p matters, and an error in
//     max log2(e) scales a row's p alike, which p / sum(p) cancels. Then
//     its sum, and P.v on tf32 wgmma m64n(dhp)k8 one 8-key k-step at a
//     time, p's fragments split in registers, B = v^T's raw and lo planes;
//     the exponentials of a k-step run beside the products of the steps
//     before it.
//   * ctx = (p.v) * (1 / sum) stored from registers, each warp's store
//     filling whole 32-byte sectors; rows past the block's sequences (or
//     past T) not stored.
//   * Past 256 keys (layer_3 at 512 px: L = 1024) a block takes two query
//     tiles of one head of one sequence and walks the keys in windows of 256
//     (128 past dhp = 48) with a running max (layer_attention_f32_stream_kernel).
//   A persistent grid (the blocks that are resident at once) walks the
//   windows. One or two consumer warpgroups a block take its 64-row tiles
//   in turn (the wrapper's plan: two where a window has two tiles or more);
//   the second's first q.k^T waits for the first's, so that one's products
//   run beside the other's softmax. Once both warpgroups' last q.k^T of a
//   window is done, k's, the staging's and the q tiles' buffers are free,
//   and one thread sends the next window's copies, which land beside the
//   last P.v; so no producer warpgroup is needed. At L = 256 a block holds
//   about 205 KB of k, v and q: one block a multiprocessor.
#include <string.h>

#include "hopper_common.cuh"
#include "mma_common.cuh"

// Field order and types match the ctypes Structure _F32Args in
// ops/fused_transformer_layer.py.
struct LayerF32Args {
  const void *x, *qkv, *ctx, *out, *wa, *wc;
  const void *ln1g, *ln1b, *bqkv, *bo, *ln2g, *ln2b, *bi, *bo2, *ln3g, *ln3b, *osc, *obi;
  int T, L, Cin, ldx, C, H, dh, dhp, ldc, F, Cout, ldo, in_proj, final_ln, out_proj, out_act,
      nwg_a, nwg_c, stages_a, stages_c, nwg_b;
  float eps, final_eps, scale;
};

namespace {

using namespace gxt;

constexpr int kRows = 64;          // rows of a consumer warpgroup
constexpr int kMaxThreads = 384;   // two consumer warpgroups and a producer one
constexpr int kBox = 8192;         // a 64 x 32 f32 tile: 64 rows of 128 bytes
constexpr int kKC = 32;            // K of a weight tile: one 128-byte row
constexpr int kQW = 144;           // q/k/v columns of a product
constexpr int kFW = 96;            // FFN columns of a chunk
constexpr int kMaxNC = 5;          // C <= 240: x1 in registers
constexpr int kMaxStages = 6;
constexpr int kSmemLimit = 232448;   // an H100 block's shared memory

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// C-wide sums: NC units of 48 columns, in NCH products of W columns
__host__ __device__ constexpr int units(int c) { return (c + 47) / 48; }
__host__ __device__ constexpr int nchunks(int nc) { return (nc + 1) / 2; }
__host__ __device__ constexpr int chunk_w(int nc) { return 48 * nc / nchunks(nc); }

bool takes(const LayerF32Args& a) {
  return a.T >= 0 && a.L > 0 && a.T % a.L == 0 && a.H > 0 && a.C == a.H * a.dh && a.dh > 0 &&
         a.dh <= 64 && a.dhp == pad16(a.dh) && a.Cin > 0 && a.F > 0 && a.Cout > 0 &&
         (a.in_proj || a.Cin == a.C) && (a.out_proj || a.Cout == a.C);
}

// what the row-tile kernels add: C-wide sums in registers (C <= 240), TMA
// boxes (16-byte row strides of x with the projection and of ctx), pairs of
// x (without it) and of the output (without the out-projection)
bool rows_take(const LayerF32Args& a) {
  return a.C <= 48 * kMaxNC && a.C % 4 == 0 && a.ldc % 4 == 0 && a.ldc >= a.C &&
         (a.in_proj ? a.Cin % 4 == 0 && a.ldx % 4 == 0 : a.ldx % 2 == 0) && a.ldx >= a.Cin &&
         a.ldo >= a.Cout && (a.out_proj || a.ldo % 2 == 0);
}

// the row-tile kernels' sizes
struct Dims {
  int nc, nch, w;       // units of 48 columns of C; products of w columns covering them
  int nkin, nkc;        // 32-wide K chunks of Cin and of C
  int nq, nf, noc;      // q/k/v products of kQW columns, FFN chunks, out-projection products
  int cp;               // C padded to whole units: a staged vector's length
  int nba;              // ln_qkv: boxes of a warpgroup's tile (x, then LN's output)
  int nbx, nbc;         // proj_ffn: boxes of x's (then h1's) and of ctx's (then y's, o's) tiles
  int sba, sbc;         // bytes of a ring buffer (the widest weight tile)
  int ta, tc;           // weight tiles of each stream
};

__host__ __device__ inline Dims dims(const LayerF32Args& a) {
  Dims d;
  d.nc = units(a.C);
  d.nch = nchunks(d.nc);
  d.w = chunk_w(d.nc);
  d.cp = 48 * d.nc;
  d.nkin = cdiv(a.Cin, kKC);
  d.nkc = cdiv(a.C, kKC);
  d.nq = cdiv(3 * a.C, kQW);
  d.nf = cdiv(a.F, kFW);
  d.noc = cdiv(a.Cout, d.w);
  const int xin = a.in_proj ? d.nkin : 0;
  d.nba = xin > d.nkc ? xin : d.nkc;
  d.nbx = xin > kFW / kKC ? xin : kFW / kKC;
  d.nbc = d.nkc;
  d.sba = (d.w > kQW ? d.w : kQW) * 256;
  d.sbc = (d.w > kFW ? d.w : kFW) * 256;
  d.ta = (a.in_proj ? d.nch * d.nkin : 0) + d.nq * d.nkc;
  d.tc = (a.in_proj ? d.nch * d.nkin : 0) + d.nch * d.nkc + d.nf * (d.nkc + d.nch * kFW / kKC) +
         (a.out_proj ? d.noc * d.nkc : 0);
  return d;
}

// floats of the vectors a block stages in shared memory (each padded with
// zeros): ln_qkv's LN gamma and beta, then the q/k/v biases and (ints) the
// q/k/v array's column of each product column; proj_ffn's bo, LN2 gamma
// and beta, bo2, final LN gamma and beta, bi, BN scale and bias
__host__ __device__ inline int vec_ln_qkv(const Dims& d) { return 2 * d.cp + 2 * d.nq * kQW; }
__host__ __device__ inline int vec_proj_ffn(const Dims& d) {
  return 6 * d.cp + d.nf * kFW + 2 * d.noc * d.w;
}

// bytes of a block's shared memory besides the ring: the 1024-byte
// alignment of the base, the warpgroups' tiles, the staged vectors, the
// barriers
size_t fixed_ln_qkv(const Dims& d, int nwg) {
  return 1024 + (size_t)nwg * d.nba * kBox + (size_t)4 * vec_ln_qkv(d) + 8 * (2 * kMaxStages + 2);
}
size_t fixed_proj_ffn(const Dims& d, int nwg) {
  return 1024 + (size_t)nwg * (d.nbx + d.nbc) * kBox + (size_t)4 * vec_proj_ffn(d) +
         8 * (2 * kMaxStages + 4);
}
size_t smem_ln_qkv(const LayerF32Args& a) {
  const Dims d = dims(a);
  return fixed_ln_qkv(d, a.nwg_a) + (size_t)a.stages_a * d.sba;
}
size_t smem_proj_ffn(const LayerF32Args& a) {
  const Dims d = dims(a);
  return fixed_proj_ffn(d, a.nwg_c) + (size_t)a.stages_c * d.sbc;
}

bool plan_ok(int nwg, int stages, size_t smem) {
  return (nwg == 1 || nwg == 2) && stages >= 2 && stages <= kMaxStages && smem <= kSmemLimit;
}

// the attention's windows: G = 64 / L sequences packed into one tile where
// L < 64, else one sequence; `rows` tokens a window (its keys) in nt 64-row
// query tiles over nwg consumer warpgroups; nk keys (the rows rounded up to
// 64, 128 or 256), ks k-steps of q.k^T. Past kMaxKeys rows (`stream`) a
// block takes nwg query tiles of one head of one sequence and walks its keys
// in windows of nk (256; 128 past dhp = 48), `windows` then counting the
// blocks.
struct AttnPlan {
  int rows, nk, ks, nt, nwg, windows, stream;
  size_t smem;
};

constexpr int kMaxKeys = 256;   // a row's scores in registers
constexpr int kQTile = 2048;    // a k-step of a 64-row q tile: 64 rows of 32 bytes

// bytes of an attention block's shared memory: the 1024-byte alignment, k
// (ks k-steps of nk rows), v's staging then k's lo (dhp / 8 k-steps of nk
// rows), v^T's raw and lo planes (nk / 8 k-steps of dhp rows each), each
// warpgroup's q tile, the barriers
size_t attn_smem(int nk, int ks, int dhp, int nwg) {
  return 1024 + (size_t)32 * nk * ks + (size_t)12 * nk * dhp + (size_t)kQTile * nwg * ks + 24;
}

// the plan of the args' attention (nwg_b consumer warpgroups: 1, or 2 where
// the block has two tiles or more); false where the kernel does not take
// it (a window past kMaxKeys, or past the shared memory)
bool attn_plan(const LayerF32Args& a, AttnPlan& p) {
  const int G = a.L < 64 ? 64 / a.L : 1;
  p.rows = G * a.L;
  p.ks = cdiv(a.dh, 8);
  p.nt = cdiv(p.rows, 64);
  p.nwg = a.nwg_b;
  p.stream = p.rows > kMaxKeys;
  if (p.stream) {
    p.nk = p.ks <= 6 ? 256 : 128;
    p.windows = a.T / a.L * a.H * (p.nwg > 0 ? cdiv(p.nt, p.nwg) : 0);
  } else {
    p.nk = p.rows <= 64 ? 64 : p.rows <= 128 ? 128 : 256;
    p.windows = cdiv(a.T / a.L, G) * a.H;
  }
  p.smem = attn_smem(p.nk, p.ks, a.dhp, p.nwg);
  return (p.nwg == 1 || p.nwg == 2) && p.nwg <= p.nt && p.smem <= kSmemLimit;
}

// ---------------------------------------------------------------------------
// the row-tile kernels: ring, products, epilogues
// ---------------------------------------------------------------------------

struct RowF32Params {
  CUtensorMap tm_x;     // x (T, Cin) in 32 x 64 boxes: with the input projection
  CUtensorMap tm_ctx;   // ctx (T, C): proj_ffn
  LayerF32Args a;
};

// The weight ring: `stages` buffers of `sb` bytes. Tile i of the stream (at
// i * sb bytes of it) goes to buffer i % stages once the consumer warps have
// released the buffer's previous tile.
struct Ring {
  unsigned char* buf;
  uint64_t* full;
  uint64_t* empty;
  int stages, sb;
};

__device__ __forceinline__ void ring_fill(const Ring& r, int i, const unsigned char* stream,
                                          int bytes) {
  const int s = i % r.stages;
  if (i >= r.stages) mbar_wait(r.empty + s, (i / r.stages - 1) & 1);
  mbar_expect(r.full + s, bytes);
  bulk_load(r.buf + (size_t)s * r.sb, stream + (size_t)i * r.sb, bytes, r.full + s);
}

// one TMA copy of a (32, 64) f32 box of a 2-D tensor map, completing on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* tm, int c0, int c1,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// x = hi + lo exactly, hi x's top 11 significant bits (tf32 by truncation):
// the tensor cores read lo's top 11 bits, so lo.hi + hi.lo + hi.hi keeps
// about 2^-21 of each product (split_tf32's round to nearest keeps about
// 2^-22, at five times the instructions, which held the products back)
__device__ __forceinline__ void split_tf32_rz(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// acc (+)= the warpgroup's A rows (the 32-column box at `a`; the lane reads
// rows arow, arow + 8) . ring tile `it` (W rows of B^T's hi plane, then W
// of its lo plane, K = 32) in 3xTF32. A's fragments are split into tf32 hi
// and lo as they are read (split_tf32_rz), once a k-step for all W columns,
// into one of two register sets (a set is written again once the products
// of two steps back are done). kFirst: the first product overwrites acc,
// whose registers no other instruction defines (ptxas serialises the wgmmas
// otherwise).
// Returns with the tile's products done and the tile given back. Measured
// slower on an H100 (PERF.md §6): releasing a tile one step later, with
// the next tile's first products in flight; any other work (stores, SiLUs)
// between a product's k-steps.
template <int W, bool kFirst>
__device__ __forceinline__ void tile_product(float (&acc)[W / 2], const unsigned char* a,
                                             const Ring& r, int it, int arow, int tq, int lane) {
  const int s = it % r.stages;
  mbar_wait(r.full + s, (it / r.stages) & 1);
  const uint32_t bh = smem_u32(r.buf + (size_t)s * r.sb), bl = bh + W * 128;
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int ks = 0; ks < kKC / 8; ++ks) {
    const int f = ks & 1;
    if (ks >= 2) wg_wait<1>();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = arow + 8 * (e & 1), k = 8 * ks + tq + 4 * (e >> 1);
      split_tf32_rz(*reinterpret_cast<const float*>(a + swz4(row, k)), ah[f][e], al[f][e]);
    }
    wg_fence();
    wgmma_tf32_rs<W>(acc, al[f], desc_k(bh + 32 * ks), kFirst && ks == 0 ? 0 : 1);
    wgmma_tf32_rs<W>(acc, ah[f], desc_k(bl + 32 * ks), 1);
    wgmma_tf32_rs<W>(acc, ah[f], desc_k(bh + 32 * ks), 1);
    wg_commit();
  }
  wg_wait<0>();
  __syncwarp();
  if (lane == 0) mbar_arrive(r.empty + s);
}

// acc = A (nk boxes from `a`, 8 KB apart) . the next nk ring tiles: a fresh
// sum, chained on the tensor cores over this K only
template <int W>
__device__ __forceinline__ void product(float (&acc)[W / 2], const unsigned char* a, int nk,
                                        const Ring& r, int& it, int arow, int tq, int lane) {
  tile_product<W, true>(acc, a, r, it++, arow, tq, lane);
  for (int kc = 1; kc < nk; ++kc)
    tile_product<W, false>(acc, a + kc * kBox, r, it++, arow, tq, lane);
  wg_pin(acc);
}

// A C-wide row array v[NV] holds the lane's columns 8 G + 2 q (+1) of rows
// rl and rl + 8 (the wgmma accumulator layout over NV / 4 groups of 8
// columns): column 8 G + 2 q + e of row rl + 8 hf is v[4 G + 2 hf + e]. A
// product chunk of W columns from column c0 is v[2 c0 ..] on.

// v = rows `row`, row + 8 of x (T rows of C columns, stride ld), zero past
// C and past T (clamped loads, then selects)
template <int NV>
__device__ __forceinline__ void load_rows(float (&v)[NV], const float* x, int ld, int C, int T,
                                          int row, int q) {
#pragma unroll
  for (int G = 0; G < NV / 4; ++G) {
    const int col = 8 * G + 2 * q;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row + 8 * hf;
      const float2 w = __ldg(reinterpret_cast<const float2*>(
          x + (size_t)min(r, T - 1) * ld + min(col, C - 2)));
      const bool ok = r < T && col < C;
      v[4 * G + 2 * hf] = ok ? w.x : 0.f;
      v[4 * G + 2 * hf + 1] = ok ? w.y : 0.f;
    }
  }
}

// LN statistics of the lane's two rows over C columns (f32: the mean, then
// the mean squared deviation; the four lanes of a row add in a fixed order)
template <int NV>
__device__ __forceinline__ void ln_stats(const float (&v)[NV], int C, int q, float eps,
                                         float (&mean)[2], float (&inv)[2]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float s = 0.f;
#pragma unroll
    for (int G = 0; G < NV / 4; ++G)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * G + 2 * q + e < C) s = addf(s, v[4 * G + 2 * hf + e]);
    s = addf(s, __shfl_xor_sync(0xffffffffu, s, 1));
    s = addf(s, __shfl_xor_sync(0xffffffffu, s, 2));
    const float m = __fdiv_rn(s, (float)C);
    float var = 0.f;
#pragma unroll
    for (int G = 0; G < NV / 4; ++G)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * G + 2 * q + e < C) {
          const float dv = __fsub_rn(v[4 * G + 2 * hf + e], m);
          var = addf(var, mulf(dv, dv));
        }
    var = addf(var, __shfl_xor_sync(0xffffffffu, var, 1));
    var = addf(var, __shfl_xor_sync(0xffffffffu, var, 2));
    mean[hf] = m;
    inv[hf] = __fdiv_rn(1.f, __fsqrt_rn(addf(__fdiv_rn(var, (float)C), eps)));
  }
}

// LN(v) in place with gamma, beta (staged, zero past C) over C columns;
// zero past C
template <int NV>
__device__ __forceinline__ void ln_rows(float (&v)[NV], int C, int q, float eps, const float* gam,
                                        const float* bet) {
  float mean[2], inv[2];
  ln_stats<NV>(v, C, q, eps, mean, inv);
#pragma unroll
  for (int G = 0; G < NV / 4; ++G) {
    const int col = 8 * G + 2 * q;
    const float2 g = *reinterpret_cast<const float2*>(gam + col);
    const float2 b = *reinterpret_cast<const float2*>(bet + col);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float& x = v[4 * G + 2 * hf + e];
        const float y = addf(mulf(mulf(__fsub_rn(x, mean[hf]), inv[hf]), e ? g.y : g.x),
                             e ? b.y : b.x);
        x = col + e < C ? y : 0.f;
      }
  }
}

// v + b[col] (b staged, zero past C: v stays zero there)
template <int NV>
__device__ __forceinline__ void add_vec(float (&v)[NV], const float* b, int q) {
#pragma unroll
  for (int G = 0; G < NV / 4; ++G) {
    const float2 bb = *reinterpret_cast<const float2*>(b + 8 * G + 2 * q);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      v[4 * G + 2 * hf] = addf(v[4 * G + 2 * hf], bb.x);
      v[4 * G + 2 * hf + 1] = addf(v[4 * G + 2 * hf + 1], bb.y);
    }
  }
}

// v (zero past C), or with gam LN(v) over C columns (gam, bet staged; zero
// past C), as the lane's rows rl, rl + 8 of a warpgroup tile of nb
// 32-column boxes at t; the box columns past the array's 2 NV are zeroed
template <int NV>
__device__ __forceinline__ void store_tile(unsigned char* t, const float (&v)[NV], int nb, int rl,
                                           int q, int C = 0, float eps = 0.f,
                                           const float* gam = nullptr,
                                           const float* bet = nullptr) {
  float mean[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  if (gam) ln_stats<NV>(v, C, q, eps, mean, inv);
#pragma unroll
  for (int G = 0; G < NV / 4; ++G) {
    const int col = 8 * G + 2 * q;
    if (col >= kKC * nb) continue;
    const float2 g = gam ? *reinterpret_cast<const float2*>(gam + col) : make_float2(0.f, 0.f);
    const float2 b = gam ? *reinterpret_cast<const float2*>(bet + col) : make_float2(0.f, 0.f);
    float y[2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float x = v[4 * G + 2 * hf + e];
        y[hf][e] = !gam ? x
                   : col + e < C
                       ? addf(mulf(mulf(__fsub_rn(x, mean[hf]), inv[hf]), e ? g.y : g.x),
                              e ? b.y : b.x)
                       : 0.f;
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(t + (col / kKC) * kBox + swz4(rl + 8 * hf, col % kKC)) =
          make_float2(y[hf][0], y[hf][1]);
  }
  for (int col = 2 * NV + 2 * q; col < kKC * nb; col += 8)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(t + (col / kKC) * kBox + swz4(rl + 8 * hf, col % kKC)) =
          make_float2(0.f, 0.f);
}

// n floats of `src` (n0 of them, the rest zero; none where src is null)
// into the staged vector dst, by the block's threads
__device__ __forceinline__ void stage(float* dst, const void* src, int n0, int n) {
  const float* s = static_cast<const float*>(src);
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = s && i < n0 ? s[i] : 0.f;
}

// ---------------------------------------------------------------------------
// A: x (or x.Win) -> LN1 -> q, k, v
// ---------------------------------------------------------------------------

template <int NC>
__global__ void __launch_bounds__(kMaxThreads, 1)
    layer_ln_qkv_f32_kernel(const __grid_constant__ RowF32Params p) {
  constexpr int NCH = nchunks(NC), W = chunk_w(NC), NV = 24 * NC;
  const LayerF32Args& a = p.a;
  const Dims d = dims(a);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int S = a.stages_a, nwg = a.nwg_a, cwarps = 4 * nwg;
  unsigned char* abuf = base + (size_t)S * d.sba;               // nwg tiles of nba boxes
  float* lng = reinterpret_cast<float*>(abuf + (size_t)nwg * d.nba * kBox);   // staged
  float* lnb = lng + d.cp;
  float* qbias = lnb + d.cp;
  int* qmap = reinterpret_cast<int*>(qbias + d.nq * kQW);
  uint64_t* full = reinterpret_cast<uint64_t*>(qmap + d.nq * kQW);
  uint64_t* empty = full + kMaxStages;
  uint64_t* xbar = empty + kMaxStages;
  const Ring ring{base, full, empty, S, d.sba};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile0 = blockIdx.x * nwg * kRows;
  const int hq = a.H * a.dhp, nqkv = 3 * hq;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, cwarps);
    }
    mbar_init(xbar, 1);
    mbar_init(xbar + 1, 1);
    mbar_init_fence();
  }
  stage(lng, a.ln1g, a.C, d.cp);
  stage(lnb, a.ln1b, a.C, d.cp);
  stage(qbias, a.bqkv, 3 * a.C, d.nq * kQW);
  // the q/k/v array's column of each product column n < 3C ([q | k | v],
  // heads of dh), -1 past 3C
  for (int n = tid; n < d.nq * kQW; n += blockDim.x) {
    int col = -1;
    if (n < 3 * a.C) {
      const int part = n / a.C, r = n - part * a.C, head = r / a.dh;
      col = part * hq + head * a.dhp + r - head * a.dh;
    }
    qmap[n] = col;
  }
  __syncthreads();

  if (warp >= cwarps) {   // producer warpgroup: one thread issues the copies
    regs_dec<kProducerRegs>();
    if (warp == cwarps && lane == 0) {
      if (a.in_proj)
        for (int w = 0; w < nwg; ++w) {
          const int r0 = tile0 + w * kRows;
          if (r0 >= a.T) {   // no rows: complete the phase with no copy
            mbar_arrive(xbar + w);
            continue;
          }
          mbar_expect(xbar + w, d.nkin * kBox);
          for (int kc = 0; kc < d.nkin; ++kc)
            tma_box(abuf + ((size_t)w * d.nba + kc) * kBox, &p.tm_x, kKC * kc, r0, xbar + w);
        }
      const unsigned char* ws = static_cast<const unsigned char*>(a.wa);
      int i = 0;
      if (a.in_proj)
        for (int t = 0; t < NCH * d.nkin; ++t) ring_fill(ring, i++, ws, W * 256);
      for (int t = 0; t < d.nq * d.nkc; ++t) ring_fill(ring, i++, ws, kQW * 256);
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
  const int rl = 16 * (warp & 3) + g;             // the lane's rows rl, rl + 8 of the tile
  const int row = tile0 + wg * kRows + rl;
  unsigned char* ab = abuf + (size_t)wg * d.nba * kBox;
  float xf[NV];
  int it = 0;

  // xf, then a = LN(xf) into ab over x's tile (a warp's own rows: its
  // products have read them)
  if (a.in_proj) {
    mbar_wait(xbar + wg, 0);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      float acc[W / 2];
      product<W>(acc, ab, d.nkin, ring, it, rl, q, lane);
#pragma unroll
      for (int i = 0; i < W / 2; ++i) xf[ch * (W / 2) + i] = acc[i];
    }
  } else {
    load_rows<NV>(xf, static_cast<const float*>(a.x), a.ldx, a.C, a.T, row, q);
  }
  store_tile<NV>(ab, xf, d.nkc, rl, q, a.C, a.eps, lng, lnb);
  __syncwarp();

  // [q | k | v] in products of kQW real columns (nq = NC of them): + bias, q
  // scaled, into the padded array, in pairs from registers (each warp's
  // store fills whole 32-byte sectors). Measured slower on an H100 (PERF.md
  // §6): staging the rows in shared memory and sending them by bulk
  // copies; each chunk's stores beside the next chunk's products; the
  // heads' padding written beside their last columns.
  float* qkv = static_cast<float*>(const_cast<void*>(a.qkv));
  for (int qc = 0; qc < NC; ++qc) {
    float acc[kQW / 2];
    product<kQW>(acc, ab, d.nkc, ring, it, rl, q, lane);
#pragma unroll
    for (int j = 0; j < kQW / 8; ++j) {
      const int n = qc * kQW + 8 * j + 2 * q;
      const int2 cc = *reinterpret_cast<const int2*>(qmap + n);
      const float2 bb = *reinterpret_cast<const float2*>(qbias + n);
      const float s0 = n < a.C ? a.scale : 1.f, s1 = n + 1 < a.C ? a.scale : 1.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = row + 8 * hf;
        if (r >= a.T) continue;
        const float v0 = mulf(addf(acc[4 * j + 2 * hf], bb.x), s0);   // x * 1 is x
        const float v1 = mulf(addf(acc[4 * j + 2 * hf + 1], bb.y), s1);
        float* dst = qkv + (size_t)r * nqkv;
        if (cc.x >= 0 && cc.y == cc.x + 1 && !(cc.x & 1)) {
          *reinterpret_cast<float2*>(dst + cc.x) = make_float2(v0, v1);
        } else {
          if (cc.x >= 0) dst[cc.x] = v0;
          if (cc.y >= 0) dst[cc.y] = v1;
        }
      }
    }
  }
  // the heads' padding columns of the warp's 16 rows: zeros; padding column
  // i of a row is head i / pw's (the quotient exact in f32 below 2^22), in
  // float4s where dh is a multiple of 4
  const int pw = a.dhp - a.dh;
  const bool v4 = !(a.dh & 3);
  const int pu = v4 ? pw / 4 : pw, np = 3 * a.H * pu;
  const float inv_pu = pu ? 1.f / pu : 0.f;
  const int wrow0 = tile0 + wg * kRows + 16 * (warp & 3);
  for (int r = wrow0; r < min(wrow0 + 16, a.T); ++r)
    for (int i = lane; i < np; i += 32) {
      const int hh = (int)(((float)i + 0.5f) * inv_pu), u = i - hh * pu;
      float* dst = qkv + (size_t)r * nqkv + hh * a.dhp + a.dh;
      if (v4)
        *reinterpret_cast<float4*>(dst + 4 * u) = make_float4(0.f, 0.f, 0.f, 0.f);
      else
        dst[u] = 0.f;
    }
}

// ---------------------------------------------------------------------------
// C: xf + ctx.Wo -> LN2 -> FFN -> (final LN) -> (out-projection)
// ---------------------------------------------------------------------------

template <int NC>
__global__ void __launch_bounds__(kMaxThreads, 1)
    layer_proj_ffn_f32_kernel(const __grid_constant__ RowF32Params p) {
  constexpr int NCH = nchunks(NC), W = chunk_w(NC), NV = 24 * NC;
  constexpr int FK = kFW / kKC;   // K chunks of an FFN chunk
  const LayerF32Args& a = p.a;
  const Dims d = dims(a);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int S = a.stages_c, nwg = a.nwg_c, cwarps = 4 * nwg;
  unsigned char* wbuf = base + (size_t)S * d.sbc;   // per warpgroup: nbx + nbc boxes
  float* vbo = reinterpret_cast<float*>(wbuf + (size_t)nwg * (d.nbx + d.nbc) * kBox);   // staged
  float* vln2g = vbo + d.cp;
  float* vln2b = vln2g + d.cp;
  float* vbo2 = vln2b + d.cp;
  float* vln3g = vbo2 + d.cp;
  float* vln3b = vln3g + d.cp;
  float* vbi = vln3b + d.cp;
  float* vosc = vbi + d.nf * kFW;
  float* vobi = vosc + d.noc * d.w;
  uint64_t* full = reinterpret_cast<uint64_t*>(vobi + d.noc * d.w);
  uint64_t* empty = full + kMaxStages;
  uint64_t* xbar = empty + kMaxStages;
  uint64_t* cbar = xbar + 2;
  const Ring ring{base, full, empty, S, d.sbc};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile0 = blockIdx.x * nwg * kRows;
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
  stage(vbo, a.bo, a.C, d.cp);
  stage(vln2g, a.ln2g, a.C, d.cp);
  stage(vln2b, a.ln2b, a.C, d.cp);
  stage(vbo2, a.bo2, a.C, d.cp);
  stage(vln3g, a.ln3g, a.C, d.cp);
  stage(vln3b, a.ln3b, a.C, d.cp);
  stage(vbi, a.bi, d.nf * kFW, d.nf * kFW);
  stage(vosc, a.osc, a.Cout, d.noc * d.w);
  stage(vobi, a.obi, a.Cout, d.noc * d.w);
  __syncthreads();

  if (warp >= cwarps) {   // producer warpgroup: one thread issues the copies
    regs_dec<kProducerRegs>();
    if (warp == cwarps && lane == 0) {
      for (int w = 0; w < nwg; ++w) {
        const int r0 = tile0 + w * kRows;
        if (r0 >= a.T) {   // no rows: complete the phases with no copy
          mbar_arrive(xbar + w);
          mbar_arrive(cbar + w);
          continue;
        }
        unsigned char* xb = wbuf + (size_t)w * (d.nbx + d.nbc) * kBox;
        if (a.in_proj) {
          mbar_expect(xbar + w, d.nkin * kBox);
          for (int kc = 0; kc < d.nkin; ++kc)
            tma_box(xb + (size_t)kc * kBox, &p.tm_x, kKC * kc, r0, xbar + w);
        }
        mbar_expect(cbar + w, d.nkc * kBox);
        for (int kc = 0; kc < d.nkc; ++kc)
          tma_box(xb + (size_t)(d.nbx + kc) * kBox, &p.tm_ctx, kKC * kc, r0, cbar + w);
      }
      const unsigned char* ws = static_cast<const unsigned char*>(a.wc);
      int i = 0;
      if (a.in_proj)
        for (int t = 0; t < NCH * d.nkin; ++t) ring_fill(ring, i++, ws, W * 256);
      for (int t = 0; t < NCH * d.nkc; ++t) ring_fill(ring, i++, ws, W * 256);
      for (int f = 0; f < d.nf; ++f) {
        for (int t = 0; t < d.nkc; ++t) ring_fill(ring, i++, ws, kFW * 256);
        for (int t = 0; t < NCH * FK; ++t) ring_fill(ring, i++, ws, W * 256);
      }
      if (a.out_proj)
        for (int t = 0; t < d.noc * d.nkc; ++t) ring_fill(ring, i++, ws, W * 256);
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
  const int rl = 16 * (warp & 3) + g;
  const int row = tile0 + wg * kRows + rl;
  unsigned char* xb = wbuf + (size_t)wg * (d.nbx + d.nbc) * kBox;   // x, then each h1 chunk
  unsigned char* cb = xb + (size_t)d.nbx * kBox;                     // ctx, then y, then o
  float x1[NV];
  int it = 0;

  // xf, then x1 = xf + ctx.Wo + bo (each chunk's product a fresh sum; x.Win
  // and ctx.Wo through one copy of the product code: 0 + acc is acc)
  if (!a.in_proj) load_rows<NV>(x1, static_cast<const float*>(a.x), a.ldx, a.C, a.T, row, q);
  for (int src = a.in_proj ? 0 : 1; src < 2; ++src) {
    mbar_wait((src ? cbar : xbar) + wg, 0);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      float acc[W / 2];
      product<W>(acc, src ? cb : xb, src ? d.nkc : d.nkin, ring, it, rl, q, lane);
#pragma unroll
      for (int i = 0; i < W / 2; ++i)
        x1[ch * (W / 2) + i] = addf(src ? x1[ch * (W / 2) + i] : 0.f, acc[i]);
    }
  }
  add_vec<NV>(x1, vbo, q);

  // y = LN2(x1) into cb over ctx's tile (the warp's rows: its products are done)
  store_tile<NV>(cb, x1, d.nkc, rl, q, a.C, a.eps, vln2g, vln2b);
  __syncwarp();

  // the FFN, kFW columns of F at a time: h1 = SiLU(y.Wi + bi) into xb, then
  // x1 += h1.Wo2 (each chunk's product a fresh sum)
  for (int f = 0; f < d.nf; ++f) {
    {
      float h[kFW / 2];
      product<kFW>(h, cb, d.nkc, ring, it, rl, q, lane);
#pragma unroll
      for (int j = 0; j < kFW / 8; ++j) {
        const int col = 8 * j + 2 * q;
        const float2 b = *reinterpret_cast<const float2*>(vbi + f * kFW + col);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(xb + (col / kKC) * kBox + swz4(rl + 8 * hf, col % kKC)) =
              make_float2(silu_rn(addf(h[4 * j + 2 * hf], b.x)),
                          silu_rn(addf(h[4 * j + 2 * hf + 1], b.y)));
      }
    }
    __syncwarp();
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      float acc[W / 2];
      product<W>(acc, xb, FK, ring, it, rl, q, lane);
#pragma unroll
      for (int i = 0; i < W / 2; ++i) x1[ch * (W / 2) + i] = addf(x1[ch * (W / 2) + i], acc[i]);
    }
  }

  // o = x1 + bo2, the block's final LN
  add_vec<NV>(x1, vbo2, q);
  if (a.final_ln) ln_rows<NV>(x1, a.C, q, a.final_eps, vln3g, vln3b);
  float* out = static_cast<float*>(const_cast<void*>(a.out));
  if (!a.out_proj) {
#pragma unroll
    for (int G = 0; G < NV / 4; ++G) {
      const int col = 8 * G + 2 * q;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = row + 8 * hf;
        if (r < a.T && col < a.C)
          *reinterpret_cast<float2*>(out + (size_t)r * a.ldo + col) =
              make_float2(x1[4 * G + 2 * hf], x1[4 * G + 2 * hf + 1]);
      }
    }
    return;
  }

  // the out-projection: o.Wout * bn_scale + bn_bias (, SiLU), o into cb
  // over y's tile (the warp's last products have read it)
  store_tile<NV>(cb, x1, d.nkc, rl, q);
  __syncwarp();
  const bool pairs = !(a.ldo & 1);
  for (int oc = 0; oc < d.noc; ++oc) {
    float acc[W / 2];
    product<W>(acc, cb, d.nkc, ring, it, rl, q, lane);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int n = oc * W + 8 * j + 2 * q;
      if (n >= a.Cout) continue;
      const bool two = n + 1 < a.Cout;
      const float2 sc = *reinterpret_cast<const float2*>(vosc + n);
      const float2 bb = *reinterpret_cast<const float2*>(vobi + n);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = row + 8 * hf;
        if (r >= a.T) continue;
        float v0 = addf(mulf(acc[4 * j + 2 * hf], sc.x), bb.x);
        float v1 = addf(mulf(acc[4 * j + 2 * hf + 1], sc.y), bb.y);
        if (a.out_act) {
          v0 = silu_rn(v0);
          v1 = silu_rn(v1);
        }
        float* dst = out + (size_t)r * a.ldo + n;
        if (two && pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (two) dst[1] = v1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B: attention of one head of a window of whole sequences
// ---------------------------------------------------------------------------

struct AttnF32Params {
  CUtensorMap tm_qkv;   // qkv (T, 3 H dhp) in 8-column boxes of 64 rows, 32-byte swizzle
  LayerF32Args a;
  AttnPlan pl;
};

// a named barrier of the warpgroup's 128 threads (0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// exp(s - m) as 2^(s log2(e) - ml2), ml2 = m log2(e): one fma, then the
// MUFU's exp2 (denormals flushed). An error in ml2 scales a whole row's p
// alike and cancels in p / sum(p)
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp_shift(float s, float ml2) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(__fmaf_rn(s, kLog2e, -ml2)));
  return y;
}

// the copies of a q tile: ks 8-column boxes of 64 rows from head column c0,
// completing on `bar`
__device__ __forceinline__ void load_q(unsigned char* dst, const CUtensorMap* tm, int c0, int r0,
                                       int ks, uint64_t* bar) {
  mbar_expect(bar, ks * kQTile);
  for (int s = 0; s < ks; ++s) tma_box(dst + s * kQTile, tm, c0 + 8 * s, r0, bar);
}

// the copies of window `w`'s k and v (into kraw and the staging) and of each
// warpgroup's first q tile, by one thread
template <int NK, int KS, int DN>
__device__ __forceinline__ void load_window(const AttnF32Params& p, int w, unsigned char* kraw,
                                            unsigned char* stage, unsigned char* qbuf,
                                            uint64_t* bar) {
  const int hq = p.a.H * p.a.dhp, qc = (w % p.a.H) * p.a.dhp, row0 = w / p.a.H * p.pl.rows;
  mbar_expect(bar, (KS + DN / 8) * NK * 32);
  for (int r = 0; r < NK; r += 64) {
    for (int s = 0; s < KS; ++s)
      tma_box(kraw + s * NK * 32 + r * 32, &p.tm_qkv, hq + qc + 8 * s, row0 + r, bar);
    for (int s = 0; s < DN / 8; ++s)
      tma_box(stage + s * NK * 32 + r * 32, &p.tm_qkv, 2 * hq + qc + 8 * s, row0 + r, bar);
  }
  for (int g = 0; g < p.pl.nwg; ++g)
    load_q(qbuf + (size_t)g * KS * kQTile, &p.tm_qkv, qc, row0 + 64 * g, KS, bar + 1 + g);
}

// v^T from v's staging (klo): key j of k-step j / 8 at k-column (j % 8) / 2
// + 4 (j % 2), as raw values (vt) and tf32 lo remainders (vtlo). Lane (r,
// dq) takes key r of each 8-key step and row 4 db + dq: a warp's load reads
// 8 rows of 16 bytes, its store one 128-byte span, at offsets 256 and DN *
// 32 bytes a step apart
template <int NK, int DN>
__device__ __forceinline__ void transpose_v(const unsigned char* klo, unsigned char* vt,
                                            unsigned char* vtlo, int warp, int lane, int nwg) {
  constexpr int NS = NK / 8;
  const int r = lane & 7, pos = (r >> 1) + 4 * (r & 1);
  for (int i = warp; i < DN / 2; i += 4 * nwg) {
    const int d = 4 * (i >> 1) + (lane >> 3), kg0 = (i & 1) * (NS / 2);
    const unsigned char* src = klo + (d >> 3) * NK * 32 + swz32(r, d & 7) + kg0 * 256;
    const int o = swz32(d, pos) + kg0 * DN * 32;
#pragma unroll
    for (int kg = 0; kg < NS / 2; ++kg) {
      const float v = *reinterpret_cast<const float*>(src + kg * 256);
      *reinterpret_cast<float*>(vt + o + kg * DN * 32) = v;
      *reinterpret_cast<float*>(vtlo + o + kg * DN * 32) =
          __fsub_rn(v, __uint_as_float(__float_as_uint(v) & 0xffffe000u));
    }
  }
}

// k's lo remainders over the staging (k itself is its hi plane)
template <int NK, int KS>
__device__ __forceinline__ void split_k(const unsigned char* kraw, unsigned char* klo, int tid,
                                        int nthreads) {
  for (int i = tid; i < KS * NK * 2; i += nthreads) {
    const float4 x = reinterpret_cast<const float4*>(kraw)[i];
    float4 y;
    y.x = __fsub_rn(x.x, __uint_as_float(__float_as_uint(x.x) & 0xffffe000u));
    y.y = __fsub_rn(x.y, __uint_as_float(__float_as_uint(x.y) & 0xffffe000u));
    y.z = __fsub_rn(x.z, __uint_as_float(__float_as_uint(x.z) & 0xffffe000u));
    y.w = __fsub_rn(x.w, __uint_as_float(__float_as_uint(x.w) & 0xffffe000u));
    reinterpret_cast<float4*>(klo)[i] = y;
  }
}

// p = exp(s - max) (ml2 = max log2(e); m, the max, for the bench's expf
// variant), its sums added into den, and acc (+)= P.v a k-step of 8 keys at
// a time: the score fragment (row g: keys 2q, 2q + 1; row g + 8 likewise)
// is the A fragment with key 2q at k-column q and 2q + 1 at q + 4, as v^T is
// laid. `keep` 0: the first step overwrites acc. The exponentials of a
// k-step run beside the products of the steps before it.
template <int NK, int DN>
__device__ __forceinline__ void softmax_pv(float (&s)[NK / 2], const float (&m)[2],
                                           const float (&ml2)[2], float (&den)[2],
                                           float (&acc)[DN / 2], const unsigned char* vt,
                                           const unsigned char* vtlo, int keep) {
  uint32_t ph[2][4], pl4[2][4];
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    const int f = j & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) s[4 * j + i] = exp_shift(s[4 * j + i], ml2[i >> 1]);
    den[0] = addf(den[0], addf(s[4 * j], s[4 * j + 1]));
    den[1] = addf(den[1], addf(s[4 * j + 2], s[4 * j + 3]));
    if (j >= 2) wg_wait<1>();
    split_tf32_rz(s[4 * j], ph[f][0], pl4[f][0]);
    split_tf32_rz(s[4 * j + 2], ph[f][1], pl4[f][1]);
    split_tf32_rz(s[4 * j + 1], ph[f][2], pl4[f][2]);
    split_tf32_rz(s[4 * j + 3], ph[f][3], pl4[f][3]);
    wg_fence();
    const uint32_t vh = smem_u32(vt + j * DN * 32), vl = smem_u32(vtlo + j * DN * 32);
    wgmma_tf32_rs<DN>(acc, pl4[f], desc_k32(vh), j == 0 ? keep : 1);
    wgmma_tf32_rs<DN>(acc, ph[f], desc_k32(vl), 1);
    wgmma_tf32_rs<DN>(acc, ph[f], desc_k32(vh), 1);
    wg_commit();
  }
  wg_wait<0>();
  wg_pin(acc);
}

// NK keys (the block's rows rounded up), KS k-steps of q.k^T (ceil(dh / 8));
// P.v is dhp = 16 ceil(KS / 2) columns wide. A persistent block walks the
// windows blockIdx.x, + gridDim.x, ...: the next window's copies go out once
// both warpgroups' last q.k^T of this one is done, beside its last P.v.
template <int NK, int KS>
__global__ void __launch_bounds__(256, NK <= 64 ? 2 : 1)
    layer_attention_f32_kernel(const __grid_constant__ AttnF32Params p) {
  constexpr int DN = 16 * ((KS + 1) / 2), NS = NK / 8;
  const LayerF32Args& a = p.a;
  const AttnPlan& pl = p.pl;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int nwg = pl.nwg, nthreads = 128 * nwg;
  unsigned char* kraw = base;                                    // KS k-steps of NK rows
  unsigned char* klo = kraw + (size_t)KS * NK * 32;              // v's staging, then k's lo
  unsigned char* vt = klo + (size_t)NK * DN * 4;                 // NS k-steps of DN rows
  unsigned char* vtlo = vt + (size_t)NK * DN * 4;
  unsigned char* qbuf = vtlo + (size_t)NK * DN * 4;              // a warpgroup's q tile
  uint64_t* bar = reinterpret_cast<uint64_t*>(qbuf + (size_t)nwg * KS * kQTile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int g = lane >> 2, q = lane & 3;
  const int rl = 16 * (warp & 3) + g;   // the lane's rows rl, rl + 8 of a tile
  unsigned char* qt = qbuf + (size_t)wg * KS * kQTile;
  float* ctx = static_cast<float*>(const_cast<void*>(a.ctx));
  const bool pairs = !(a.dh & 1) && !(a.ldc & 1);
  const int L = a.L;
  if (tid == 0) {
    mbar_init(bar, 1);
    for (int w = 0; w < nwg; ++w) mbar_init(bar + 1 + w, 1);
    mbar_init_fence();
    load_window<NK, KS, DN>(p, blockIdx.x, kraw, klo, qbuf, bar);
  }
  __syncthreads();
  int n = 0;   // the warpgroup's tiles so far
  for (int w = blockIdx.x, it = 0; w < pl.windows; w += gridDim.x, ++it) {
    const int h = w % a.H, row0 = w / a.H * pl.rows, R = min(pl.rows, a.T - row0);
    mbar_wait(bar, it & 1);

    transpose_v<NK, DN>(klo, vt, vtlo, warp, lane, nwg);
    __syncthreads();
    split_k<NK, KS>(kraw, klo, tid, nthreads);
    fence_async_smem();
    __syncthreads();

    for (int t = wg; t < pl.nt; t += nwg, ++n) {
      // S = q.k^T as 3xTF32, q's fragment split once a k-step into one of
      // two register sets (a set is written again once the products of two
      // steps back are done); q zero past dh. The second warpgroup's first
      // q.k^T waits for the first's, so that one's products run beside the
      // other's softmax
      if (t == 1 && nwg == 2) asm volatile("bar.sync 4, %0;\n" ::"r"(nthreads) : "memory");
      mbar_wait(bar + 1 + wg, n & 1);
      float s[NK / 2];
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int f = ks & 1;
        if (ks >= 2) wg_wait<1>();
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = rl + 8 * (e & 1), k = q + 4 * (e >> 1);
          const float x = *reinterpret_cast<const float*>(qt + ks * kQTile + swz32(row, k));
          split_tf32_rz(8 * ks + k < a.dh ? x : 0.f, ah[f][e], al[f][e]);
        }
        wg_fence();
        const uint32_t kh = smem_u32(kraw + ks * NK * 32), kl = smem_u32(klo + ks * NK * 32);
        wgmma_tf32_rs<NK>(s, al[f], desc_k32(kh), ks == 0 ? 0 : 1);
        wgmma_tf32_rs<NK>(s, ah[f], desc_k32(kl), 1);
        wgmma_tf32_rs<NK>(s, ah[f], desc_k32(kh), 1);
        wg_commit();
      }
      wg_wait<0>();
      wg_pin(s);
      if (t == 0 && nwg == 2) asm volatile("bar.arrive 4, %0;\n" ::"r"(nthreads) : "memory");
      // the warpgroup's q tile is read: the copy of its next one goes out;
      // after both warpgroups' last tile, k's and the q tiles' buffers are
      // free: the warpgroup of the window's last tile waits for the other's
      // and sends the next window's copies
      if (t + nwg < pl.nt) {
        wg_sync(wg);
        if ((tid & 127) == 0) load_q(qt, &p.tm_qkv, h * a.dhp, row0 + 64 * (t + nwg), KS,
                                     bar + 1 + wg);
      } else if (t == pl.nt - 1) {
        asm volatile("bar.sync 3, %0;\n" ::"r"(nthreads) : "memory");
        if ((tid & 127) == 0 && w + gridDim.x < pl.windows)
          load_window<NK, KS, DN>(p, w + gridDim.x, kraw, klo, qbuf, bar);
      } else {
        asm volatile("bar.arrive 3, %0;\n" ::"r"(nthreads) : "memory");
      }

      // keys outside the row's sequence at -inf (where the row's keys are
      // not all NK: the selects cost 11% of L = 256's time); the true row max
      float m[2], den[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 64 * t + rl + 8 * hf, lo = r / L * L, hi = min(lo + L, R);
        if (lo > 0 || hi < NK) {
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = 8 * j + 2 * q + e, i = 4 * j + 2 * hf + e;
              s[i] = key >= lo && key < hi ? s[i] : -INFINITY;
            }
        }
        m[hf] = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          m[hf] = fmaxf(m[hf], fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
        m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
        m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
        if (m[hf] == -INFINITY) m[hf] = 0.f;   // a row past the block's sequences
      }

      // p = exp(s - max), its sums, and P.v
      float acc[DN / 2];
      const float ml2[2] = {mulf(m[0], kLog2e), mulf(m[1], kLog2e)};
      softmax_pv<NK, DN>(s, m, ml2, den, acc, vt, vtlo, 0);

      // ctx = (p.v) * (1 / sum), the head's dh columns of the block's rows
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        den[hf] = addf(den[hf], __shfl_xor_sync(0xffffffffu, den[hf], 1));
        den[hf] = addf(den[hf], __shfl_xor_sync(0xffffffffu, den[hf], 2));
        const float inv = __fdiv_rn(1.f, den[hf]);
        const int r = 64 * t + rl + 8 * hf;
        if (r >= R) continue;
        float* dst = ctx + (size_t)(row0 + r) * a.ldc + h * a.dh;
#pragma unroll
        for (int j = 0; j < DN / 8; ++j) {
          const int d = 8 * j + 2 * q;
          if (d >= a.dh) continue;
          const float v0 = mulf(acc[4 * j + 2 * hf], inv);
          const float v1 = mulf(acc[4 * j + 2 * hf + 1], inv);
          if (d + 1 < a.dh && pairs) {
            *reinterpret_cast<float2*>(dst + d) = make_float2(v0, v1);
          } else {
            dst[d] = v0;
            if (d + 1 < a.dh) dst[d + 1] = v1;
          }
        }
      }
    }
    __syncthreads();   // v^T is read: the next window's pass may write it
  }
}

// The streamed form (L past kMaxKeys): a block takes nwg query tiles (one a
// warpgroup, loaded once) of one head of one sequence and walks the
// sequence's keys in windows of NK. Each window goes through the resident
// form's steps (k and v by TMA, v^T's and k's lo planes, S on tf32 wgmma
// with the scores of the window's keys in registers, P.v) against a running
// row max: where a window raises it, the sums so far are scaled by 2^(old
// max log2(e) - new max log2(e)) first (online softmax, as the f32 flash
// kernel does). The true-max walk of the bf16 forms would compute S twice;
// at f32 nothing is rounded between the max and p, so the rescale changes
// only the last f32 bits and keeps one pass. Once both warpgroups' S of a
// window is done, one thread sends the next window's k and v (their
// buffers are free), which land beside the softmax and P.v; the v^T pass
// of the next window waits for every P.v. Query tiles past the sequence's
// last repeat it and are not stored.
template <int NK, int KS>
__global__ void __launch_bounds__(256, 1)
    layer_attention_f32_stream_kernel(const __grid_constant__ AttnF32Params p) {
  constexpr int DN = 16 * ((KS + 1) / 2), NS = NK / 8;
  const LayerF32Args& a = p.a;
  const AttnPlan& pl = p.pl;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int nwg = pl.nwg;
  unsigned char* kraw = base;                                    // KS k-steps of NK rows
  unsigned char* klo = kraw + (size_t)KS * NK * 32;              // v's staging, then k's lo
  unsigned char* vt = klo + (size_t)NK * DN * 4;                 // NS k-steps of DN rows
  unsigned char* vtlo = vt + (size_t)NK * DN * 4;
  unsigned char* qbuf = vtlo + (size_t)NK * DN * 4;              // a warpgroup's q tile
  uint64_t* bar = reinterpret_cast<uint64_t*>(qbuf + (size_t)nwg * KS * kQTile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int g = lane >> 2, q = lane & 3;
  const int rl = 16 * (warp & 3) + g;   // the lane's rows rl, rl + 8 of a tile
  unsigned char* qt = qbuf + (size_t)wg * KS * kQTile;
  float* ctx = static_cast<float*>(const_cast<void*>(a.ctx));
  const bool pairs = !(a.dh & 1) && !(a.ldc & 1);
  const int L = a.L, nqg = cdiv(pl.nt, nwg), h = blockIdx.x % a.H;
  const int qg = blockIdx.x / a.H % nqg, row0 = blockIdx.x / a.H / nqg * L;
  const int hq = a.H * a.dhp, qc = h * a.dhp, nwin = cdiv(L, NK);
  // window w's k and v (keys row0 + w NK ...) into kraw and the staging
  auto send = [&](int w) {
    mbar_expect(bar, (KS + DN / 8) * NK * 32);
    for (int r = 0; r < NK; r += 64) {
      for (int s = 0; s < KS; ++s)
        tma_box(kraw + s * NK * 32 + r * 32, &p.tm_qkv, hq + qc + 8 * s, row0 + w * NK + r, bar);
      for (int s = 0; s < DN / 8; ++s)
        tma_box(klo + s * NK * 32 + r * 32, &p.tm_qkv, 2 * hq + qc + 8 * s, row0 + w * NK + r,
                bar);
    }
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    for (int w = 0; w < nwg; ++w) mbar_init(bar + 1 + w, 1);
    mbar_init_fence();
    send(0);
    for (int w = 0; w < nwg; ++w)
      load_q(qbuf + (size_t)w * KS * kQTile, &p.tm_qkv, qc,
             row0 + 64 * min(qg * nwg + w, pl.nt - 1), KS, bar + 1 + w);
  }
  __syncthreads();
  mbar_wait(bar + 1 + wg, 0);
  const int t = qg * nwg + wg;   // the warpgroup's query tile
  float acc[DN / 2], m[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
  for (int w = 0; w < nwin; ++w) {
    __syncthreads();   // every P.v of the last window is done: v^T may be written
    mbar_wait(bar, w & 1);
    transpose_v<NK, DN>(klo, vt, vtlo, warp, lane, nwg);
    __syncthreads();
    split_k<NK, KS>(kraw, klo, tid, 128 * nwg);
    fence_async_smem();
    __syncthreads();

    // S = q.k^T of the window's keys as 3xTF32 (q split a k-step at a time)
    float s[NK / 2];
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int f = ks & 1;
      if (ks >= 2) wg_wait<1>();
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rl + 8 * (e & 1), k = q + 4 * (e >> 1);
        const float x = *reinterpret_cast<const float*>(qt + ks * kQTile + swz32(row, k));
        split_tf32_rz(8 * ks + k < a.dh ? x : 0.f, ah[f][e], al[f][e]);
      }
      wg_fence();
      const uint32_t kh = smem_u32(kraw + ks * NK * 32), kl = smem_u32(klo + ks * NK * 32);
      wgmma_tf32_rs<NK>(s, al[f], desc_k32(kh), ks == 0 ? 0 : 1);
      wgmma_tf32_rs<NK>(s, ah[f], desc_k32(kl), 1);
      wgmma_tf32_rs<NK>(s, ah[f], desc_k32(kh), 1);
      wg_commit();
    }
    wg_wait<0>();
    wg_pin(s);
    // k and the staging are read by both warpgroups: the next window's
    // copies go out
    __syncthreads();
    if (tid == 0 && w + 1 < nwin) send(w + 1);

    // keys past L at -inf; the running max; the sums so far rescaled
    const int hi = L - w * NK;
    float ml2[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (hi < NK) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = 8 * j + 2 * q + e, i = 4 * j + 2 * hf + e;
            s[i] = key < hi ? s[i] : -INFINITY;
          }
      }
      float mw = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) mw = fmaxf(mw, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
      mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, 1));
      mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, 2));
      const float mn = fmaxf(m[hf], mw);   // finite: the window has a key below L
      ml2[hf] = mulf(mn, kLog2e);
      float r;
      asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(__fsub_rn(mulf(m[hf], kLog2e), ml2[hf])));
      m[hf] = mn;
      den[hf] = mulf(den[hf], r);
#pragma unroll
      for (int j = 0; j < DN / 8; ++j) {
        acc[4 * j + 2 * hf] = mulf(acc[4 * j + 2 * hf], r);
        acc[4 * j + 2 * hf + 1] = mulf(acc[4 * j + 2 * hf + 1], r);
      }
    }

    // p = exp(s - max), its sums, and the window's P.v, a fresh sum on the
    // tensor cores added to the rescaled total in f32 (chained over every
    // window, the tensor cores' sums drift: 1.9e-5 of the largest value at
    // L = 4096 on an H100)
    float part[DN / 2];
    softmax_pv<NK, DN>(s, m, ml2, den, part, vt, vtlo, 0);
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) acc[i] = addf(acc[i], part[i]);
  }

  // ctx = (p.v) * (1 / sum), the head's dh columns of the tile's rows
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    den[hf] = addf(den[hf], __shfl_xor_sync(0xffffffffu, den[hf], 1));
    den[hf] = addf(den[hf], __shfl_xor_sync(0xffffffffu, den[hf], 2));
    const float inv = __fdiv_rn(1.f, den[hf]);
    const int r = 64 * t + rl + 8 * hf;
    if (r >= L) continue;
    float* dst = ctx + (size_t)(row0 + r) * a.ldc + h * a.dh;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      const int d = 8 * j + 2 * q;
      if (d >= a.dh) continue;
      const float v0 = mulf(acc[4 * j + 2 * hf], inv);
      const float v1 = mulf(acc[4 * j + 2 * hf + 1], inv);
      if (d + 1 < a.dh && pairs) {
        *reinterpret_cast<float2*>(dst + d) = make_float2(v0, v1);
      } else {
        dst[d] = v0;
        if (d + 1 < a.dh) dst[d + 1] = v1;
      }
    }
  }
}

// a (rows, cols) f32 array with row stride `ld` as a tensor map read in
// boxes of `bc` columns by 64 rows with swizzle `sw` (default: 32 x 64, the
// 128-byte swizzle); reads past the array give zeros
int make_map(CUtensorMap* m, const void* ptr, int cols, int rows, int ld, int bc = kKC,
             CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)bc, kRows};
  const cuuint32_t es[2] = {1, 1};
  const CUresult res = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
                          strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a row-tile kernel of nwg consumer warpgroups and a producer one
int launch_rows(void (*kernel)(RowF32Params), const RowF32Params& p, int nwg, size_t smem,
                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<RowF32Params*>(&p)};
  err = cudaLaunchKernel((void*)kernel, dim3(cdiv(p.a.T, nwg * kRows)), dim3(128 * (nwg + 1)),
                         args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// a persistent grid: as many blocks as are resident at once, at most one a
// window
template <int NK, int KS>
int launch_attn_nk(const AttnF32Params& p, void* stream) {
  void (*kernel)(AttnF32Params) = layer_attention_f32_kernel<NK, KS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.pl.smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128 * p.pl.nwg,
                                                        p.pl.smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = p.pl.windows < per_sm * sms ? p.pl.windows : per_sm * sms;
  void* args[] = {const_cast<AttnF32Params*>(&p)};
  err = cudaLaunchKernel((void*)kernel, dim3(grid), dim3(128 * p.pl.nwg), args, p.pl.smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the streamed form: a block a group of query tiles
template <int NK, int KS>
int launch_attn_stream(const AttnF32Params& p, void* stream) {
  void (*kernel)(AttnF32Params) = layer_attention_f32_stream_kernel<NK, KS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.pl.smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<AttnF32Params*>(&p)};
  err = cudaLaunchKernel((void*)kernel, dim3(p.pl.windows), dim3(128 * p.pl.nwg), args,
                         p.pl.smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int KS>
int launch_attn(const AttnF32Params& p, void* stream) {
  if (p.pl.stream) {
    if constexpr (KS <= 6) {
      if (p.pl.nk == 256) return launch_attn_stream<256, KS>(p, stream);
    } else {
      if (p.pl.nk == 128) return launch_attn_stream<128, KS>(p, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (p.pl.nk) {
    case 64: return launch_attn_nk<64, KS>(p, stream);
    case 128: return launch_attn_nk<128, KS>(p, stream);
    case 256:
      // 256 keys fit the shared memory up to dhp = 48
      if constexpr (KS <= 6) return launch_attn_nk<256, KS>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_ln_qkv(int nc, const RowF32Params& p, int nwg, size_t smem, void* stream) {
  switch (nc) {
    case 1: return launch_rows(layer_ln_qkv_f32_kernel<1>, p, nwg, smem, stream);
    case 2: return launch_rows(layer_ln_qkv_f32_kernel<2>, p, nwg, smem, stream);
    case 3: return launch_rows(layer_ln_qkv_f32_kernel<3>, p, nwg, smem, stream);
    case 4: return launch_rows(layer_ln_qkv_f32_kernel<4>, p, nwg, smem, stream);
    case 5: return launch_rows(layer_ln_qkv_f32_kernel<5>, p, nwg, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_proj_ffn(int nc, const RowF32Params& p, int nwg, size_t smem, void* stream) {
  switch (nc) {
    case 1: return launch_rows(layer_proj_ffn_f32_kernel<1>, p, nwg, smem, stream);
    case 2: return launch_rows(layer_proj_ffn_f32_kernel<2>, p, nwg, smem, stream);
    case 3: return launch_rows(layer_proj_ffn_f32_kernel<3>, p, nwg, smem, stream);
    case 4: return launch_rows(layer_proj_ffn_f32_kernel<4>, p, nwg, smem, stream);
    case 5: return launch_rows(layer_proj_ffn_f32_kernel<5>, p, nwg, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Bytes of dynamic shared memory a launch of kernel `kind` (0 ln_qkv, 1
// attention, 2 proj_ffn) at these widths and this plan (nwg_a / nwg_c
// consumer warpgroups, stages_a / stages_c ring buffers) needs, and (kind
// 3, 4) the bytes of ln_qkv's and proj_ffn's weight streams; -1 where the
// kernels do not take the layer (a head past 64, C not H heads of dh, dhp
// not dh rounded up to 16, T not a multiple of L; the row tiles: C past
// 240, widths or row strides that are not whole TMA boxes). The wrapper
// holds its own reckoning (layer_f32_smem, the streams it built) against it.
extern "C" long long gxt_layer_f32_smem(const LayerF32Args* a, int kind) {
  if (!takes(*a) || (kind != 1 && !rows_take(*a))) return -1;
  const Dims d = dims(*a);
  switch (kind) {
    case 0: return (long long)smem_ln_qkv(*a);
    case 1: {
      AttnPlan p;
      return attn_plan(*a, p) ? (long long)p.smem : -1;
    }
    case 2: return (long long)smem_proj_ffn(*a);
    case 3: return (long long)d.ta * d.sba;
    case 4: return (long long)d.tc * d.sbc;
  }
  return -1;
}

// x (T, Cin) f32 with row stride ldx -> qkv (T, 3 H dhp) f32. wa is the
// wrapper's weight stream (Win^T, then the 3C real columns of [Wq | Wk |
// Wv]^T, as tf32 hi / lo tiles); vectors f32 (bqkv: the 3C real biases).
extern "C" int gxt_layer_ln_qkv_f32(const LayerF32Args* a, void* stream) {
  if (a->T <= 0) return 0;
  if (!takes(*a) || !rows_take(*a) || !plan_ok(a->nwg_a, a->stages_a, smem_ln_qkv(*a)))
    return (int)cudaErrorInvalidValue;
  RowF32Params p;
  memset(&p, 0, sizeof(p));
  p.a = *a;
  int code;
  if (a->in_proj && (code = make_map(&p.tm_x, a->x, a->Cin, a->T, a->ldx))) return code;
  return launch_ln_qkv(units(a->C), p, a->nwg_a, smem_ln_qkv(*a), stream);
}

// qkv (T, 3 H dhp) f32 -> ctx (T, C) f32 with row stride ldc, on the
// plan's nwg_b consumer warpgroups.
extern "C" int gxt_layer_attention_f32(const LayerF32Args* a, void* stream) {
  if (a->T <= 0) return 0;
  AttnF32Params p;
  memset(&p, 0, sizeof(p));
  if (!takes(*a) || !attn_plan(*a, p.pl)) return (int)cudaErrorInvalidValue;
  p.a = *a;
  const int nq = 3 * a->H * a->dhp;
  int code;
  if ((code = make_map(&p.tm_qkv, a->qkv, nq, a->T, nq, 8, CU_TENSOR_MAP_SWIZZLE_32B)))
    return code;
  switch (p.pl.ks) {
    case 1: return launch_attn<1>(p, stream);
    case 2: return launch_attn<2>(p, stream);
    case 3: return launch_attn<3>(p, stream);
    case 4: return launch_attn<4>(p, stream);
    case 5: return launch_attn<5>(p, stream);
    case 6: return launch_attn<6>(p, stream);
    case 7: return launch_attn<7>(p, stream);
    case 8: return launch_attn<8>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// x (T, Cin) and ctx (T, C) f32 -> out (T, Cout) f32 with row stride ldo.
// wc is the wrapper's weight stream (Win^T, Wo^T, per FFN chunk Wi^T and
// Wo2^T, Wout^T).
extern "C" int gxt_layer_proj_ffn_f32(const LayerF32Args* a, void* stream) {
  if (a->T <= 0) return 0;
  if (!takes(*a) || !rows_take(*a) || !plan_ok(a->nwg_c, a->stages_c, smem_proj_ffn(*a)))
    return (int)cudaErrorInvalidValue;
  RowF32Params p;
  memset(&p, 0, sizeof(p));
  p.a = *a;
  int code;
  if (a->in_proj && (code = make_map(&p.tm_x, a->x, a->Cin, a->T, a->ldx))) return code;
  if ((code = make_map(&p.tm_ctx, a->ctx, a->C, a->T, a->ldc))) return code;
  return launch_proj_ffn(units(a->C), p, a->nwg_c, smem_proj_ffn(*a), stream);
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
