// MobileNetV2 inverted residual, stride 1, on Hopper: expand 1x1 (folded
// BN, SiLU) -> depthwise 3x3 over a zero ring (folded BN, SiLU) -> reduce
// 1x1 (+ folded bias, + residual), the expanded tensor kept in shared memory.
//
//   gxt_inverted_residual  replaces ggml_experiments_tpu/ops/
//                          fused_inverted_residual.py `fused_inverted_residual`
//                          (pallas_call :146; body `_ir_kernel` :44)
//
// What it computes, rounding where the TPU body does: ex = x.Wexp summed in
// f32 (bf16 operands), SiLU(ex + bexp) -> bf16; the 3x3 depthwise in f32
// over the bf16 expanded values with f32 taps, summed as the TPU body sums
// (for each column tap dj, the three row taps di in order, then the three
// column sums in order), SiLU(acc + bdw) -> bf16; out = y.Wred + bred (f32),
// + x in f32 with the residual, -> bf16. The zero ring holds zeros AFTER the
// expand's SiLU: pixels outside the image are written as 0, not expanded
// from the zeros that TMA reads there. The SiLUs use the hardware exp2 and
// reciprocal and the taps after a column's first are multiply-adds: a few
// f32 ulps from the plain version before each bf16 rounding (PERF.md holds
// both forms against chip_smoke.py's limits).
//
// Bound on an H100 at the main path's shape (B = 128, 64 x 64, C = 64,
// E = 256, Cout = 64): 134 MB moved (0.040 ms at 3.35 TB/s), 36.8 GFLOP of
// 1x1 products (0.037 ms on the tensor cores), 18 depthwise operations an
// expanded element (2.4 GFLOP, 0.036 ms on the CUDA cores) and 268 M SiLUs,
// each an exponential on the 16 MUFU lanes of a multiprocessor (0.064 ms at
// 1.98 GHz): the MUFU bounds it. Each SiLU also takes a MUFU reciprocal,
// and what holds the kernel back is instruction issue: the depthwise's
// taps, the two SiLUs and the addresses around them (PERF.md).
//
// Design (ir_plan in ops/fused_inverted_residual.py picks S and K; R = 2):
//   * A block owns a column strip of one image, S output columns (S + 2
//     expanded), and walks down it in bands of R output rows; a persistent
//     grid walks the strips. A ring of R + 2 expanded rows stays in shared
//     memory, so a band expands only its R new rows: (S + 2) / S of the
//     pixels, where an 8 x 8 tile expands 100 for 64.
//   * Wred arrives once per block by bulk copy, pre-swizzled by the wrapper
//     (128-byte rows of 64 channels) in the layout wgmma reads; Wexp does
//     too, and each warp keeps its fragments in registers (C <= 64: four
//     k-steps), so the ring reuses Wexp's buffer. x arrives by TMA (a 4-D
//     tensor map over (C, W, H, B), boxes of 64 channels x (S + 2) x
//     (R + 1), 128-byte swizzle) through a ring of K stages, K - 1 steps
//     ahead; TMA fills coordinates outside the image with zeros, the x
//     halo. A step's box starts one row above its R new rows, so it also
//     holds the residual of the band the step finishes.
//   * A warp owns 16 expanded channels (E <= 256: 4-16 warps). At step r it
//     expands them for band r's R (S + 2) pixels on mma.sync m16n8k16 (A by
//     ldmatrix from the x box) into the ring, then runs the depthwise of
//     band r - 1: a lane owns a channel pair and S / 4 output columns and
//     walks along them with the 3 x (R + 2) window in registers (each
//     expanded value loaded once a column, not nine times), writing
//     SiLU(acc + bdw) into the y tile. A channel's expand and depthwise stay
//     in one warp.
//   * One warpgroup reduces the band on wgmma (m64n64k16; y and Wred K-major
//     in shared memory, 128-byte swizzle, one chain over K), adds bred and
//     the residual from the x box, and writes bf16 into a staging tile that
//     TMA stores at the next step (coordinates outside the image are not
//     written: ragged strips and bands). y's rows hold the band's pixels in
//     an order that keeps the depthwise's stores free of bank conflicts; the
//     reduce maps them back.
//   * Two block barriers a step: after the expand (y and the staging tile
//     are free) and after the depthwise (y is complete). The other warps
//     run the next step's expand while the reducing warpgroup works. No
//     atomics and no order that depends on the plan: two launches give the
//     same bits, and so do two plans.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#include "hopper_common.cuh"
#include "mma_common.cuh"

namespace {

using namespace gxt;

constexpr int R = 2;            // output rows a band
constexpr int kMaxWarps = 16;   // 16 expanded channels a warp: E <= 256
constexpr int kTile = 8192;     // 64 rows of 128 bytes: a wgmma operand's K chunk
constexpr int kReduceN = 64;    // columns of a reduce item (16, 32 or 64)

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int pad_to(int a, int m) { return cdiv(a, m) * m; }

// The launch's geometry, from the plan (S, K) and the widths. Offsets
// are bytes into shared memory aligned to 1024; ops/fused_inverted_residual.py
// ir_smem_bytes repeats the reckoning.
struct Geom {
  int K, E, Cout;
  int Ep, Cn;         // E and Cout padded to 64
  int neb, nnc;       // 64-channel boxes of Ep and Cn
  int warps;          // Ep / 16
  int P, slot;        // ring: pixel stride, elements a slot
  int xrows;          // rows of one x box buffer
  int ring, wred, y, x, out, bred, bar, bytes;   // Wexp's buffer is the ring's start
};

// What the plan's S fixes: S + 2 expanded columns, the expand's R (S + 2)
// rows padded to 16 (mma.sync row tiles), the reduce's R S rows in 64-row
// tiles, S / 4 = 2^lg output columns a depthwise lane, and p / (S + 2) as
// (p * msp) >> 16 (exact for p < 2^16 / (S + 2)).
template <int S>
struct Cut {
  static constexpr int sp = S + 2, mp = pad_to(R * sp, 16), rs = R * S, nmt = cdiv(rs, 64);
  static constexpr int cpg = S / 4, lg = S == 16 ? 2 : 3, msp = (65536 + sp - 1) / sp;
};

bool geom(Geom& g, int S, int K, int C, int E, int Cout) {
  if (!(S == 16 || S == 32) || K < 2 || K > 4) return false;
  if (C <= 0 || C > 64 || E <= 0 || Cout <= 0 || C % 8 || Cout % 8 || E % 2 ||
      E > 16 * kMaxWarps)
    return false;
  const int sp = S + 2, rs = R * S, lg = S == 16 ? 2 : 3;
  g.K = K; g.E = E; g.Cout = Cout;
  g.Ep = pad_to(E, 64);
  g.Cn = pad_to(Cout, 64);
  g.neb = g.Ep / 64;
  g.nnc = g.Cn / 64;
  g.warps = g.Ep / 16;
  g.P = g.Ep + 8;
  // 16 elements (8 banks) after each group of S / 4 pixels
  g.slot = pad_to(sp * g.P + (((sp - 1) >> lg) + 1) * 16, 8);
  g.xrows = pad_to((R + 1) * sp, 8);
  const int ring_bytes = (R + 2) * g.slot * 2, wexp_bytes = g.Ep * 128;
  int o = 0;
  g.ring = o;
  o = pad_to(o + (ring_bytes > wexp_bytes ? ring_bytes : wexp_bytes), 1024);
  g.wred = o;
  o = pad_to(o + g.neb * g.Cn * 128, 1024);
  g.y = o;
  o = pad_to(o + cdiv(rs, 64) * g.neb * kTile, 1024);
  g.x = o;
  o = pad_to(o + K * g.xrows * 128, 1024);
  g.out = o;
  o = pad_to(o + g.nnc * rs * 128, 1024);
  g.bred = o;
  o += g.Cn * 4;
  g.bar = o;
  o += (K + 1) * 8;
  g.bytes = o + 1024;   // the dynamic base is aligned to 1024 at run time
  return true;
}

struct Params {
  CUtensorMap tx;    // x (C, W, H, B), boxes (64, S + 2, R + 1, 1)
  CUtensorMap to;    // out (Cout, W, H, B), boxes (64, S, R, 1)
  const void* wexp;  // Ep x 64 bf16, swizzled: row n holds Wexp[:, n]
  const void* wred;  // neb x Cn x 64 bf16, swizzled: row n holds Wred[:, n]
  const float* bexp; // Ep
  const float* kdw;  // 9 x Ep, row 3 di + dj
  const float* bdw;  // Ep
  const float* bred; // Cn
  Geom g;
  int H, W, residual, nsx, nstrips, nb;
};

// the SiLU of the expand and of the depthwise (mma_common.cuh silu_approx),
// and one depthwise tap t + v.k
__device__ __forceinline__ float act(float z) { return silu_approx(z); }
__device__ __forceinline__ float tap(float t, float v, float k) { return fmaf(v, k, t); }

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void st32(void* p, uint32_t v) { *reinterpret_cast<uint32_t*>(p) = v; }
__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* tm, int c0, int c1, int c2,
                                          int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_store4(const CUtensorMap* tm, const void* src, int c0, int c1,
                                           int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(tm)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's stores have read their shared memory / are complete
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// slot of image row y (y >= -2R - 4) in the ring of R + 2 expanded rows
__device__ __forceinline__ int slot_of(int y) {
  return (y + 2 * (R + 2)) % (R + 2);
}

// element offset of expanded pixel j (0 .. S + 1) in a ring slot
template <int S>
__device__ __forceinline__ int pix(const Geom& g, int j) {
  return j * g.P + (j >> Cut<S>::lg) * 16;
}

// The band's y tile holds output pixel (i, q S/4 + k) in row i S + 8 (k >> 1)
// + 2 q + (k & 1): the depthwise's lanes of one warp store to 8 rows whose
// swizzled 16-byte groups differ. y_lane is the lane's byte offset for
// channel c at rows 2 q + par (the part of the row below 8, par = k & 1).
__device__ __forceinline__ int y_lane(int q, int par, int c) {
  const int r7 = 2 * q + par;
  return (c >> 6) * kTile + swz(r7, c & 63);
}

// this block's step j: the x box of band r = j mod (nb + 1) of its strip
// j div (nb + 1), from the row above the band's new rows, into stage j mod K
template <int S>
__device__ __forceinline__ void load_x(const Params& p, unsigned char* sm, int j, uint64_t* full) {
  const Geom& g = p.g;
  const int strip = blockIdx.x + (j / (p.nb + 1)) * gridDim.x, r = j % (p.nb + 1);
  const int st = j % g.K;
  mbar_expect(full + st, (R + 1) * (S + 2) * 128);
  tma_load4(sm + g.x + st * g.xrows * 128, &p.tx, 0, (strip % p.nsx) * S - 1, (r - 1) * R,
            strip / p.nsx, full + st);
}

// ldmatrix address of lane's row of Wexp's fragments (k-step ks, the warp's
// 16 channels from n0): matrices (n0.., k0..), (n0.., k8..), (n8.., k0..),
// (n8.., k8..), i.e. b0 b1 of the two n-tiles
__device__ __forceinline__ uint32_t wexp_frag(const unsigned char* w, int n0, int ks, int lane) {
  const int n = n0 + (lane & 7) + ((lane >> 4) << 3), k = ks * 16 + ((lane >> 3) & 1) * 8;
  return smem_u32(w + swz(n, k));
}

// The expand of the warp's 16 channels for band r's R new rows (image rows
// y_first ..): SiLU(x.Wexp + bexp) -> bf16 into the ring, 0 for pixels
// outside the image.
template <int S>
__device__ __forceinline__ void expand(const Params& p, const unsigned char* xs, bf16* ring,
                                       const uint32_t (&bw)[4][4], const float (&be)[2][2],
                                       int y_first, int x0, int warp, int lane) {
  using T = Cut<S>;
  const Geom& g = p.g;
  const int gq = lane >> 2, tq = lane & 3, n0 = warp * 16;
  // ring offset of each new image row, and whether it lies in the image (bit i)
  int erow[R];
  unsigned rows_in = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    erow[i] = slot_of(y_first + i) * g.slot + n0 + 2 * tq;
    rows_in |= (unsigned)(y_first + i >= 0 && y_first + i < p.H) << i;
  }
  // the lane's ldmatrix row (sp + 16 mt + lane % 16 of the box) and its
  // swizzled 16-byte groups, the same for every m-tile that needs no clamp
  const uint32_t xa = smem_u32(xs);
  const int lrow = T::sp + (lane & 15);
  const uint32_t abase = xa + lrow * 128;
  uint32_t kgrp[4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) kgrp[ks] = (((2 * ks + (lane >> 4)) ^ lrow) & 7) << 4;
#pragma unroll
  for (int mt = 0; mt < T::mp / 16; ++mt) {
    float acc[2][4] = {};
    // rows past the band's R (S + 2) pixels read its last one (not stored)
    const int arow = T::sp + min(mt * 16 + (lane & 15), R * T::sp - 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a0, a1, a2, a3;
      if (mt * 16 + 15 < R * T::sp)
        ldmatrix_x4(abase + mt * 16 * 128 + kgrp[ks], a0, a1, a2, a3);
      else
        ldmatrix_x4(xa + swz(arow, ks * 16 + (lane >> 4) * 8), a0, a1, a2, a3);
      mma_bf16(acc[0], a0, a1, a2, a3, bw[ks][0], bw[ks][1]);
      mma_bf16(acc[1], a0, a1, a2, a3, bw[ks][2], bw[ks][3]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int pr = mt * 16 + gq + 8 * hf;
      const int i = (pr * T::msp) >> 16, j = pr - i * T::sp;
      int off = erow[0];
#pragma unroll
      for (int t = 1; t < R; ++t) off = i == t ? erow[t] : off;
      const bool in = ((rows_in >> i) & 1) && (unsigned)(x0 - 1 + j) < (unsigned)p.W;
      bf16* dst = ring + off + pix<S>(g, j);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint32_t v = pack_bf16(act(addf(acc[nt][2 * hf], be[nt][0])),
                                     act(addf(acc[nt][2 * hf + 1], be[nt][1])));
        if (pr < R * T::sp) st32(dst + 8 * nt, in ? v : 0u);
      }
    }
  }
}

// The depthwise of the lane's channel pair c, c + 1 over the band of output
// rows y0 .. y0 + R - 1 and strip columns q S/4 .., in the TPU body's order;
// SiLU(acc + bdw) -> bf16 into the y tile at ys.
template <int S>
__device__ __forceinline__ void depthwise(const Geom& g, const bf16* ring, unsigned char* ys,
                                          const float (&kx)[9], const float (&ky)[9], float bdx,
                                          float bdy, int y0, int c, int q) {
  using T = Cut<S>;
  const int k0 = q * T::cpg;
  // the window's R + 2 rows at the lane's first column k0 and channel c;
  // column k0 + j lies pix(j) further (pix(k0 + j) = pix(k0) + pix(j), as k0
  // is a multiple of S/4), the same for every lane
  const bf16* wrow[R + 2];
#pragma unroll
  for (int ii = 0; ii < R + 2; ++ii)
    wrow[ii] = ring + slot_of(y0 - 1 + ii) * g.slot + pix<S>(g, k0) + c;
  unsigned char* const yb[2] = {ys + y_lane(q, 0, c), ys + y_lane(q, 1, c)};
  float2 w0[R + 2], w1[R + 2], w2[R + 2];
  // expanded column k0 + j of the window's R + 2 rows
  auto load = [&](float2(&w)[R + 2], int j) {
    const int o = pix<S>(g, j);
#pragma unroll
    for (int ii = 0; ii < R + 2; ++ii) {
      const uint32_t u = ld32(wrow[ii] + o);
      w[ii] = make_float2(lo_f(u), hi_f(u));
    }
  };
  // the column sum of tap column dj for output row i: three row taps in order
  auto colsum = [&](const float2(&w)[R + 2], int i, int dj, float& sx, float& sy) {
    sx = tap(tap(mulf(w[i].x, kx[dj]), w[i + 1].x, kx[3 + dj]), w[i + 2].x, kx[6 + dj]);
    sy = tap(tap(mulf(w[i].y, ky[dj]), w[i + 1].y, ky[3 + dj]), w[i + 2].y, ky[6 + dj]);
  };
  // output column k0 + k from window columns a, b, n (n loaded here)
  auto column = [&](const float2(&a)[R + 2], const float2(&b)[R + 2], float2(&n)[R + 2], int k) {
    load(n, k + 2);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float sx0, sy0, sx1, sy1, sx2, sy2;
      colsum(a, i, 0, sx0, sy0);
      colsum(b, i, 1, sx1, sy1);
      colsum(n, i, 2, sx2, sy2);
      const int row = i * S + 8 * (k >> 1);   // the row less its lane part, a multiple of 8
      st32(yb[k & 1] + (row >> 6) * g.neb * kTile + (row & 63) * 128,
           pack_bf16(act(addf(addf(addf(sx0, sx1), sx2), bdx)),
                     act(addf(addf(addf(sy0, sy1), sy2), bdy))));
    }
  };
  load(w0, 0);
  load(w1, 1);
#pragma unroll
  for (int k = 0; k < T::cpg; k += 3) {
    column(w0, w1, w2, k);
    if (k + 1 < T::cpg) column(w1, w2, w0, k + 1);
    if (k + 2 < T::cpg) column(w2, w0, w1, k + 2);
  }
}

// The reduce of item (mt, nq): rows mt*64 .. of the band's y tile times
// Wred's N columns from N nq (K = 64 NEB, one chain of products), + bred,
// + x, -> bf16 into the staging tile.
template <int S, int N, int NEB>
__device__ __forceinline__ void reduce(const Params& p, const unsigned char* ys,
                                       const unsigned char* wred_s, const float* bred_s,
                                       const unsigned char* xs, unsigned char* out_s, int mt,
                                       int nq, int warp, int lane) {
  using T = Cut<S>;
  const Geom& g = p.g;
  float d[N / 2];
  // descriptors advance by their start address in 16-byte units (shared
  // addresses stay below 2^18, so the 14-bit field does not carry)
  const uint64_t da0 = desc_k(smem_u32(ys + mt * NEB * kTile));
  const uint64_t db0 = desc_k(smem_u32(wred_s + nq * N * 128));
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NEB; ++kk) {
    const uint64_t da = da0 + (((kk >> 2) * kTile + 32 * (kk & 3)) >> 4);
    const uint64_t db = db0 + (((kk >> 2) * g.Cn * 128 + 32 * (kk & 3)) >> 4);
    if constexpr (N == 16) wgmma_n16(d, da, db, kk > 0);
    else if constexpr (N == 32) wgmma_n32(d, da, db, kk > 0);
    else wgmma_n64(d, da, db, kk > 0);
  }
  wg_commit();
  wg_wait<0>();
  wg_pin(d);
  const int gq = lane >> 2, tq = lane & 3, box = nq * N / 64, c0 = nq * N % 64;
  unsigned char* ob = out_s + box * T::rs * 128;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = mt * 64 + 16 * (warp & 3) + gq + 8 * hf;
    if (row >= T::rs) continue;
    const int i = (unsigned)row / S, rr = (unsigned)row % S;
    const int jj = ((rr & 7) >> 1) * T::cpg + 2 * (rr >> 3) + (rr & 1);
    const int orow = i * S + jj, xrow = i * T::sp + jj + 1;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = c0 + 8 * j + 2 * tq;
      const float2 bias = *reinterpret_cast<const float2*>(bred_s + 64 * box + col);
      float v0 = addf(d[4 * j + 2 * hf], bias.x), v1 = addf(d[4 * j + 2 * hf + 1], bias.y);
      if (p.residual) {   // C == Cout <= 64: box 0 of x
        const uint32_t u = ld32(xs + swz(xrow, col));
        v0 = addf(v0, lo_f(u));
        v1 = addf(v1, hi_f(u));
      }
      st32(ob + swz(orow, col), pack_bf16(v0, v1));
    }
  }
}

// thread 0: the staging tile out to the band at (x0, y0) of image b
__device__ __forceinline__ void store_band(const Params& p, const unsigned char* out_s, int rs,
                                           int x0, int y0, int b) {
  for (int nc = 0; nc < p.g.nnc; ++nc)
    tma_store4(&p.to, out_s + nc * rs * 128, 64 * nc, x0, y0, b);
  bulk_commit();
}

template <int S>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    ir_strip_kernel(const __grid_constant__ Params p) {
  using T = Cut<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const sm = align1024(smem_raw);
  const Geom& g = p.g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned char* const wred_s = sm + g.wred;
  unsigned char* const ys = sm + g.y;
  unsigned char* const out_s = sm + g.out;
  bf16* const ring = reinterpret_cast<bf16*>(sm + g.ring);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + g.bar);
  uint64_t* const wbar = full + g.K;
  float* const bred_s = reinterpret_cast<float*>(sm + g.bred);
  const int nit = cdiv(p.nstrips - (int)blockIdx.x, (int)gridDim.x) * (p.nb + 1);

  if (tid == 0) {
    for (int s = 0; s < g.K; ++s) mbar_init(full + s, 1);
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  for (int i = tid; i < g.Cn; i += blockDim.x) bred_s[i] = p.bred[i];
  __syncthreads();
  if (tid == 0) {
    const int wb = g.Ep * 128, rb = g.neb * g.Cn * 128;
    mbar_expect(wbar, wb + rb);
    bulk_load(sm + g.ring, p.wexp, wb, wbar);
    bulk_load(wred_s, p.wred, rb, wbar);
    for (int j = 0; j < g.K - 1 && j < nit; ++j) load_x<S>(p, sm, j, full);
  }
  // the warp's expand biases and Wexp fragments, the lane's depthwise taps
  const int n0 = warp * 16, tq = lane & 3, c = n0 + 2 * (lane & 7), q = lane >> 3;
  float be[2][2], kx[9], ky[9];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    be[nt][0] = p.bexp[n0 + 8 * nt + 2 * tq];
    be[nt][1] = p.bexp[n0 + 8 * nt + 2 * tq + 1];
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    kx[i] = p.kdw[i * g.Ep + c];
    ky[i] = p.kdw[i * g.Ep + c + 1];
  }
  const float bdx = p.bdw[c], bdy = p.bdw[c + 1];
  mbar_wait(wbar, 0);
  uint32_t bw[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldmatrix_x4(wexp_frag(sm + g.ring, n0, ks, lane), bw[ks][0], bw[ks][1], bw[ks][2], bw[ks][3]);
  __syncthreads();   // Wexp's buffer becomes the ring

  const int wg = warp >> 2, nwg = g.warps >> 2, nq = g.Cn / kReduceN, items = T::nmt * nq;
  int it = 0, st = 0, phase = 0;   // step, its x stage and that stage's parity
  int pend_b = -1, pend_x0 = 0, pend_y0 = 0;   // thread 0: the staging tile's band
  for (int strip = blockIdx.x; strip < p.nstrips; strip += gridDim.x) {
    const int b = strip / p.nsx, x0 = (strip % p.nsx) * S;
    // step r expands band r (rows (r-1)R+1 .. rR) and finishes band r - 1
    for (int r = 0; r <= p.nb; ++r, ++it, st = st + 1 == g.K ? 0 : st + 1, phase ^= st == 0) {
      const unsigned char* xs = sm + g.x + st * g.xrows * 128;
      mbar_wait(full + st, phase);
      // the expand touches neither y nor the staging tile: the warps that do
      // not reduce run it while one warpgroup reduces the band before
      expand<S>(p, xs, ring, bw, be, (r - 1) * R + 1, x0, warp, lane);
      __syncthreads();
      if (tid == 0) {
        if (pend_b >= 0) store_band(p, out_s, T::rs, pend_x0, pend_y0, pend_b);
        pend_b = -1;
        // stage (it - 1) mod K: read by step it - 1's expand and reduce
        if (it + g.K - 1 < nit) load_x<S>(p, sm, it + g.K - 1, full);
      }
      if (r > 0) depthwise<S>(g, ring, ys, kx, ky, bdx, bdy, (r - 1) * R, c, q);
      fence_async_smem();
      if (tid == 0) bulk_wait_read();
      __syncthreads();
      if (r > 0) {
        for (int item = wg; item < items; item += nwg) {
          const int m = item / nq, n = item - m * nq;
#define IR_REDUCE(NEB) \
  reduce<S, kReduceN, NEB>(p, ys, wred_s, bred_s, xs, out_s, m, n, warp, lane)
          switch (g.neb) {   // K = 64 neb: one straight chain of products
            case 1: IR_REDUCE(1); break;
            case 2: IR_REDUCE(2); break;
            case 3: IR_REDUCE(3); break;
            default: IR_REDUCE(4);
          }
#undef IR_REDUCE
        }
        fence_async_smem();
        if (tid == 0) {
          pend_b = b;
          pend_x0 = x0;
          pend_y0 = (r - 1) * R;
        }
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    if (pend_b >= 0) store_band(p, out_s, T::rs, pend_x0, pend_y0, pend_b);
    bulk_wait();
  }
}

// a bf16 (B, H, W, ch) array as a 4-D tensor map read or written in boxes
// of (64, bw, bh, 1) with the 128-byte swizzle; coordinates outside it read
// zeros and are not written
int make_map(CUtensorMap* m, const void* ptr, int ch, int W, int H, int B, int bw, int bh) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[4] = {(cuuint64_t)ch, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ch * 2, (cuuint64_t)W * ch * 2,
                                 (cuuint64_t)H * W * ch * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t es[4] = {1, 1, 1, 1};
  const CUresult res = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                          strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Blocks a launch of a kernel can keep resident on the device: the shared-
// memory attribute (set to the device's opt-in maximum, so no launch lowers
// it under another's) and the occupancy query cost microseconds, so each
// (device, kernel, threads, bytes) asks once.
struct Resident {
  int dev, threads, bytes, blocks;
  const void* fn;
};
std::mutex resident_mu;
Resident resident[32];
int n_resident = 0;

template <int S>
int launch(const Params& p, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(ir_strip_kernel<S>);
  const int threads = 32 * p.g.warps, bytes = p.g.bytes;
  int dev = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  {
    std::lock_guard<std::mutex> lock(resident_mu);
    for (int i = 0; i < n_resident; ++i) {
      const Resident& e = resident[i];
      if (e.dev == dev && e.fn == fn && e.threads == threads && e.bytes == bytes)
        blocks = e.blocks;
    }
  }
  if (blocks == 0) {
    int sms = 0, per = 0, optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess && bytes > optin) return (int)cudaErrorInvalidValue;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ir_strip_kernel<S>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, ir_strip_kernel<S>, threads,
                                                          bytes);
    if (err != cudaSuccess) return (int)err;
    if (per < 1) return (int)cudaErrorInvalidConfiguration;
    blocks = per * sms;
    std::lock_guard<std::mutex> lock(resident_mu);
    if (n_resident < 32) resident[n_resident++] = Resident{dev, threads, bytes, blocks, fn};
  }
  ir_strip_kernel<S><<<p.nstrips < blocks ? p.nstrips : blocks, threads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory of plan (S, K) at these widths, -1
// where the kernel does not take them: the wrapper holds its own reckoning
// (ir_smem_bytes) against it.
extern "C" long long gxt_inverted_residual_smem(int S, int K, int C, int E, int Cout) {
  Geom g;
  return geom(g, S, K, C, E, Cout) ? (long long)g.bytes : -1;
}

// x, out: NHWC bf16 (C and Cout multiples of 8); wexp (ceil(C/64), Ep, 64)
// and wred (Ep/64, Cn, 64) bf16, 128-byte swizzled, row n holding the
// weights of output channel n (ops/fused_transformer_layer.k_tiles); bexp,
// bdw (Ep), kdw (9, Ep), bred (Cn) f32, zero past E and Cout. Stride 1;
// residual needs C == Cout.
extern "C" int gxt_inverted_residual(const void* x, const void* wexp, const float* bexp,
                                     const float* kdw, const float* bdw, const void* wred,
                                     const float* bred, void* out, int B, int H, int W, int C,
                                     int E, int Cout, int residual, int S, int K,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  Params p;
  if (!geom(p.g, S, K, C, E, Cout) || (residual && C != Cout))
    return (int)cudaErrorInvalidValue;
  p.wexp = wexp;
  p.wred = wred;
  p.bexp = bexp;
  p.kdw = kdw;
  p.bdw = bdw;
  p.bred = bred;
  p.H = H;
  p.W = W;
  p.residual = residual;
  p.nsx = cdiv(W, S);
  p.nstrips = B * p.nsx;
  p.nb = cdiv(H, R);
  int err = make_map(&p.tx, x, C, W, H, B, S + 2, R + 1);
  if (err == 0) err = make_map(&p.to, out, Cout, W, H, B, S, R);
  if (err != 0) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  return S == 16 ? launch<16>(p, st) : launch<32>(p, st);
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
