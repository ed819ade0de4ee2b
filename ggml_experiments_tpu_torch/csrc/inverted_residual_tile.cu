// MobileNetV2 inverted residual, stride 1, one 8 x 8 tile of outputs a
// block: the route of the shapes that inverted_residual.cu does not take (C
// or Cout not a multiple of 8, E > 256, or weights and rings past one
// block's shared memory). It computes what inverted_residual.cu computes,
// with the correctly rounded SiLU and no multiply-add contracted.
//
//   gxt_ir_tile  replaces, for those shapes, ggml_experiments_tpu/ops/
//                fused_inverted_residual.py `fused_inverted_residual`
//                (pallas_call :146; body `_ir_kernel` :44)
//
// What it computes, rounding where the TPU body does: ex = x.Wexp summed in
// f32 (bf16 operands), SiLU(ex + bexp) -> bf16; the 3x3 depthwise in f32
// over the bf16 expanded values with f32 taps, summed as the TPU body sums
// (for each column tap dj, the three row taps di in order, then the three
// column sums in order), SiLU(acc + bdw) -> bf16; out = y.Wred + bred (f32),
// + x in f32 with the residual, -> bf16. The zero ring holds zeros AFTER the
// expand's SiLU: halo pixels outside the image are written as 0, not
// expanded from 0.
//
// Design: one block of 256 threads per 8 x 8 tile of outputs. The block
// stages the 10 x 10 halo of x (bf16, zero outside the image), expands all
// 100 halo pixels on tensor cores (mma.sync m16n8k16; 7 row tiles of 16 by
// E columns, spread over the 8 warps), writes SiLU(ex + bexp) as bf16 into
// shared memory (0 for pixels outside the image), runs the depthwise taps
// one thread per channel pair and half the tile, with f32 sums written out
// (__fadd_rn / __fmul_rn, so no multiply-add is contracted), and reduces the
// 64 rows on tensor cores with the residual read from the staged x tile.
// Neighbouring tiles expand their shared halo pixels each (100 pixels for 64
// outputs), and the weights come from L2 a fragment at a time: 2.2 ms at
// the main path's shape on an H100 (PERF.md), which is why that shape runs
// on inverted_residual.cu.
#include "mma_common.cuh"

namespace {

using namespace gxt;

constexpr int kThreads = 256;
constexpr int kT = 8;               // output tile edge
constexpr int kHalo = kT + 2;       // 10
constexpr int kHP = kHalo * kHalo;  // 100 halo pixels
constexpr int kHPad = 112;          // padded to 7 row tiles of 16

struct IRArgs {
  const bf16* x;     // (B, H, W, C)
  const bf16* wexp;  // [E][Cp] (transposed, K padded to 16)
  const float* bexp; // (E)
  const float* kdw;  // (9, E) taps, row 3*di + dj
  const float* bdw;  // (E)
  const bf16* wred;  // [Cout][Ep]
  const float* bred; // (Cout)
  bf16* out;         // (B, H, W, Cout)
  int B, H, W, C, E, Cout, residual;
};

struct IRLayout {
  int Cp, Ep, ldx, lde, ldy;
  size_t xs_bytes, xe_bytes, y_bytes;
};

inline IRLayout ir_layout(int C, int E) {
  IRLayout s;
  s.Cp = pad16(C);
  s.Ep = pad16(E);
  s.ldx = ld_bank(s.Cp);
  s.lde = s.Ep + 8;
  s.ldy = ld_bank(s.Ep);
  s.xs_bytes = (size_t)kHPad * s.ldx * sizeof(bf16);
  s.xe_bytes = (size_t)kHP * s.lde * sizeof(bf16);
  s.y_bytes = (size_t)kT * kT * s.ldy * sizeof(bf16);
  return s;
}

__global__ void __launch_bounds__(kThreads) ir_kernel(IRArgs a, IRLayout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                    // [112][ldx] halo of x
  bf16* xe = reinterpret_cast<bf16*>(smem + lay.xs_bytes);     // [100][lde] expanded
  bf16* yb = reinterpret_cast<bf16*>(smem + lay.xs_bytes + lay.xe_bytes);  // [64][ldy]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_w = (a.W + kT - 1) / kT, tiles_h = (a.H + kT - 1) / kT;
  const int b = blockIdx.x / (tiles_w * tiles_h);
  const int tr = blockIdx.x % (tiles_w * tiles_h);
  const int y0 = (tr / tiles_w) * kT, x0 = (tr % tiles_w) * kT;
  const int C = a.C, E = a.E, H = a.H, W = a.W;
  const bf16* xb = a.x + (size_t)b * H * W * C;

  // 1. the halo of x, zero outside the image and in the padding
  for (int i = tid; i < kHPad * lay.Cp; i += kThreads) {
    const int p = i / lay.Cp, c = i % lay.Cp;
    const int hy = y0 - 1 + p / kHalo, hx = x0 - 1 + p % kHalo;
    bf16 v = __float2bfloat16_rn(0.f);
    if (p < kHP && c < C && hy >= 0 && hy < H && hx >= 0 && hx < W)
      v = xb[((size_t)hy * W + hx) * C + c];
    xs[p * lay.ldx + c] = v;
  }
  __syncthreads();

  // 2. expand: 7 row tiles x E columns in 64-wide chunks, over the warps
  const int nchunks = (E + 63) / 64;
  for (int item = warp; item < 7 * nchunks; item += kThreads / 32) {
    const int mt = item / nchunks, n0 = (item % nchunks) * 64;
    warp_gemm<8>(xs + mt * 16 * lay.ldx, lay.ldx, a.wexp, lay.Cp, E, n0, n0 + 64, lane,
                 [&](int r, int c, float v) {
                   const int p = mt * 16 + r;
                   if (p >= kHP) return;
                   const int hy = y0 - 1 + p / kHalo, hx = x0 - 1 + p % kHalo;
                   const bool in = hy >= 0 && hy < H && hx >= 0 && hx < W;
                   xe[p * lay.lde + c] = __float2bfloat16_rn(in ? silu(addf(v, a.bexp[c])) : 0.f);
                 });
  }
  __syncthreads();

  // 3. depthwise 3x3: a thread takes a channel pair (bf16x2 loads) and half
  // of the 64 outputs, in the TPU body's summation order
  {
    const int npairs = lay.Ep / 2;
    for (int w = tid; w < 2 * npairs; w += kThreads) {
      const int c = 2 * (w % npairs), op0 = (w / npairs) * (kT * kT / 2);
      if (c >= E) {  // padding channels (E is even)
        for (int op = op0; op < op0 + kT * kT / 2; ++op)
          *reinterpret_cast<uint32_t*>(yb + op * lay.ldy + c) = 0u;
        continue;
      }
      float k0[9], k1[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        k0[i] = a.kdw[i * E + c];
        k1[i] = a.kdw[i * E + c + 1];
      }
      const float bd0 = a.bdw[c], bd1 = a.bdw[c + 1];
      for (int op = op0; op < op0 + kT * kT / 2; ++op) {
        const int oy = op / kT, ox = op % kT;
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          float t0 = 0.f, t1 = 0.f;
#pragma unroll
          for (int di = 0; di < 3; ++di) {
            const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                xe + ((oy + di) * kHalo + ox + dj) * lay.lde + c));
            t0 = addf(t0, mulf(v.x, k0[3 * di + dj]));
            t1 = addf(t1, mulf(v.y, k1[3 * di + dj]));
          }
          acc0 = addf(acc0, t0);
          acc1 = addf(acc1, t1);
        }
        *reinterpret_cast<uint32_t*>(yb + op * lay.ldy + c) =
            pack_bf16(silu(addf(acc0, bd0)), silu(addf(acc1, bd1)));
      }
    }
  }
  __syncthreads();

  // 4. reduce: 4 row tiles x Cout columns in 32-wide chunks, + bias, + x
  const int rchunks = (a.Cout + 31) / 32;
  bf16* ob = a.out + (size_t)b * H * W * a.Cout;
  for (int item = warp; item < 4 * rchunks; item += kThreads / 32) {
    const int mt = item / rchunks, n0 = (item % rchunks) * 32;
    warp_gemm<4>(yb + mt * 16 * lay.ldy, lay.ldy, a.wred, lay.Ep, a.Cout, n0, n0 + 32, lane,
                 [&](int r, int c, float v) {
                   const int op = mt * 16 + r, oy = op / kT, ox = op % kT;
                   if (y0 + oy >= H || x0 + ox >= W) return;
                   float o = addf(v, a.bred[c]);
                   if (a.residual)
                     o = addf(o, __bfloat162float(xs[((oy + 1) * kHalo + ox + 1) * lay.ldx + c]));
                   ob[((size_t)(y0 + oy) * W + x0 + ox) * a.Cout + c] = __float2bfloat16_rn(o);
                 });
  }
}

}  // namespace

// Bytes of dynamic shared memory a launch with C input and E expanded
// channels needs: the wrapper holds them against the device's limit.
extern "C" long long gxt_ir_tile_smem(int C, int E) {
  const IRLayout lay = ir_layout(C, E);
  return (long long)(lay.xs_bytes + lay.xe_bytes + lay.y_bytes);
}

// x, out: NHWC bf16; wexp [E][pad16(C)] and wred [Cout][pad16(E)] bf16,
// transposed and zero-padded on K; bexp, bdw (E), kdw (9, E), bred (Cout)
// f32. Stride 1; residual needs C == Cout.
extern "C" int gxt_ir_tile(const void* x, const void* wexp, const float* bexp, const float* kdw,
                           const float* bdw, const void* wred, const float* bred, void* out, int B,
                           int H, int W, int C, int E, int Cout, int residual, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (C <= 0 || E <= 0 || Cout <= 0 || (residual && C != Cout)) return (int)cudaErrorInvalidValue;
  IRArgs a;
  a.x = static_cast<const bf16*>(x);
  a.wexp = static_cast<const bf16*>(wexp);
  a.bexp = bexp;
  a.kdw = kdw;
  a.bdw = bdw;
  a.wred = static_cast<const bf16*>(wred);
  a.bred = bred;
  a.out = static_cast<bf16*>(out);
  a.B = B; a.H = H; a.W = W; a.C = C; a.E = E; a.Cout = Cout; a.residual = residual;
  const IRLayout lay = ir_layout(C, E);
  const size_t smem = lay.xs_bytes + lay.xe_bytes + lay.y_bytes;
  cudaError_t err = cudaFuncSetAttribute(ir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = B * ((H + kT - 1) / kT) * ((W + kT - 1) / kT);
  ir_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a, lay);
  return (int)cudaGetLastError();
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
