// MobileNetV2 inverted residual at f32, stride 1: expand 1x1 (folded BN,
// SiLU) -> depthwise 3x3 over a zero ring (folded BN, SiLU) -> reduce 1x1
// (+ folded bias, + residual), with no rounding below f32 anywhere.
//
//   gxt_ir_f32  replaces ggml_experiments_tpu/ops/fused_inverted_residual.py
//               `fused_inverted_residual` at compute_dtype=float32
//               (pallas_call :146; body `_ir_kernel` :44)
//
// What it computes, as the TPU body does at f32: ex = x.Wexp in f32,
// SiLU(ex + bexp); the 3x3 depthwise with f32 taps, summed in the TPU body's
// order (for each column tap dj the three row taps di in order, then the
// three column sums in order), SiLU(acc + bdw); out = y.Wred + bred, + x with
// the residual. The zero ring holds zeros AFTER the expand's SiLU. The two
// 1x1 products run as 3xTF32 (each operand split into a tf32 high part and
// its remainder, three products, small terms first), so their sums keep
// f32 accuracy; the depthwise is written out with __fadd_rn / __fmul_rn (no
// multiply-add contracted) and the SiLUs are the correctly rounded
// z * (1 / (1 + expf(-z))): the plain version's arithmetic up to the
// products' summation order.
//
// Bound on an H100 at layer_2's shape (B = 128, 64 x 64, C = 64, E = 256,
// Cout = 64): 34.4 GFLOP of 1x1 products, three tf32 products each at the
// tf32 rate (0.21 ms at 495 / 3 TFLOP/s); 268 MB moved (0.08 ms); 268 M
// SiLUs on the MUFU (0.064 ms): the products bound it.
//
// Design: one block of 8 warps a tile of 8 x 8 output pixels of one image.
// The block stages the tile's 10 x 10 halo of x (f32, zero outside the
// image) in shared memory once, then walks E in chunks of 64 expanded
// channels, so that shared memory holds one chunk of the expanded halo and
// one of the depthwise output (75 KB at C = 64, where the whole of E at f32
// would take 190 KB): each chunk is expanded (mma.sync m16n8k8, 7 row tiles
// of 16 halo pixels, items of 16 columns spread over the warps), run
// through the depthwise (a thread a channel and two output rows) and
// reduced into accumulators that stay in registers across the chunks (a
// warp owns 16 output pixels and Cout / 2 columns). Weights come from L2
// and L1 a fragment at a time. Neighbouring tiles expand their shared halo
// pixels each (100 pixels for 64 outputs). No atomics and a fixed order of
// sums: two launches give the same bits.
#include "mma_common.cuh"

namespace {

using namespace gxt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 8;               // output tile edge
constexpr int kHalo = kT + 2;       // 10
constexpr int kHP = kHalo * kHalo;  // 100 halo pixels
constexpr int kHPad = 112;          // padded to 7 row tiles of 16
constexpr int kEC = 64;             // expanded channels a chunk
constexpr int kLdE = kEC + 4;       // row stride (floats) of the chunk buffers: 4 x odd

__host__ __device__ constexpr int pad_to(int a, int m) { return (a + m - 1) / m * m; }

struct Args {
  const float* x;      // (B, H, W, C)
  const float* wexp;   // (Cp, Ep), zero past C rows and E columns
  const float* bexp;   // (Ep)
  const float* kdw;    // (9, Ep), row 3 di + dj
  const float* bdw;    // (Ep)
  const float* wred;   // (Ep, Cw), zero past E rows and Cout columns
  const float* bred;   // (Cw)
  float* out;          // (B, H, W, Cout)
  int B, H, W, C, Cp, Ep, Cout, Cw, residual;
};

// Shared memory of a launch, in bytes: the x halo (rows of Cp + 4 floats,
// 4 x odd, so that the tf32 fragment loads of 8 rows x 4 lanes hit 32
// distinct banks), the expanded chunk and the depthwise chunk.
// ops/fused_inverted_residual.py ir_f32_smem_bytes repeats the reckoning.
struct Layout {
  int ldx;
  size_t xs, xe, y, bytes;
};

Layout layout(int Cp) {
  Layout l;
  l.ldx = Cp + 4;
  l.xs = (size_t)kHPad * l.ldx * 4;
  l.xe = (size_t)kHP * kLdE * 4;
  l.y = (size_t)kT * kT * kLdE * 4;
  l.bytes = l.xs + l.xe + l.y;
  return l;
}

// n-tiles of 8 columns a warp reduces: two warps share the 16 output rows
// of an m-tile, so Cout is covered in steps of 16 (Cw = 16 NTW)
int reduce_tiles(int Cout) {
  for (int ntw = 1; ntw <= 8; ntw *= 2)
    if (16 * ntw >= Cout) return ntw;
  return 0;
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

// c += A . B for the 8 x 8 block of a row-major (K, ldb) weight at p (rows t
// and t + 4 of column g), 3xTF32
__device__ __forceinline__ void mma_w(float (&c)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], const float* p, int ldb) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(__ldg(p), bh0, bl0);
  split_tf32(__ldg(p + 4 * ldb), bh1, bl1);
  mma_tf32x<true>(c, ah, al, bh0, bh1, bl0, bl1);
}

template <int NTW>
__global__ void __launch_bounds__(kThreads, 2) ir_f32_kernel(Args a, Layout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const xs = reinterpret_cast<float*>(smem);                     // [112][ldx] x halo
  float* const xe = reinterpret_cast<float*>(smem + lay.xs);            // [100][kLdE]
  float* const ys = reinterpret_cast<float*>(smem + lay.xs + lay.xe);   // [64][kLdE]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int tiles_w = (a.W + kT - 1) / kT, tiles_h = (a.H + kT - 1) / kT;
  const int b = blockIdx.x / (tiles_w * tiles_h), tr = blockIdx.x % (tiles_w * tiles_h);
  const int y0 = (tr / tiles_w) * kT, x0 = (tr % tiles_w) * kT;
  const int H = a.H, W = a.W, C = a.C, Cp = a.Cp, ldx = lay.ldx;

  // 1. the halo of x, zero outside the image and in the padding
  const float* xb = a.x + (size_t)b * H * W * C;
  for (int i = tid; i < kHPad * Cp; i += kThreads) {
    const int p = i / Cp, c = i - p * Cp;
    const int hy = y0 - 1 + p / kHalo, hx = x0 - 1 + p % kHalo;
    float v = 0.f;
    if (p < kHP && c < C && hy >= 0 && hy < H && hx >= 0 && hx < W)
      v = xb[((size_t)hy * W + hx) * C + c];
    xs[p * ldx + c] = v;
  }
  __syncthreads();

  // the reduce's accumulators: m-tile rm (output pixels 16 rm ..), columns rn0 ..
  const int rm = warp & 3, rn0 = (warp >> 2) * NTW * 8;
  float acc[NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int e0 = 0; e0 < a.Ep; e0 += kEC) {
    // 2. expand the chunk: items of (row tile of 16 halo pixels, 16 columns)
    for (int item = warp; item < 7 * (kEC / 16); item += kWarps) {
      const int mt = item / (kEC / 16), n0 = (item % (kEC / 16)) * 16;
      float c2[2][4] = {};
      for (int k0 = 0; k0 < Cp; k0 += 8) {
        uint32_t ah[4], al[4];
        a_frags(xs + mt * 16 * ldx + k0, ldx, g, t, ah, al);
        const float* bp = a.wexp + (size_t)(k0 + t) * a.Ep + e0 + n0 + g;
        mma_w(c2[0], ah, al, bp, a.Ep);
        mma_w(c2[1], ah, al, bp + 8, a.Ep);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = mt * 16 + g + 8 * hf;
        if (p >= kHP) continue;
        const int hy = y0 - 1 + p / kHalo, hx = x0 - 1 + p % kHalo;
        const bool in = hy >= 0 && hy < H && hx >= 0 && hx < W;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = n0 + nt * 8 + 2 * t;
          float2 v = make_float2(0.f, 0.f);
          if (in) {
            v.x = silu(addf(c2[nt][2 * hf], a.bexp[e0 + col]));
            v.y = silu(addf(c2[nt][2 * hf + 1], a.bexp[e0 + col + 1]));
          }
          *reinterpret_cast<float2*>(xe + p * kLdE + col) = v;
        }
      }
    }
    __syncthreads();

    // 3. the depthwise of the chunk: a thread owns channel c and output rows
    // 2q, 2q + 1, in the TPU body's summation order
    {
      const int c = tid % kEC, q = tid / kEC;
      float k[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) k[i] = a.kdw[i * a.Ep + e0 + c];
      const float bd = a.bdw[e0 + c];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int oy = 2 * q + i;
#pragma unroll 2
        for (int ox = 0; ox < kT; ++ox) {
          float s = 0.f;
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            float col = 0.f;
#pragma unroll
            for (int di = 0; di < 3; ++di)
              col = addf(col, mulf(xe[((oy + di) * kHalo + ox + dj) * kLdE + c], k[3 * di + dj]));
            s = addf(s, col);
          }
          ys[(oy * kT + ox) * kLdE + c] = silu(addf(s, bd));
        }
      }
    }
    __syncthreads();

    // 4. reduce the chunk into the accumulators (the next chunk's expand
    // writes xe only, and its depthwise writes ys after the next barrier)
#pragma unroll 2
    for (int k0 = 0; k0 < kEC; k0 += 8) {
      uint32_t ah[4], al[4];
      a_frags(ys + rm * 16 * kLdE + k0, kLdE, g, t, ah, al);
      const float* bp = a.wred + (size_t)(e0 + k0 + t) * a.Cw + rn0 + g;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) mma_w(acc[nt], ah, al, bp + nt * 8, a.Cw);
    }
  }

  // 5. + bred, + x, out
  float* ob = a.out + (size_t)b * H * W * a.Cout;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int op = rm * 16 + g + 8 * hf, oy = op / kT, ox = op % kT;
      if (y0 + oy >= H || x0 + ox >= W) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = rn0 + nt * 8 + 2 * t + j;
        if (c >= a.Cout) continue;
        float o = addf(acc[nt][2 * hf + j], a.bred[c]);
        if (a.residual) o = addf(o, xs[((oy + 1) * kHalo + ox + 1) * ldx + c]);
        ob[((size_t)(y0 + oy) * W + x0 + ox) * a.Cout + c] = o;
      }
    }
  }
}

template <int NTW>
int launch(const Args& a, const Layout& lay, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ir_f32_kernel<NTW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = a.B * ((a.H + kT - 1) / kT) * ((a.W + kT - 1) / kT);
  ir_f32_kernel<NTW><<<grid, kThreads, lay.bytes, stream>>>(a, lay);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a launch at these widths needs, -1 where
// the kernel does not take them (Cout past 128): the wrapper holds its own
// reckoning (ir_f32_smem_bytes) against it.
extern "C" long long gxt_ir_f32_smem(int C, int E, int Cout) {
  if (C <= 0 || E <= 0 || Cout <= 0 || reduce_tiles(Cout) == 0) return -1;
  return (long long)layout(pad_to(C, 8)).bytes;
}

// x, out: NHWC f32; wexp (pad8(C), pad64(E)) and wred (pad64(E), Cw) f32,
// row-major and zero-padded, with Cw = 16, 32, 64 or 128, the least that
// holds Cout; bexp, bdw (pad64(E)), kdw (9, pad64(E)), bred (Cw) f32, zero
// past E and Cout. Stride 1; residual needs C == Cout.
extern "C" int gxt_ir_f32(const float* x, const float* wexp, const float* bexp, const float* kdw,
                          const float* bdw, const float* wred, const float* bred, float* out,
                          int B, int H, int W, int C, int E, int Cout, int residual,
                          void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const int ntw = reduce_tiles(Cout);
  if (C <= 0 || E <= 0 || ntw == 0 || (residual && C != Cout)) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.wexp = wexp;
  a.bexp = bexp;
  a.kdw = kdw;
  a.bdw = bdw;
  a.wred = wred;
  a.bred = bred;
  a.out = out;
  a.B = B; a.H = H; a.W = W; a.C = C; a.Cp = pad_to(C, 8); a.Ep = pad_to(E, kEC);
  a.Cout = Cout; a.Cw = 16 * ntw; a.residual = residual;
  const Layout lay = layout(a.Cp);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (ntw) {
    case 1: return launch<1>(a, lay, st);
    case 2: return launch<2>(a, lay, st);
    case 4: return launch<4>(a, lay, st);
    default: return launch<8>(a, lay, st);
  }
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
