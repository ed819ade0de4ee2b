// MobileNetV2 inverted residual at stride 2, bf16 or f32: expand 1x1
// (folded BN, SiLU) over every input pixel -> depthwise 3x3 at stride 2
// over a zero ring (folded BN, SiLU) -> reduce 1x1 (+ folded bias), no
// residual. MobileViT-small's four downsampling blocks (layer_2[0] and the
// downsampling block of layers 3-5) are this form.
//
//   gxt_ir_s2  replaces ggml_experiments_tpu/ops/fused_inverted_residual.py
//              `fused_inverted_residual` at stride=2 (pallas_call :146; body
//              `_ir_kernel` :44, its strided branch :85-92)
//
// What it computes, as the TPU body does at stride 2: ex = x.Wexp summed in
// f32 (operands at the compute dtype), SiLU(ex + bexp), rounded to bf16 at
// bf16; a zero ring of one pixel on every side, zeros AFTER the SiLU
// (symmetric padding: output (i, j) reads input rows 2i-1 .. 2i+1 and
// columns 2j-1 .. 2j+1, so H and W must be even); the nine taps summed into
// ONE f32 accumulator in (di, dj) row-major order, SiLU(acc + bdw), rounded
// to bf16 at bf16; out = y.Wred + bred in f32, stored at the compute dtype.
// At f32 the two 1x1 products run as 3xTF32 (f32-accurate), the depthwise is
// written out with __fadd_rn / __fmul_rn and the SiLUs are the correctly
// rounded z * (1 / (1 + expf(-z))). At bf16 the products are bf16 mma.sync
// with f32 sums, the taps are multiply-adds and the SiLUs use the hardware
// exp2 and reciprocal (a few f32 ulps before each bf16 rounding).
//
// Bound on an H100 (PERF.md, chip_smoke.py ir_bound): at bf16 the 2 SiLUs an
// expanded element (one at each input pixel, one at each output pixel) on
// the MUFU for the three widest blocks (layer_2[0] at B = 128: 335 M SiLUs,
// 0.080 ms), the 1x1 products for layer_5's; at f32 the 1x1 products as
// three tf32 products each (layer_2[0]: 25.8 GFLOP, 0.156 ms).
//
// Design: one block of 8 warps a tile of 4 x 8 output pixels of one image.
// The block stages the tile's 9 x 17 input halo of x (zero outside the
// image) in shared memory once, then walks E in chunks of 64 expanded
// channels, so that shared memory holds one chunk of the expanded halo and
// one of the depthwise output whatever E is (135 KB at f32, C = 128; 70 KB
// at bf16): each chunk is expanded (mma.sync, 10 row tiles of 16 halo
// pixels, items of 16 columns spread over the warps), run through the
// depthwise (a thread a channel and one output row of 8 pixels) and reduced
// into accumulators that stay in registers across the chunks (a warp owns
// 16 output pixels and a quarter of Cout, Cout rounded up to 32: up to 256).
// Weights come from L2 and L1 a fragment at a time. The halo expands 153
// pixels for 32 outputs (4.8 a pixel where the input has 4). No atomics and
// a fixed order of sums: two launches give the same bits.
#include "mma_common.cuh"

namespace {

using namespace gxt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 4, kTW = 8;                      // output tile: rows x columns
constexpr int kM = kTH * kTW;                        // 32 output pixels, two row tiles
constexpr int kHH = 2 * kTH + 1, kHW = 2 * kTW + 1;  // 9 x 17 input halo
constexpr int kHP = kHH * kHW;                       // 153 halo pixels
constexpr int kHPad = 160;                           // padded to 10 row tiles of 16
constexpr int kEC = 64;                              // expanded channels a chunk
static_assert(kThreads / kEC == kTH, "the depthwise gives a thread one output row");
static_assert(kM == 2 * 16 && kWarps == 8, "the reduce: 2 row tiles x 4 column quarters");

__host__ __device__ constexpr int pad_to(int a, int m) { return (a + m - 1) / m * m; }

struct Args {
  const void* x;       // (B, H, W, C) at the compute dtype
  const void* wexp;    // f32: (Cp, Ep) row-major; bf16: (Ep, Cp) (transposed)
  const float* bexp;   // (Ep)
  const float* kdw;    // (9, Ep), row 3 di + dj
  const float* bdw;    // (Ep)
  const void* wred;    // f32: (Ep, Cw) row-major; bf16: (Cw, Ep) (transposed)
  const float* bred;   // (Cw)
  void* out;           // (B, H / 2, W / 2, Cout) at the compute dtype
  int B, H, W, Ho, Wo, C, Cp, Ep, Cout, Cw;
};

// Shared memory of a launch, in bytes: the x halo, the expanded chunk and
// the depthwise chunk, each rounded up to 16 bytes. Row strides keep the
// fragment loads of 8 rows x 4 lanes on 32 distinct banks: f32 rows of Cp + 4
// floats (Cp a multiple of 8) and chunks of 68; bf16 rows of ld_bank(Cp)
// elements (Cp a multiple of 16), the expanded chunk 72 and the depthwise
// chunk ld_bank(64). ops/fused_inverted_residual.py ir_s2_smem_bytes repeats
// the reckoning.
struct Layout {
  int Cp, ldx, lde, ldy;
  size_t xs, xe, y, bytes;
};

Layout layout(bool f32, int C) {
  Layout l;
  const int esz = f32 ? 4 : 2;
  if (f32) {
    l.Cp = pad_to(C, 8);
    l.ldx = l.Cp + 4;
    l.lde = l.ldy = kEC + 4;
  } else {
    l.Cp = pad16(C);
    l.ldx = ld_bank(l.Cp);
    l.lde = kEC + 8;
    l.ldy = ld_bank(kEC);
  }
  l.xs = pad_to(kHPad * l.ldx * esz, 16);
  l.xe = pad_to(kHP * l.lde * esz, 16);
  l.y = pad_to(kM * l.ldy * esz, 16);
  l.bytes = l.xs + l.xe + l.y;
  return l;
}

// n-tiles of 8 columns a warp reduces: four warps share the 16 output rows
// of a row tile, so Cout is covered in steps of 32 (Cw = 32 NTW), up to 256
int reduce_tiles(int Cout) {
  const int ntw = (Cout + 31) / 32;
  return Cout > 0 && ntw <= 8 ? ntw : 0;
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

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

// c += A . B for the 8 x 8 block of a row-major (K, ldb) f32 weight at p
// (rows t and t + 4 of column g), 3xTF32
__device__ __forceinline__ void mma_w(float (&c)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], const float* p, int ldb) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(__ldg(p), bh0, bl0);
  split_tf32(__ldg(p + 4 * ldb), bh1, bl1);
  mma_tf32x<true>(c, ah, al, bh0, bh1, bl0, bl1);
}

// the bf16 A fragments of the 16 x 16 block at p (row stride ld, elements)
__device__ __forceinline__ void a_bf16(const bf16* p, int ld, int g, int t, uint32_t (&a)[4]) {
  const bf16* r = p + g * ld + 2 * t;
  a[0] = lds32(r);
  a[1] = lds32(r + 8 * ld);
  a[2] = lds32(r + 8);
  a[3] = lds32(r + 8 * ld + 8);
}

template <bool kF32>
__device__ __forceinline__ float act(float z) {
  return kF32 ? silu(z) : silu_fast(z);
}

template <typename T, int NTW>
__global__ void __launch_bounds__(kThreads, 2) ir_s2_kernel(Args a, Layout lay) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const xs = reinterpret_cast<T*>(smem);                     // [160][ldx] x halo
  T* const xe = reinterpret_cast<T*>(smem + lay.xs);            // [153][lde] expanded chunk
  T* const ys = reinterpret_cast<T*>(smem + lay.xs + lay.xe);   // [32][ldy] depthwise chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int tiles_w = (a.Wo + kTW - 1) / kTW, tiles_h = (a.Ho + kTH - 1) / kTH;
  const int b = blockIdx.x / (tiles_w * tiles_h), tr = blockIdx.x % (tiles_w * tiles_h);
  const int oy0 = (tr / tiles_w) * kTH, ox0 = (tr % tiles_w) * kTW;
  const int iy0 = 2 * oy0 - 1, ix0 = 2 * ox0 - 1;   // the halo's first input row and column
  const int H = a.H, W = a.W, C = a.C, Cp = lay.Cp, Ep = a.Ep, ldx = lay.ldx;
  const int lde = lay.lde, ldy = lay.ldy;

  // 1. the halo of x, zero outside the image and in the padding
  const T* xb = static_cast<const T*>(a.x) + (size_t)b * H * W * C;
  for (int i = tid; i < kHPad * Cp; i += kThreads) {
    const int p = i / Cp, c = i - p * Cp;
    const int hy = iy0 + p / kHW, hx = ix0 + p % kHW;
    T v = from_f<T>(0.f);
    if (p < kHP && c < C && hy >= 0 && hy < H && hx >= 0 && hx < W)
      v = xb[((size_t)hy * W + hx) * C + c];
    xs[p * ldx + c] = v;
  }
  __syncthreads();

  // the reduce's accumulators: row tile rm (output pixels 16 rm ..), columns rn0 ..
  const int rm = warp & 1, rn0 = (warp >> 1) * NTW * 8;
  float acc[NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int e0 = 0; e0 < Ep; e0 += kEC) {
    // 2. expand the chunk: items of (row tile of 16 halo pixels, 16 columns)
    for (int item = warp; item < (kHPad / 16) * (kEC / 16); item += kWarps) {
      const int mt = item / (kEC / 16), n0 = (item % (kEC / 16)) * 16;
      float c2[2][4] = {};
      if constexpr (kF32) {
        const float* wx = static_cast<const float*>(a.wexp);
        for (int k0 = 0; k0 < Cp; k0 += 8) {
          uint32_t ah[4], al[4];
          a_frags(xs + mt * 16 * ldx + k0, ldx, g, t, ah, al);
          const float* bp = wx + (size_t)(k0 + t) * Ep + e0 + n0 + g;
          mma_w(c2[0], ah, al, bp, Ep);
          mma_w(c2[1], ah, al, bp + 8, Ep);
        }
      } else {
        const bf16* wx = static_cast<const bf16*>(a.wexp);
        for (int k0 = 0; k0 < Cp; k0 += 16) {
          uint32_t af[4];
          a_bf16(xs + mt * 16 * ldx + k0, ldx, g, t, af);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const bf16* bp = wx + (size_t)(e0 + n0 + nt * 8 + g) * Cp + k0 + 2 * t;
            mma_bf16(c2[nt], af[0], af[1], af[2], af[3], ldg32(bp), ldg32(bp + 8));
          }
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = mt * 16 + g + 8 * hf;
        if (p >= kHP) continue;
        const int hy = iy0 + p / kHW, hx = ix0 + p % kHW;
        const bool in = hy >= 0 && hy < H && hx >= 0 && hx < W;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = n0 + nt * 8 + 2 * t;
          float v0 = 0.f, v1 = 0.f;
          if (in) {
            v0 = act<kF32>(addf(c2[nt][2 * hf], a.bexp[e0 + col]));
            v1 = act<kF32>(addf(c2[nt][2 * hf + 1], a.bexp[e0 + col + 1]));
          }
          if constexpr (kF32)
            *reinterpret_cast<float2*>(xe + p * lde + col) = make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(xe + p * lde + col) = pack_bf16(v0, v1);
        }
      }
    }
    __syncthreads();

    // 3. the depthwise of the chunk at stride 2: a thread owns channel c and
    // output row oy, the nine taps into one accumulator in (di, dj) order
    {
      const int c = tid % kEC, oy = tid / kEC;
      float k[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) k[i] = a.kdw[i * Ep + e0 + c];
      const float bd = a.bdw[e0 + c];
#pragma unroll 2
      for (int ox = 0; ox < kTW; ++ox) {
        const T* w0 = xe + ((2 * oy) * kHW + 2 * ox) * lde + c;
        float s = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            const float v = to_f<T>(w0[(di * kHW + dj) * lde]);
            if constexpr (kF32)
              s = addf(s, mulf(v, k[3 * di + dj]));
            else
              s = fmaf(v, k[3 * di + dj], s);
          }
        }
        ys[(oy * kTW + ox) * ldy + c] = from_f<T>(act<kF32>(addf(s, bd)));
      }
    }
    __syncthreads();

    // 4. reduce the chunk into the accumulators (the next chunk's expand
    // writes xe only, and its depthwise writes ys after the next barrier)
    if constexpr (kF32) {
      const float* wr = static_cast<const float*>(a.wred);
#pragma unroll 2
      for (int k0 = 0; k0 < kEC; k0 += 8) {
        uint32_t ah[4], al[4];
        a_frags(ys + rm * 16 * ldy + k0, ldy, g, t, ah, al);
        const float* bp = wr + (size_t)(e0 + k0 + t) * a.Cw + rn0 + g;
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) mma_w(acc[nt], ah, al, bp + nt * 8, a.Cw);
      }
    } else {
      const bf16* wr = static_cast<const bf16*>(a.wred);
#pragma unroll
      for (int k0 = 0; k0 < kEC; k0 += 16) {
        uint32_t af[4];
        a_bf16(ys + rm * 16 * ldy + k0, ldy, g, t, af);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const bf16* bp = wr + (size_t)(rn0 + nt * 8 + g) * Ep + e0 + k0 + 2 * t;
          mma_bf16(acc[nt], af[0], af[1], af[2], af[3], ldg32(bp), ldg32(bp + 8));
        }
      }
    }
  }

  // 5. + bred, out
  T* ob = static_cast<T*>(a.out) + (size_t)b * a.Ho * a.Wo * a.Cout;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int op = rm * 16 + g + 8 * hf, oy = oy0 + op / kTW, ox = ox0 + op % kTW;
      if (oy >= a.Ho || ox >= a.Wo) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = rn0 + nt * 8 + 2 * t + j;
        if (c >= a.Cout) continue;
        ob[((size_t)oy * a.Wo + ox) * a.Cout + c] = from_f<T>(addf(acc[nt][2 * hf + j],
                                                                   a.bred[c]));
      }
    }
  }
}

template <typename T, int NTW>
int launch(const Args& a, const Layout& lay, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ir_s2_kernel<T, NTW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = a.B * ((a.Ho + kTH - 1) / kTH) * ((a.Wo + kTW - 1) / kTW);
  ir_s2_kernel<T, NTW><<<grid, kThreads, lay.bytes, stream>>>(a, lay);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, const Layout& lay, int ntw, cudaStream_t st) {
  switch (ntw) {
    case 1: return launch<T, 1>(a, lay, st);
    case 2: return launch<T, 2>(a, lay, st);
    case 3: return launch<T, 3>(a, lay, st);
    case 4: return launch<T, 4>(a, lay, st);
    case 5: return launch<T, 5>(a, lay, st);
    case 6: return launch<T, 6>(a, lay, st);
    case 7: return launch<T, 7>(a, lay, st);
    default: return launch<T, 8>(a, lay, st);
  }
}

}  // namespace

// Bytes of dynamic shared memory a launch at these widths needs (f32 != 0:
// the f32 kernel), -1 where the kernel does not take them (Cout past 256):
// the wrapper holds its own reckoning (ir_s2_smem_bytes) against it.
extern "C" long long gxt_ir_s2_smem(int f32, int C, int E, int Cout) {
  if (C <= 0 || E <= 0 || reduce_tiles(Cout) == 0) return -1;
  return (long long)layout(f32 != 0, C).bytes;
}

// x, out: NHWC at the compute dtype (f32 != 0: f32, else bf16), out (B, H / 2,
// W / 2, Cout). f32: wexp (pad8(C), pad64(E)) and wred (pad64(E), Cw)
// row-major; bf16: wexp (pad64(E), pad16(C)) and wred (Cw, pad64(E)),
// transposed; Cw = Cout rounded up to 32; bexp, bdw (pad64(E)), kdw (9,
// pad64(E)), bred (Cw) f32; zeros in every pad. H and W even; no residual.
extern "C" int gxt_ir_s2(int f32, const void* x, const void* wexp, const float* bexp,
                         const float* kdw, const float* bdw, const void* wred, const float* bred,
                         void* out, int B, int H, int W, int C, int E, int Cout, void* stream) {
  const int ntw = reduce_tiles(Cout);
  if (B < 0 || H < 0 || W < 0 || H % 2 || W % 2 || C <= 0 || E <= 0 || ntw == 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  Args a;
  a.x = x;
  a.wexp = wexp;
  a.bexp = bexp;
  a.kdw = kdw;
  a.bdw = bdw;
  a.wred = wred;
  a.bred = bred;
  a.out = out;
  a.B = B; a.H = H; a.W = W; a.Ho = H / 2; a.Wo = W / 2; a.C = C;
  const Layout lay = layout(f32 != 0, C);
  a.Cp = lay.Cp; a.Ep = pad_to(E, kEC); a.Cout = Cout; a.Cw = 32 * ntw;
  const cudaStream_t st = (cudaStream_t)stream;
  return f32 ? dispatch<float>(a, lay, ntw, st) : dispatch<bf16>(a, lay, ntw, st);
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
