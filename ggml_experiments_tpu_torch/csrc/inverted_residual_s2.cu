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
// rounded z * (1 / (1 + expf(-z))). At bf16 the products are bf16 wgmma
// with f32 sums, the taps are multiply-adds and the SiLUs use the hardware
// exp2 and reciprocal, denormals flushed (a few f32 ulps before each bf16
// rounding).
//
// Bound on an H100 (PERF.md, chip_smoke.py ir_bound): at bf16 the 2 SiLUs an
// expanded element (one at each input pixel, one at each output pixel) on
// the MUFU for the three widest blocks (layer_2[0] at B = 128: 335 M SiLUs,
// 0.080 ms), the 1x1 products for layer_5's; at f32 the 1x1 products as
// three tf32 products each (layer_2[0]: 25.8 GFLOP, 0.156 ms).
//
// Design (ir_hopper.cuh): a block of four warpgroups owns an 8 x 8 output
// tile (4 x 8 or 2 x 8 where the f32 halo of a wide C does not fit) and
// walks E in chunks of 64 (bf16) or 32 (f32): the 17 x 17 input halo by TMA
// (zero fill) once, split once into tf32 hi / lo at f32, 289 pixels
// expanded for 64 outputs (4.5 a pixel, where a 4 x 8 tile expands 4.8);
// Wexp^T's and Wred^T's K-major planes (tf32 hi / lo at f32, split once by
// ir_s2_operands) by bulk copy a chunk at a time, each landing while the
// other's products run; the expand (bf16 m64n32k16; tf32 m64n16k8 at f32)
// and the reduce (output channels x pixels: m64 tiles of Cout, up to 4) on
// wgmma with both operands in shared memory, the depthwise between them.
#include "ir_hopper.cuh"

namespace {

using namespace gxt;

template <typename T, int TH, int TW, int NCT>
__global__ void __launch_bounds__(128 * irh::warpgroups(TH, TW), 1)
    ir_s2_kernel(const __grid_constant__ irh::Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  irh::ir_tiles<T, 2, TH, TW, NCT>(p, align1024(smem_raw));
}

template <typename T, int TH, int TW, int NCT>
int launch(const irh::Params& p, cudaStream_t stream) {
  const auto fn = ir_s2_kernel<T, TH, TW, NCT>;
  const int threads = 128 * irh::warpgroups(TH, TW);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.l.bytes);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  const int code = irh::resident_blocks(fn, threads, p.l.bytes, p.total, grid);
  if (code) return code;
  ir_s2_kernel<T, TH, TW, NCT><<<grid, threads, p.l.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int NCT>
int by_tile(int tile, const irh::Params& p, cudaStream_t st) {
  switch (tile) {
    case 0: return launch<T, 8, 8, NCT>(p, st);
    case 1: return launch<T, 4, 8, NCT>(p, st);
    default: return launch<T, 2, 8, NCT>(p, st);
  }
}

template <typename T>
int dispatch(int nct, int tile, const irh::Params& p, cudaStream_t st) {
  switch (nct) {
    case 1: return by_tile<T, 1>(tile, p, st);
    case 2: return by_tile<T, 2>(tile, p, st);
    case 3: return by_tile<T, 3>(tile, p, st);
    default: return by_tile<T, 4>(tile, p, st);
  }
}

}  // namespace

// Bytes of dynamic shared memory a launch at these widths needs on the
// default tile (f32 != 0: the f32 kernel; the widest tile that fits a block,
// where none does the 2 x 8 tile's, past the limit), -1 where the kernel
// does not take them (Cout past 256): the wrapper holds its own reckoning
// (ir_s2_smem_bytes) against it.
extern "C" long long gxt_ir_s2_smem(int f32, int C, int E, int Cout) {
  if (C <= 0 || E <= 0 || Cout <= 0 || Cout > 256) return -1;
  irh::Layout l;
  irh::pick(l, f32 != 0, 2, C, Cout);
  return (long long)l.bytes;
}

// x: NHWC at the compute dtype (f32 != 0: f32, else bf16) with Cx channels
// (Cx >= C, Cx esz a multiple of 16 bytes, zero past C); out (B, H / 2,
// W / 2, Cout). wexp and wred: ir_s2_operands' K-major planes, per chunk of
// 32 (f32) or 64 (bf16) expanded channels; bexp, bdw (Ep), kdw (9, Ep), bred
// (pad64(Cout)) f32; zeros in every pad. H and W even; no residual.
extern "C" int gxt_ir_s2(int f32, const void* x, const void* wexp, const float* bexp,
                         const float* kdw, const float* bdw, const void* wred, const float* bred,
                         void* out, int B, int H, int W, int Cx, int E, int Cout, void* stream) {
  if (B < 0 || H < 0 || W < 0 || H % 2 || W % 2 || Cx <= 0 || Cx % (f32 ? 4 : 8) || E <= 0 ||
      Cout <= 0 || Cout > 256)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  irh::Layout l;
  const int tile = irh::pick(l, f32 != 0, 2, Cx, Cout);
  if (tile < 0) return (int)cudaErrorInvalidValue;
  irh::Params p;
  const int err = irh::params(p, l, f32 != 0, 2, x, wexp, bexp, kdw, bdw, wred, bred, out, B, H,
                              W, Cx, E, Cout, 0);
  if (err) return err;
  const int nct = (Cout + 63) / 64;
  const cudaStream_t st = (cudaStream_t)stream;
  return f32 ? dispatch<float>(nct, tile, p, st) : dispatch<bf16>(nct, tile, p, st);
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
