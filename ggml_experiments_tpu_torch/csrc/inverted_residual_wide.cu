// MobileNetV2 inverted residual at bf16, stride 1, at the widths the strip
// kernel (inverted_residual.cu) does not take: C or Cout not a multiple of 8,
// C past 64, E past 256, or weights and rings past its block. Expand 1x1
// (folded BN, SiLU) -> depthwise 3x3 over a zero ring (folded BN, SiLU) ->
// reduce 1x1 (+ folded bias, + residual).
//
//   gxt_ir_wide  replaces, for those widths, ggml_experiments_tpu/ops/
//                fused_inverted_residual.py `fused_inverted_residual`
//                (pallas_call :146; body `_ir_kernel` :44)
//
// What it computes, rounding where the TPU body does at bf16: ex = x.Wexp
// summed in f32 on bf16 operands, SiLU(ex + bexp) -> bf16, zeros after the
// SiLU on the ring; the depthwise in f32 over the rounded expanded values
// with f32 taps, for each column tap dj the three row taps di in order, then
// the three column sums in order (each product and sum rounded on its own,
// no multiply-add contracted), SiLU(acc + bdw) -> bf16; out = y.Wred + bred
// in f32, + x in f32 with the residual, -> bf16. The products are bf16 wgmma
// with f32 sums, each chunk of 64 expanded channels a sum of its own added in
// f32; the SiLUs use the hardware exp2 and reciprocal (a few f32 ulps before
// each bf16 rounding).
//
// Bound on an H100 (chip_smoke.py ir_bound): the 2 SiLUs an expanded element
// on the MUFU at (B, H, W, C, E, Cout) = (128, 64, 64, 64, 384, 64) (403 M
// SiLUs, 0.096 ms), ahead of the tensor cores' 1x1 products and the bytes.
//
// Design (ir_hopper.cuh, the stride-1 tiles of the f32 instantiation with the
// bf16 chunk of 64 expanded channels and the bf16 epilogues of the stride-2
// one): a block of four warpgroups owns an 8 x 16, 8 x 8 or 4 x 8 output tile
// and walks E in chunks of 64: x's halo by TMA (zero fill; C padded with
// zero channels to a multiple of 8 by the wrapper, TMA's 16-byte strides),
// Wexp^T's and Wred^T's K-major planes by bulk copy a chunk at a time, the
// expand and the reduce on bf16 wgmma with the depthwise between them, the
// residual read from x in global memory. A warpgroup's reduce holds its
// sums of up to four m64 tiles of output channels in registers (two at the
// 8 x 16 tile, where a warpgroup's share of the pixels is 32): a wider Cout
// runs in passes, each a launch over its own output channels that expands
// the halo again (ops/fused_inverted_residual.py ir_wide_plan picks the
// tile and the pass width that cost the fewest expanded pixels). Past C =
// 768 a chunk of Wexp^T no longer fits beside x's halo even on the 4 x 8
// tile: there its buffer holds wsl slabs of 64 input channels and each
// chunk's Wexp^T comes in pieces (ir_hopper.cuh kPieces), up to the C whose
// halo alone leaves no room (about 1500).
#include "ir_hopper.cuh"

namespace {

using namespace gxt;

// the stride-1 tiles, widest first (ops/fused_inverted_residual.py
// IR_TC_TILES[1]), and the m64 tiles of output channels a pass takes on each
constexpr int kMaxNct[3] = {2, 4, 4};

template <int TH, int TW, int NCT, bool PIECES>
__global__ void __launch_bounds__(128 * irh::warpgroups(TH, TW), 1)
    ir_wide_kernel(const __grid_constant__ irh::Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  irh::ir_tiles<bf16, 1, TH, TW, NCT, PIECES>(p, align1024(smem_raw));
}

template <int TH, int TW, int NCT, bool PIECES = false>
int launch(const irh::Params& p, cudaStream_t stream) {
  const auto fn = ir_wide_kernel<TH, TW, NCT, PIECES>;
  const int threads = 128 * irh::warpgroups(TH, TW);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.l.bytes);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  const int code = irh::resident_blocks(fn, threads, p.l.bytes, p.total, grid);
  if (code) return code;
  fn<<<grid, threads, p.l.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// Wexp^T in pieces on the 4 x 8 tile alone (the only one that fits past C =
// 768)
template <int NCT>
int by_tile(int tile, const irh::Params& p, cudaStream_t st) {
  const bool pieces = p.l.wsl < p.l.slabs;
  switch (tile) {
    case 0: if constexpr (NCT <= kMaxNct[0]) if (!pieces) return launch<8, 16, NCT>(p, st); break;
    case 1: if (!pieces) return launch<8, 8, NCT>(p, st); break;
    case 2: return pieces ? launch<4, 8, NCT, true>(p, st) : launch<4, 8, NCT>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(int nct, int tile, const irh::Params& p, cudaStream_t st) {
  switch (nct) {
    case 1: return by_tile<1>(tile, p, st);
    case 2: return by_tile<2>(tile, p, st);
    case 3: return by_tile<3>(tile, p, st);
    case 4: return by_tile<4>(tile, p, st);
  }
  return (int)cudaErrorInvalidValue;
}

bool takes(int tile, int cx, int ncp, int wsl, irh::Layout& l) {
  if (tile < 0 || tile > 2 || cx <= 0 || ncp <= 0 || ncp % 64 || ncp / 64 > kMaxNct[tile] ||
      wsl <= 0)
    return false;
  l = irh::layout(false, 1, irh::kTiles1[tile][0], irh::kTiles1[tile][1], cx, ncp, wsl);
  return l.wsl == l.slabs || tile == 2;
}

}  // namespace

// Bytes of dynamic shared memory of a launch on stride-1 tile `tile` (0 8 x
// 16, 1 8 x 8, 2 4 x 8) with Cx input channels, passes of ncp output
// channels (a multiple of 64) and wsl slabs of Wexp^T's K in its buffer
// (fewer than the slabs of Cx on the 4 x 8 tile only), -1 where the kernel
// does not take them: the wrapper holds its own reckoning
// (ir_wide_smem_bytes) against it.
extern "C" long long gxt_ir_wide_smem(int tile, int Cx, int ncp, int wsl) {
  irh::Layout l;
  return takes(tile, Cx, ncp, wsl, l) ? (long long)l.bytes : -1;
}

// x: NHWC bf16 with Cx channels (Cx >= C, a multiple of 8, zero past C); out
// NHWC bf16 with Cout channels. wexp: per chunk of 64 expanded channels the
// K-major plane of Wexp^T; wred: per pass of ncp output channels, per chunk,
// Wred^T's plane of the pass's rows (ir_wide_operands); bexp, bdw (pad64(E)),
// kdw (9, pad64(E)), bred (passes x ncp) f32, zero in every pad. Residual
// needs C == Cout. wsl: gxt_ir_wide_smem's.
extern "C" int gxt_ir_wide(const void* x, const void* wexp, const float* bexp, const float* kdw,
                           const float* bdw, const void* wred, const float* bred, void* out,
                           int B, int H, int W, int Cx, int E, int Cout, int residual, int tile,
                           int ncp, int wsl, void* stream) {
  if (B < 0 || H < 0 || W < 0 || Cx % 8 || E <= 0 || Cout <= 0 || (residual && Cx < Cout))
    return (int)cudaErrorInvalidValue;
  irh::Layout l;
  if (!takes(tile, Cx, ncp, wsl, l) || l.bytes > irh::kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  const int passes = (Cout + ncp - 1) / ncp, nch = (E + 63) / 64;
  const size_t pass_bytes = (size_t)nch * ncp * 128;   // Wred^T's planes of one pass
  const cudaStream_t st = (cudaStream_t)stream;
  for (int ps = 0; ps < passes; ++ps) {
    const int co0 = ps * ncp, cout = Cout - co0 < ncp ? Cout - co0 : ncp;
    irh::Params p;
    int err = irh::params(p, l, false, 1, x, wexp, bexp, kdw, bdw,
                          static_cast<const unsigned char*>(wred) + ps * pass_bytes,
                          bred + co0, out, B, H, W, Cx, E, cout, residual);
    if (err) return err;
    p.co0 = co0;
    p.ldo = Cout;
    if ((err = dispatch((cout + 63) / 64, tile, p, st))) return err;
  }
  return 0;
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
