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
// Design (ir_hopper.cuh): a block of four warpgroups owns an output tile
// (8 x 16 where it fits, else 8 x 8 or 4 x 8) and walks E in chunks of 32:
// x's halo by TMA (zero fill), split once into tf32 hi / lo planes;
// Wexp^T's and Wred^T's tf32 hi / lo planes, split once on the host
// (ops/fused_inverted_residual.py ir_f32_operands), by bulk copy a chunk at
// a time; the expand (180 halo pixels for 128 outputs at 8 x 16)
// and the reduce on tf32 wgmma with both operands in shared memory, the
// depthwise between them from shared memory, the sums in registers.
#include "ir_hopper.cuh"

namespace {

using namespace gxt;

template <int TH, int TW, int NCT>
__global__ void __launch_bounds__(128 * irh::warpgroups(TH, TW), 1)
    ir_f32_kernel(const __grid_constant__ irh::Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  irh::ir_tiles<float, 1, TH, TW, NCT>(p, align1024(smem_raw));
}

template <int TH, int TW, int NCT>
int launch(const irh::Params& p, cudaStream_t stream) {
  const auto fn = ir_f32_kernel<TH, TW, NCT>;
  const int threads = 128 * irh::warpgroups(TH, TW);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.l.bytes);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  const int code = irh::resident_blocks(fn, threads, p.l.bytes, p.total, grid);
  if (code) return code;
  ir_f32_kernel<TH, TW, NCT><<<grid, threads, p.l.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NCT>
int dispatch(int tile, const irh::Params& p, cudaStream_t st) {
  switch (tile) {
    case 0: return launch<8, 16, NCT>(p, st);
    case 1: return launch<8, 8, NCT>(p, st);
    default: return launch<4, 8, NCT>(p, st);
  }
}

}  // namespace

// Bytes of dynamic shared memory of a launch at these widths on the default
// tile (the widest that fits a block; where none does, the 4 x 8 tile's, past
// the limit), -1 where the kernel does not take the widths (Cout past 128):
// the wrapper holds its own reckoning (ir_f32_smem_bytes) against it.
extern "C" long long gxt_ir_f32_smem(int C, int E, int Cout) {
  if (C <= 0 || E <= 0 || Cout <= 0 || Cout > 128) return -1;
  irh::Layout l;
  irh::pick(l, true, 1, C, Cout);
  return (long long)l.bytes;
}

// x: NHWC f32 with Cx channels (Cx >= C, a multiple of 4: TMA's 16-byte
// strides; zero past C); out: NHWC f32 with Cout channels. wexp and wred:
// ir_f32_operands' tf32 planes, per chunk of 32 expanded channels; bexp,
// bdw (pad32(E)), kdw (9, pad32(E)), bred (pad64(Cout)) f32, zero in every
// pad. Stride 1; residual needs C == Cout.
extern "C" int gxt_ir_f32(const float* x, const void* wexp, const float* bexp, const float* kdw,
                          const float* bdw, const void* wred, const float* bred, float* out,
                          int B, int H, int W, int Cx, int E, int Cout, int residual,
                          void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (Cx <= 0 || Cx % 4 || E <= 0 || Cout <= 0 || Cout > 128 || (residual && Cx < Cout))
    return (int)cudaErrorInvalidValue;
  irh::Layout l;
  const int tile = irh::pick(l, true, 1, Cx, Cout);
  if (tile < 0) return (int)cudaErrorInvalidValue;
  irh::Params p;
  const int err = irh::params(p, l, true, 1, x, wexp, bexp, kdw, bdw, wred, bred, out, B, H, W,
                              Cx, E, Cout, residual);
  if (err) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  return Cout <= 64 ? dispatch<1>(tile, p, st) : dispatch<2>(tile, p, st);
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
