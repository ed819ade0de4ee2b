// Fused GRU training sequence: the time loop of the forward pass in one
// cooperative launch, the time loop of the backward pass in another, and
// the recurrent weight gradient as a GEMM launched after it.
//
//   gxt_gru_train_fwd  replaces ggml_experiments_tpu/ops/fused_gru_train.py
//                      `_fwd_core_call` (pallas_call :186; body `_fwd_kernel`
//                      :54, `_gates` :45)
//   gxt_gru_train_bwd  replaces the same file's `_bwd_core_call` (pallas_call
//                      :285; body `_bwd_kernel` :81) without its dWr sum
//   gxt_gru_train_dwr  the dWr sum of `_bwd_kernel` (:140-144)
//
// Arithmetic, as the TPU bodies have it (bf16 storage, f32 sums and gate
// math): forward, per step, mh = h.Wr + b_rec is summed in f32, rounded to
// bf16 and stored; the gates use the ROUNDED mh; h' = z*h + (1-z)*g is
// rounded to bf16 and is both the output and the next step's operand.
// Backward, time reversed: gates rebuilt from the stored mx and mh;
// dh = dy + carry (f32); dmx = [daz, dar, da] and dmh = [daz, dar, da*r]
// rounded to bf16; carry = dh*z + dmh.Wr^T (f32); db_rec = sum over (t, b)
// of the unrounded dmh (f32); dh0 is the last carry. dWr = sum over (t, b) of
// h_prev^T . dmh (f32). Every product runs on wgmma (bf16 in, f32 sums).
//
// Bound on an H100 at the training shape (T=100, B=1024, U=1024): forward
// 2*T*B*U*3U = 0.64 TFLOP against 1.47 GB streamed, so the operations bound
// it (0.65 ms at the bf16 tensor-core peak); backward twice the operations.
//
// The TPU kernel keeps all of Wr in one core's VMEM and walks the batch and
// the steps in order. A Hopper block has 227 KB, so the grid is cut two ways:
// block (r, g) owns row tile r of the batch and unit group g (ub = 8, 16 or
// 32 hidden units) for the whole launch. ops/fused_gru_train.py `train_plan`
// picks (ub, R); R x U/ub blocks are co-resident (cooperative launch). Row
// tiles are independent recurrences: the blocks of one row tile meet at a
// release/acquire counter in global memory once a step, never the grid.
//   * forward: the block keeps its 3ub gate columns of Wr resident in shared
//     memory, ordered [unit group of 8][gate][unit] so that wgmma's
//     accumulator hands a lane all three gates of its (row, unit) pairs. A
//     producer warp streams h_{t-1} (the previous step's y, or h0) of the
//     tile's rows by TMA (128 rows x 64 K a copy, 128-byte swizzle) through
//     a ring of `stages` buffers; two consumer warpgroups run m64 x 3ub
//     wgmma on it, then round mh, compute the gates and write y and mh.
//   * backward: the block keeps its ub ROWS of Wr resident (the B operand of
//     the carry product, K = 3U). A step is a gate phase (elementwise over
//     the tile's rows and the block's units: writes dmx, the rounded third
//     gate da*r into a (T, B, U) plane, and dh*z into the f32 carry), the
//     row-tile barrier, then carry += dmh.Wr[own units]^T with dmh = [dmx[t]
//     columns 0..2U | plane[t]] streamed by TMA. db_rec is summed per thread,
//     per block in thread order, then over the row tiles in order after one
//     grid sync.
//   * dWr: M = U, N = 3U, K = T*B, both operands MN-major (rows of h_prev and
//     of dmh are K), read by TMA straight from [h0; ys] and [dmx | plane]; a
//     block owns a 128 x 192 tile of dWr and walks all of K in (t, b) order,
//     the tensor cores summing runs of 16384 K rows that are added into dWr
//     in f32 (one chain of T*B tensor-core additions strayed 1e-4 of the
//     largest entry from the f64 sum at T*B = 102,400 on an H100; PERF.md).
// Global writes that another block reads by TMA (the async proxy) are
// followed by fence.proxy.async before the counter's release; the reader
// acquires and fences before it issues the copy. No atomics on values and no
// order that depends on timing: two launches give the same bits.
//
// The K index space of the carry product and of dWr's N is [dmx columns
// 0..2U) padded to 2*U2 (U2 = U rounded up to 32, so every 64-wide TMA box
// lies in one source), then the plane's U columns; the padding reads zeros.
// Shapes: U a multiple of 8 (16-byte rows for TMA), any B >= 1.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gxt;

typedef __nv_bfloat16 bf16;

constexpr int kConsumerWarps = 8;                  // two warpgroups
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;          // and one producer warp
constexpr int kChunkRows = 128;                    // rows of one recurrence TMA copy
constexpr int kTileBytes = kChunkRows * 128;       // 128 rows x 64 K bf16
constexpr int kMaxStages = 8;
constexpr int kDM = 128, kDN = 192, kDK = 64;      // dWr block tile and K rows a stage
constexpr int kDStageBytes = (kDM + kDN) * kDK * 2;
constexpr int kDStages = 5;
constexpr int kDFlush = 256;                       // dWr stages a tensor-core run sums

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
// K (carry product) and N (dWr) index space: dmx columns padded to ka(U), then the plane
__host__ __device__ inline int ka_of(int U) { return 2 * round_up(U, 32); }
__host__ __device__ inline int kc_fwd(int U) { return (U + 63) / 64; }
__host__ __device__ inline int kc_bwd(int U) { return (ka_of(U) + U + 63) / 64; }

size_t wr_bytes(int part, int ub, int U) {
  return part == 0 ? (size_t)kc_fwd(U) * 3 * ub * 128 : (size_t)kc_bwd(U) * ub * 128;
}
size_t smem_bytes(int part, int ub, int U, int stages) {
  if (part == 2) return 1024 + (size_t)stages * (kDStageBytes + 16);
  return 1024 + wr_bytes(part, ub, U) + (size_t)stages * (kTileBytes + 16);
}

// f32 gate arithmetic with every rounding written out, so that the compiler
// contracts no multiply-add: the plain version rounds after each operation.
__device__ __forceinline__ float mulf(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float addf(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float subf(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
  return lo | (hi << 16);
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  f[0] = lo_f(v.x); f[1] = hi_f(v.x); f[2] = lo_f(v.y); f[3] = hi_f(v.y);
  f[4] = lo_f(v.z); f[5] = hi_f(v.z); f[6] = lo_f(v.w); f[7] = hi_f(v.w);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// NJ consecutive 32-bit words (two bf16 each) at p, one access
template <int NJ>
__device__ __forceinline__ void ld_words(const void* p, uint32_t (&v)[NJ], bool l2_only) {
  if constexpr (NJ == 4) {
    const uint4 x = l2_only ? __ldcg(reinterpret_cast<const uint4*>(p))
                            : __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (NJ == 2) {
    const uint2 x = l2_only ? __ldcg(reinterpret_cast<const uint2*>(p))
                            : __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = l2_only ? __ldcg(reinterpret_cast<const unsigned*>(p))
                   : __ldg(reinterpret_cast<const unsigned*>(p));
  }
}
template <int NJ>
__device__ __forceinline__ void st_words(void* p, const uint32_t (&v)[NJ]) {
  if constexpr (NJ == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (NJ == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = v[0];
  }
}

// ---------------------------------------------------------------------------
// shared memory, barriers, TMA, wgmma
// ---------------------------------------------------------------------------

// one TMA copy of a box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm, int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy global writes and async-proxy (TMA) reads of them, ordered
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// the row tile's step counter: each block adds one when its step's writes
// are out; a block waits until every block of its tile has
__device__ __forceinline__ void tile_arrive(unsigned* ctr) {
  __threadfence();
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(ctr) : "memory");
}
__device__ __forceinline__ void tile_wait(const unsigned* ctr, unsigned target) {
  unsigned v;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(ctr) : "memory");
  } while (v < target);
  __threadfence();
}

// d (64 x N, f32, the warpgroup's fragment) += a (64 x 16) . b (16 x N);
// scale_d == 0 overwrites d instead. Lane (warp w of the group, g = lane / 4,
// q = lane % 4) holds rows 16w + g (+8) and columns 8j + 2q (+1) in
// d[4j + {0, 1}] and d[4j + {2, 3}].
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n24(float (&d)[12], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n48(float (&d)[24], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64_mn(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 8) wgmma_n8(d, da, db, scale_d);
  else if constexpr (N == 16) wgmma_n16(d, da, db, scale_d);
  else if constexpr (N == 24) wgmma_n24(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_n32(d, da, db, scale_d);
  else if constexpr (N == 48) wgmma_n48(d, da, db, scale_d);
  else wgmma_n96(d, da, db, scale_d);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  CUtensorMap tm_h0;  // h0 as (1, B, U), box (64, MC, 1)
  CUtensorMap tm_ys;  // ys (T, B, U), same box
  const bf16* mxs;    // (T, B, 3U)
  const bf16* h0;     // (B, U)
  const bf16* wr;     // (U, 3U)
  const float* brec;  // (3U)
  bf16* ys;           // (T, B, U) out
  bf16* mhs;          // (T, B, 3U) out
  unsigned* ctr;      // (R) zeros: the row tiles' step counters
  int T, B, U, BR, MC, stages;
};

template <int UB>
__global__ void __launch_bounds__(kThreads, 1) gru_train_fwd_kernel(const __grid_constant__ FwdArgs a) {
  constexpr int N = 3 * UB, NJ = UB / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int T = a.T, B = a.B, U = a.U, G = 3 * U, S = a.stages, MC = a.MC;
  const int KC = kc_fwd(U);
  unsigned char* wr_s = base;                                   // KC tiles of (N, 64)
  unsigned char* ring = wr_s + (size_t)KC * N * 128;            // S tiles of (128, 64)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)S * kTileBytes);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int NG = U / UB, g = blockIdx.x % NG, r = blockIdx.x / NG;
  const int unit0 = g * UB;
  const int row0 = r * a.BR, row_end = min(B, row0 + a.BR);
  const int nchunks = (row_end - row0 + MC - 1) / MC;

  // column n = 8 j + c of the product (j = 3 jj + gate, c = 2 q + e) is gate
  // `gate` of unit 2 NJ q + 2 jj + e: wgmma's lane q then holds all three
  // gates of 2 NJ consecutive units (one vector access a gate and row)
  for (int i = tid; i < KC * 64 * N; i += kThreads) {
    const int kk = i / N, n = i % N, kc = kk >> 6;
    const int j = n >> 3, c = n & 7;
    const int col = (j % 3) * U + unit0 + 2 * NJ * (c >> 1) + 2 * (j / 3) + (c & 1);
    *reinterpret_cast<bf16*>(wr_s + (size_t)kc * N * 128 + swz(n, kk & 63)) =
        kk < U ? a.wr[(size_t)kk * G + col] : __float2bfloat16_rn(0.f);
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_init_fence();
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wr_s, for wgmma
  // the lane's units unit0 + 2 NJ tq + 2 jj (+1) of each gate
  const int ul = unit0 + 2 * NJ * tq;
  float br[3][NJ][2];
#pragma unroll
  for (int gt = 0; gt < 3; ++gt)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      br[gt][j][0] = a.brec[gt * U + ul + 2 * j];
      br[gt][j][1] = a.brec[gt * U + ul + 2 * j + 1];
    }
  __syncthreads();

  int it = 0;  // ring position: the producer and the consumers walk the same sequence
  for (int t = 0; t < T; ++t) {
    if (t > 0 && tid == 0) tile_wait(a.ctr + r, (unsigned)(NG * t));
    __syncthreads();
    if (warp == kConsumerWarps) {
      if (lane == 0) {
        fence_proxy_global();
        const CUtensorMap* tm = t == 0 ? &a.tm_h0 : &a.tm_ys;
        const int tz = t == 0 ? 0 : t - 1;
        for (int c = 0; c < nchunks; ++c)
          for (int kc = 0; kc < KC; ++kc, ++it) {
            const int s = it % S;
            if (it >= S) mbar_wait(empty + s, (it / S - 1) & 1);
            mbar_expect(full + s, MC * 128);
            tma_load(ring + (size_t)s * kTileBytes, tm, 64 * kc, row0 + c * MC, tz, full + s);
          }
      }
    } else {
      const int wg = warp >> 2, wq = warp & 3;
      const bool active = 64 * wg < MC;
      const bf16* hp = t == 0 ? a.h0 : a.ys + (size_t)(t - 1) * B * U;
      const bf16* mx = a.mxs + (size_t)t * B * G;
      bf16* mh = a.mhs + (size_t)t * B * G;
      bf16* yo = a.ys + (size_t)t * B * U;
      for (int c = 0; c < nchunks; ++c) {
        const int rb = row0 + c * MC + 64 * wg + 16 * wq + gq;
        // this lane's operands of the gate math, asked for before the products
        uint32_t mxv[2][3][NJ], hv[2][NJ];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = rb + 8 * hf;
          if (active && row < row_end) {
#pragma unroll
            for (int gt = 0; gt < 3; ++gt)
              ld_words<NJ>(mx + (size_t)row * G + gt * U + ul, mxv[hf][gt], false);
            ld_words<NJ>(hp + (size_t)row * U + ul, hv[hf], true);
          }
        }
        float d[N / 2];
#pragma unroll
        for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
        for (int kc = 0; kc < KC; ++kc, ++it) {
          const int s = it % S;
          mbar_wait(full + s, (it / S) & 1);
          if (active) {
            const uint32_t at = smem_u32(ring + (size_t)s * kTileBytes + wg * 64 * 128);
            const uint32_t bt = smem_u32(wr_s + (size_t)kc * N * 128);
            wg_fence();
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma<N>(d, desc_k(at + 32 * ks), desc_k(bt + 32 * ks), kc > 0 || ks > 0);
            wg_commit();
            wg_wait<0>();
            wg_pin(d);
          }
          if (lane == 0) mbar_arrive(empty + s);
        }
        if (!active) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = rb + 8 * hf;
          if (row >= row_end) continue;
          uint32_t mhv[3][NJ], yv[NJ];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int gt = 0; gt < 3; ++gt) {
              const int i = 4 * (3 * j + gt) + 2 * hf;
              mhv[gt][j] = pack_bf16(addf(d[i], br[gt][j][0]), addf(d[i + 1], br[gt][j][1]));
            }
            float hn[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float mxz = e ? hi_f(mxv[hf][0][j]) : lo_f(mxv[hf][0][j]);
              const float mxr = e ? hi_f(mxv[hf][1][j]) : lo_f(mxv[hf][1][j]);
              const float mxh = e ? hi_f(mxv[hf][2][j]) : lo_f(mxv[hf][2][j]);
              const float mhz = e ? hi_f(mhv[0][j]) : lo_f(mhv[0][j]);
              const float mhr = e ? hi_f(mhv[1][j]) : lo_f(mhv[1][j]);
              const float mhh = e ? hi_f(mhv[2][j]) : lo_f(mhv[2][j]);
              const float hprev = e ? hi_f(hv[hf][j]) : lo_f(hv[hf][j]);
              const float z = sigmoidf(addf(mxz, mhz));
              const float rr = sigmoidf(addf(mxr, mhr));
              const float gg = tanhf(addf(mxh, mulf(rr, mhh)));
              hn[e] = addf(mulf(z, hprev), mulf(subf(1.f, z), gg));
            }
            yv[j] = pack_bf16(hn[0], hn[1]);
          }
#pragma unroll
          for (int gt = 0; gt < 3; ++gt) st_words<NJ>(mh + (size_t)row * G + gt * U + ul, mhv[gt]);
          st_words<NJ>(yo + (size_t)row * U + ul, yv);
        }
      }
      fence_proxy_global();
    }
    __syncthreads();
    if (tid == 0 && t + 1 < T) tile_arrive(a.ctr + r);
  }
}

// ---------------------------------------------------------------------------
// backward recurrence
// ---------------------------------------------------------------------------

struct BwdArgs {
  CUtensorMap tm_dmx;  // dmxs (T, B, 3U) seen as (T, B, 2U), box (64, MC, 1)
  CUtensorMap tm_pl;   // plane (T, B, U), same box
  const bf16* mxs;     // (T, B, 3U)
  const bf16* mhs;     // (T, B, 3U)
  const bf16* ys;      // (T, B, U)
  const bf16* dys;     // (T, B, U)
  const bf16* h0;      // (B, U)
  const bf16* wr;      // (U, 3U)
  bf16* dmxs;          // (T, B, 3U) out
  bf16* plane;         // (T, B, U) out: round(da * r)
  float* dbrec;        // (3U) out
  float* dbpart;       // (R, 3U) scratch: each row tile's db_rec
  float* dh0;          // (B, U) out; the carry during the launch
  unsigned* ctr;       // (R) zeros
  int T, B, U, BR, MC, stages;
};

template <int UB>
__global__ void __launch_bounds__(kThreads, 1) gru_train_bwd_kernel(const __grid_constant__ BwdArgs a) {
  constexpr int NJ = UB / 8;
  constexpr int QB = UB / 8;                 // 8-unit groups a row: threads per row in the gate phase
  constexpr int SLOTS = kConsumers / QB;     // rows the gate phase takes at once
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int T = a.T, B = a.B, U = a.U, G = 3 * U, S = a.stages, MC = a.MC;
  const int KA = ka_of(U), KC = kc_bwd(U);
  unsigned char* wr_s = base;                                   // KC tiles of (UB, 64)
  unsigned char* ring = wr_s + (size_t)KC * UB * 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)S * kTileBytes);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int NG = U / UB, g = blockIdx.x % NG, r = blockIdx.x / NG;
  const int unit0 = g * UB;
  const int row0 = r * a.BR, row_end = min(B, row0 + a.BR);
  const int nchunks = (row_end - row0 + MC - 1) / MC;

  // row n = 8 j + c of tile kc (c = 2 q + e): Wr[unit0 + 2 NJ q + 2 j + e][column of K
  // index 64 kc + k], so that wgmma's lane q holds the carry of 2 NJ consecutive units
  for (int i = tid; i < UB * KC * 64; i += kThreads) {
    const int n = i / (KC * 64), kk = i % (KC * 64);
    const int unit = unit0 + 2 * NJ * ((n & 7) >> 1) + 2 * (n >> 3) + (n & 1);
    const int col = kk < 2 * U ? kk : (kk >= KA && kk < KA + U ? 2 * U + kk - KA : -1);
    *reinterpret_cast<bf16*>(wr_s + (size_t)(kk >> 6) * UB * 128 + swz(n, kk & 63)) =
        col >= 0 ? a.wr[(size_t)unit * G + col] : __float2bfloat16_rn(0.f);
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_init_fence();
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // db_rec partial sums of this thread's rows (its 8-unit group q), every step
  const int q = tid % QB, slot = tid / QB;
  float sb[3][8];
#pragma unroll
  for (int gt = 0; gt < 3; ++gt)
#pragma unroll
    for (int ul = 0; ul < 8; ++ul) sb[gt][ul] = 0.f;
  __syncthreads();

  int it = 0;
  for (int t = T - 1; t >= 0; --t) {
    // ---- gate phase: 8 units (group q) of one row a thread
    if (warp < kConsumerWarps) {
      const bf16* mx = a.mxs + (size_t)t * B * G;
      const bf16* mh = a.mhs + (size_t)t * B * G;
      const bf16* hp = t == 0 ? a.h0 : a.ys + (size_t)(t - 1) * B * U;
      const bf16* dy = a.dys + (size_t)t * B * U;
      bf16* dmx = a.dmxs + (size_t)t * B * G;
      bf16* pl = a.plane + (size_t)t * B * U;
      for (int b = row0 + slot; b < row_end; b += SLOTS) {
        const int u0 = unit0 + 8 * q;
        const size_t og = (size_t)b * G + u0, ou = (size_t)b * U + u0;
        float mxf[3][8], mhf[3][8], hpf[8], dyf[8], cf[8];
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) {
          unpack8(__ldg(reinterpret_cast<const uint4*>(mx + og + gt * U)), mxf[gt]);
          unpack8(__ldg(reinterpret_cast<const uint4*>(mh + og + gt * U)), mhf[gt]);
        }
        unpack8(__ldg(reinterpret_cast<const uint4*>(hp + ou)), hpf);
        unpack8(__ldg(reinterpret_cast<const uint4*>(dy + ou)), dyf);
        if (t == T - 1) {
#pragma unroll
          for (int ul = 0; ul < 8; ++ul) cf[ul] = 0.f;
        } else {
          const float4 c0 = __ldcg(reinterpret_cast<const float4*>(a.dh0 + ou));
          const float4 c1 = __ldcg(reinterpret_cast<const float4*>(a.dh0 + ou) + 1);
          cf[0] = c0.x; cf[1] = c0.y; cf[2] = c0.z; cf[3] = c0.w;
          cf[4] = c1.x; cf[5] = c1.y; cf[6] = c1.z; cf[7] = c1.w;
        }
        float ox[3][8], dah[8], cz[8];
#pragma unroll
        for (int ul = 0; ul < 8; ++ul) {
          const float z = sigmoidf(addf(mxf[0][ul], mhf[0][ul]));
          const float rr = sigmoidf(addf(mxf[1][ul], mhf[1][ul]));
          const float mhh = mhf[2][ul];
          const float gg = tanhf(addf(mxf[2][ul], mulf(rr, mhh)));
          const float dh = addf(dyf[ul], cf[ul]);
          const float dz = mulf(dh, subf(hpf[ul], gg));
          const float da = mulf(mulf(dh, subf(1.f, z)), subf(1.f, mulf(gg, gg)));
          const float dr = mulf(da, mhh);
          const float daz = mulf(mulf(dz, z), subf(1.f, z));
          const float dar = mulf(mulf(dr, rr), subf(1.f, rr));
          ox[0][ul] = daz; ox[1][ul] = dar; ox[2][ul] = da;
          dah[ul] = mulf(da, rr);
          sb[0][ul] = addf(sb[0][ul], daz);
          sb[1][ul] = addf(sb[1][ul], dar);
          sb[2][ul] = addf(sb[2][ul], dah[ul]);
          cz[ul] = mulf(dh, z);
        }
#pragma unroll
        for (int gt = 0; gt < 3; ++gt)
          *reinterpret_cast<uint4*>(dmx + og + gt * U) = pack8(ox[gt]);
        *reinterpret_cast<uint4*>(pl + ou) = pack8(dah);
        float4* cp = reinterpret_cast<float4*>(a.dh0 + ou);
        cp[0] = make_float4(cz[0], cz[1], cz[2], cz[3]);
        cp[1] = make_float4(cz[4], cz[5], cz[6], cz[7]);
      }
      fence_proxy_global();
    }
    __syncthreads();
    if (tid == 0) {
      tile_arrive(a.ctr + r);
      tile_wait(a.ctr + r, (unsigned)(NG * (T - t)));
    }
    __syncthreads();

    // ---- carry[rows, own units] += dmh[rows, 0:3U] . Wr[own units]^T
    if (warp == kConsumerWarps) {
      if (lane == 0) {
        fence_proxy_global();
        for (int c = 0; c < nchunks; ++c)
          for (int kc = 0; kc < KC; ++kc, ++it) {
            const int s = it % S, k = 64 * kc;
            if (it >= S) mbar_wait(empty + s, (it / S - 1) & 1);
            mbar_expect(full + s, MC * 128);
            tma_load(ring + (size_t)s * kTileBytes, k < KA ? &a.tm_dmx : &a.tm_pl,
                     k < KA ? k : k - KA, row0 + c * MC, t, full + s);
          }
      }
    } else {
      const int wg = warp >> 2, wq = warp & 3;
      const bool active = 64 * wg < MC;
      for (int c = 0; c < nchunks; ++c) {
        float d[UB / 2];
#pragma unroll
        for (int i = 0; i < UB / 2; ++i) d[i] = 0.f;
        for (int kc = 0; kc < KC; ++kc, ++it) {
          const int s = it % S;
          mbar_wait(full + s, (it / S) & 1);
          if (active) {
            const uint32_t at = smem_u32(ring + (size_t)s * kTileBytes + wg * 64 * 128);
            const uint32_t bt = smem_u32(wr_s + (size_t)kc * UB * 128);
            wg_fence();
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma<UB>(d, desc_k(at + 32 * ks), desc_k(bt + 32 * ks), kc > 0 || ks > 0);
            wg_commit();
            wg_wait<0>();
            wg_pin(d);
          }
          if (lane == 0) mbar_arrive(empty + s);
        }
        if (!active) continue;
        const int rb = row0 + c * MC + 64 * wg + 16 * wq + gq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = rb + 8 * hf;
          if (row >= row_end) continue;
          // units unit0 + 2 NJ tq + 2 j + e, 2 NJ consecutive floats
          float* cp = a.dh0 + (size_t)row * U + unit0 + 2 * NJ * tq;
#pragma unroll
          for (int j = 0; j < NJ; j += 2) {
            if constexpr (NJ == 1) {
              const float2 v = __ldcg(reinterpret_cast<const float2*>(cp));
              *reinterpret_cast<float2*>(cp) =
                  make_float2(addf(v.x, d[2 * hf]), addf(v.y, d[2 * hf + 1]));
            } else {
              float4* c4 = reinterpret_cast<float4*>(cp + 2 * j);
              const float4 v = __ldcg(c4);
              *c4 = make_float4(addf(v.x, d[4 * j + 2 * hf]), addf(v.y, d[4 * j + 2 * hf + 1]),
                                addf(v.z, d[4 * j + 4 + 2 * hf]), addf(v.w, d[4 * j + 5 + 2 * hf]));
            }
          }
        }
      }
    }
    __syncthreads();  // the gate phase of the next step reads the carry
  }

  // db_rec: the threads' partial sums in thread order, then the row tiles in order
  float* red = reinterpret_cast<float*>(ring);  // (kConsumers, 24)
  if (warp < kConsumerWarps) {
#pragma unroll
    for (int gt = 0; gt < 3; ++gt)
#pragma unroll
      for (int ul = 0; ul < 8; ++ul) red[tid * 24 + gt * 8 + ul] = sb[gt][ul];
  }
  __syncthreads();
  if (tid < 3 * UB) {
    const int gt = tid / UB, ul = tid % UB;
    float s = 0.f;
    for (int i = ul / 8; i < kConsumers; i += QB) s = addf(s, red[i * 24 + gt * 8 + ul % 8]);
    a.dbpart[(size_t)r * G + gt * U + unit0 + ul] = s;
  }
  cg::this_grid().sync();
  if (r == 0 && tid < 3 * UB) {
    const int col = (tid / UB) * U + unit0 + tid % UB;
    const int R = gridDim.x / NG;
    float s = 0.f;
    for (int i = 0; i < R; ++i) s = addf(s, __ldcg(a.dbpart + (size_t)i * G + col));
    a.dbrec[col] = s;
  }
}

// ---------------------------------------------------------------------------
// dWr = [h0; ys[0:T-1]]^T . [dmx[:, :, 0:2U] | plane]
// ---------------------------------------------------------------------------

struct DwrArgs {
  CUtensorMap tm_h0;   // h0 as (1, B, U), box (64, 64, 1)
  CUtensorMap tm_ys;   // ys (T, B, U)
  CUtensorMap tm_dmx;  // dmxs (T, B, 3U) seen as (T, B, 2U)
  CUtensorMap tm_pl;   // plane (T, B, U)
  float* dwr;          // (U, 3U) out
  int T, B, U;
};

__global__ void __launch_bounds__(kThreads, 1) gru_train_dwr_kernel(const __grid_constant__ DwrArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);      // kDStages x (A: 2 x (64 K, 64 M), B: 3 x (64 K, 64 N))
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)kDStages * kDStageBytes);
  uint64_t* empty = full + kDStages;
  const int T = a.T, B = a.B, U = a.U, G = 3 * U, KA = ka_of(U);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * kDN, m0 = blockIdx.y * kDM;
  const int nb = (B + kDK - 1) / kDK, steps = T * nb;

  if (tid == 0) {
    for (int s = 0; s < kDStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    if (lane == 0) {
      // boxes wholly past U (A) or past the index space (B) are not copied:
      // they feed only outputs that are not written
      int bytes = 0;
      for (int i = 0; i < 2; ++i) bytes += m0 + 64 * i < U ? 8192 : 0;
      for (int j = 0; j < 3; ++j) bytes += n0 + 64 * j < KA + U ? 8192 : 0;
      for (int st = 0; st < steps; ++st) {
        const int s = st % kDStages, t = st / nb, b0 = (st % nb) * kDK;
        if (st >= kDStages) mbar_wait(empty + s, (st / kDStages - 1) & 1);
        unsigned char* buf = ring + (size_t)s * kDStageBytes;
        mbar_expect(full + s, bytes);
        for (int i = 0; i < 2; ++i)
          if (m0 + 64 * i < U)
            tma_load(buf + i * 8192, t == 0 ? &a.tm_h0 : &a.tm_ys, m0 + 64 * i, b0,
                     t == 0 ? 0 : t - 1, full + s);
        for (int j = 0; j < 3; ++j) {
          const int n = n0 + 64 * j;
          if (n < KA + U)
            tma_load(buf + 16384 + j * 8192, n < KA ? &a.tm_dmx : &a.tm_pl, n < KA ? n : n - KA,
                     b0, t, full + s);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  // the tensor cores sum a run of kDFlush stages (16384 K rows); each run is
  // then added into dWr in f32, in order, by the thread that owns the entry
  float d[3][32];
  for (int st = 0; st < steps; ++st) {
    const int s = st % kDStages;
    mbar_wait(full + s, (st / kDStages) & 1);
    const uint32_t buf = smem_u32(ring + (size_t)s * kDStageBytes);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        wgmma_n64_mn(d[j], desc_mn(buf + wg * 8192 + 2048 * ks),
                     desc_mn(buf + 16384 + j * 8192 + 2048 * ks), st % kDFlush > 0 || ks > 0);
    wg_commit();
    // the products of stage st - 1 are done: hand its buffer back
    wg_wait<1>();
    if (st % kDFlush > 0 && lane == 0) mbar_arrive(empty + (st - 1) % kDStages);
    if ((st + 1) % kDFlush && st + 1 < steps) continue;
    wg_wait<0>();
#pragma unroll
    for (int j = 0; j < 3; ++j) wg_pin(d[j]);
    if (lane == 0) mbar_arrive(empty + s);
    const bool first = st < kDFlush;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int u = m0 + 64 * wg + 16 * wq + gq + 8 * hf;
      if (u >= U) continue;
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int n = n0 + 64 * j + 8 * jj + 2 * tq;
          const int col = n < 2 * U ? n : (n >= KA && n < KA + U ? 2 * U + n - KA : -1);
          if (col < 0) continue;
          float2* o = reinterpret_cast<float2*>(a.dwr + (size_t)u * G + col);
          const float2 v = first ? make_float2(0.f, 0.f) : *o;
          *o = first ? make_float2(d[j][4 * jj + 2 * hf], d[j][4 * jj + 2 * hf + 1])
                     : make_float2(addf(v.x, d[j][4 * jj + 2 * hf]),
                                   addf(v.y, d[j][4 * jj + 2 * hf + 1]));
        }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// a bf16 array (d2, d1, d0 of every `ld`) as a 3-D tensor map read in
// (box0, box1, 1) boxes with the 128-byte swizzle; reads past the array give zeros
int make_map(CUtensorMap* m, const void* ptr, int d0, int d1, int d2, int ld, int box0, int box1) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)ld * 2 * d1};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t es[3] = {1, 1, 1};
  const CUresult res = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                          strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename Args>
int launch(void (*kernel)(Args), const Args& a, dim3 grid, size_t smem, bool coop, void* stream) {
  int dev = 0, sms = 0, per_sm = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* kargs[] = {const_cast<Args*>(&a)};
  if (coop) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    // every block must be resident at once, or a row tile's barrier never opens
    if (per_sm * sms < (int)grid.x) return (int)cudaErrorCooperativeLaunchTooLarge;
    err = cudaLaunchCooperativeKernel((void*)kernel, grid, kThreads, kargs, smem,
                                      (cudaStream_t)stream);
  } else {
    err = cudaLaunchKernel((void*)kernel, grid, kThreads, kargs, smem, (cudaStream_t)stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// rows a row tile holds (a whole number of 128-row copies; 64 for a lone tile of <= 64 rows)
int tile_rows(int B, int R) {
  if (R == 1 && B <= 64) return 64;
  return round_up((B + R - 1) / R, kChunkRows);
}

int check_plan(int B, int U, int ub, int R, int stages) {
  if (U <= 0 || U % 8 || (ub != 8 && ub != 16 && ub != 32) || U % ub || R < 1 ||
      stages < 2 || stages > kMaxStages || (R - 1) * tile_rows(B, R) >= B)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Bytes of dynamic shared memory a recurrence launch takes: part 0 forward,
// 1 backward (at ub units a block and `stages` ring buffers).
extern "C" long long gxt_gru_train_smem(int part, int ub, int U, int stages) {
  return (long long)smem_bytes(part, ub, U, stages);
}

extern "C" int gxt_gru_train_fwd(const void* mxs, const void* h0, const void* wr,
                                 const float* brec, void* ys, void* mhs, void* ctr, int T, int B,
                                 int U, int ub, int R, int stages, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  int code = check_plan(B, U, ub, R, stages);
  if (code) return code;
  FwdArgs a;
  a.BR = tile_rows(B, R);
  a.MC = a.BR < kChunkRows ? a.BR : kChunkRows;
  if ((code = make_map(&a.tm_h0, h0, U, B, 1, U, 64, a.MC))) return code;
  if ((code = make_map(&a.tm_ys, ys, U, B, T, U, 64, a.MC))) return code;
  a.mxs = static_cast<const bf16*>(mxs);
  a.h0 = static_cast<const bf16*>(h0);
  a.wr = static_cast<const bf16*>(wr);
  a.brec = brec;
  a.ys = static_cast<bf16*>(ys);
  a.mhs = static_cast<bf16*>(mhs);
  a.ctr = static_cast<unsigned*>(ctr);
  a.T = T; a.B = B; a.U = U; a.stages = stages;
  const int grid = R * (U / ub);
  const size_t smem = smem_bytes(0, ub, U, stages);
  if (ub == 8) return launch(gru_train_fwd_kernel<8>, a, grid, smem, true, stream);
  if (ub == 16) return launch(gru_train_fwd_kernel<16>, a, grid, smem, true, stream);
  return launch(gru_train_fwd_kernel<32>, a, grid, smem, true, stream);
}

// `plane` (T, B, U) bf16 and `dbpart` (R, 3U) f32 are scratch the launch
// fills; `ctr` (R) must arrive zeroed.
extern "C" int gxt_gru_train_bwd(const void* mxs, const void* mhs, const void* ys,
                                 const void* dys, const void* h0, const void* wr, void* dmxs,
                                 void* plane, float* dbrec, float* dbpart, float* dh0, void* ctr,
                                 int T, int B, int U, int ub, int R, int stages, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  int code = check_plan(B, U, ub, R, stages);
  if (code) return code;
  BwdArgs a;
  a.BR = tile_rows(B, R);
  a.MC = a.BR < kChunkRows ? a.BR : kChunkRows;
  if ((code = make_map(&a.tm_dmx, dmxs, 2 * U, B, T, 3 * U, 64, a.MC))) return code;
  if ((code = make_map(&a.tm_pl, plane, U, B, T, U, 64, a.MC))) return code;
  a.mxs = static_cast<const bf16*>(mxs);
  a.mhs = static_cast<const bf16*>(mhs);
  a.ys = static_cast<const bf16*>(ys);
  a.dys = static_cast<const bf16*>(dys);
  a.h0 = static_cast<const bf16*>(h0);
  a.wr = static_cast<const bf16*>(wr);
  a.dmxs = static_cast<bf16*>(dmxs);
  a.plane = static_cast<bf16*>(plane);
  a.dbrec = dbrec;
  a.dbpart = dbpart;
  a.dh0 = dh0;
  a.ctr = static_cast<unsigned*>(ctr);
  a.T = T; a.B = B; a.U = U; a.stages = stages;
  const int grid = R * (U / ub);
  const size_t smem = smem_bytes(1, ub, U, stages);
  if (ub == 8) return launch(gru_train_bwd_kernel<8>, a, grid, smem, true, stream);
  if (ub == 16) return launch(gru_train_bwd_kernel<16>, a, grid, smem, true, stream);
  return launch(gru_train_bwd_kernel<32>, a, grid, smem, true, stream);
}

extern "C" int gxt_gru_train_dwr(const void* h0, const void* ys, const void* dmxs,
                                 const void* plane, float* dwr, int T, int B, int U, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (U <= 0 || U % 8) return (int)cudaErrorInvalidValue;
  DwrArgs a;
  int code;
  if ((code = make_map(&a.tm_h0, h0, U, B, 1, U, 64, kDK))) return code;
  if ((code = make_map(&a.tm_ys, ys, U, B, T, U, 64, kDK))) return code;
  if ((code = make_map(&a.tm_dmx, dmxs, 2 * U, B, T, 3 * U, 64, kDK))) return code;
  if ((code = make_map(&a.tm_pl, plane, U, B, T, U, 64, kDK))) return code;
  a.dwr = dwr;
  a.T = T; a.B = B; a.U = U;
  const int gx = (ka_of(U) + U + kDN - 1) / kDN, gy = (U + kDM - 1) / kDM;
  return launch(gru_train_dwr_kernel, a, dim3(gx, gy), smem_bytes(2, 0, U, kDStages), false,
                stream);
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
