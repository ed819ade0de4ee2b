// Fused GRU training sequence at float32: the time loop of the forward pass
// in one cooperative launch, the time loop of the backward pass in another,
// and the recurrent weight gradient as a GEMM launched after it. Every
// product runs on the tensor cores in 3xTF32 (mma.sync m16n8k8).
//
//   gxt_gru_train_fwd_f32  replaces ggml_experiments_tpu/ops/fused_gru_train.py
//                          `_fwd_core_call` (pallas_call :186; body `_fwd_kernel`
//                          :54, `_gates` :45) at compute_dtype=float32
//   gxt_gru_train_bwd_f32  the same file's `_bwd_core_call` (pallas_call :285;
//                          body `_bwd_kernel` :81) at float32, without its dWr sum
//   gxt_gru_train_dwr_f32  the dWr sum of `_bwd_kernel` (:140-144) at float32
//
// Arithmetic: that of csrc/gru_train.cu with every rounding to bf16 the
// identity, as the TPU bodies compute at compute_dtype=float32 (:70-77,
// :128-134). Forward, per step: mh = h.Wr + b_rec (f32 sums), stored; the
// gates from it; h' = z*h + (1-z)*g, the output and the next step's operand.
// Backward, time reversed: gates rebuilt from the stored mx and mh;
// dh = dy + carry; dmx = [daz, dar, da]; plane = da*r; carry = dh*z +
// dmh.Wr^T with dmh = [daz, dar, da*r]; db_rec = sum over (t, b) of dmh;
// dh0 is the last carry. dWr = sum over (t, b) of h_prev^T . dmh. The gate
// arithmetic writes every rounding out (no contracted multiply-add), as the
// plain version rounds after each operation. Products: each f32 operand is
// split into tf32 hi + lo and lo.hi + hi.lo + hi.hi is summed in f32 (about
// f32 accuracy; PyTorch's f32 matmul, the plain version's, runs with TF32
// off).
//
// Bound on an H100 at the training shape (T=100, B=1024, U=1024): each of
// the three kernels does 2*T*B*U*3U = 0.64 TFLOP of products, 3.9 ms at
// 3xTF32's 165 TFLOP/s (495 / 3), against 2.9-3.4 GB of operands (0.9-1.0
// ms at 3.35 TB/s): the operations bound them.
//
// The grid is cut as in csrc/gru_train.cu: block (r, g) owns row tile r of
// the batch and unit group g (ub = 8 or 16 hidden units: 32 fit only below
// U = 590) for the whole
// launch; ops/fused_gru_train.py `train_plan(..., dtype=float32)` picks
// (ub, R); R x U/ub blocks are co-resident (cooperative launch), and the
// blocks of one row tile meet at a release/acquire counter in global memory
// once a step. What differs at f32:
//   * Wr's slice is twice the bf16 one: 3ub columns x U (forward) or ub rows
//     x 3U (backward), 195-198 KB at ub = 16, U = 1024. It stays resident in
//     shared memory as f32 and is split into tf32 parts as it is read; the
//     A operand (h, or dmh = [dmx[t][:, :2U] | plane[t]]) is read by each
//     warp straight from L2 (16 bytes a lane and row, a k-step ahead), so no
//     ring shares the shared memory. wgmma takes tf32 operands only K-major
//     from shared memory and the slice's other layout would not fit twice:
//     the products run on mma.sync.
//   * A warp takes 16 or 32 rows (one or two m16 tiles; the backward 16, 32
//     or 64), as many as keep all 8 warps busy: the bytes of h or dmh a warp
//     has in flight set the pace (PERF.md). It takes them
//     against all the block's columns;
//     mma k-slots t and t + 4 of a 16-wide k-step map to k0 + 4t and
//     k0 + 4t + 1 (the second product's to + 2, + 3), so one float4 a row
//     gives a lane its fragments of both products, and the slice rows in
//     shared memory have a stride of 16 mod 32 floats (no bank conflict).
//   * dWr: M = U, N = 3U, K = T*B; a block of 16 warps owns a 128 x 192
//     tile of dWr and walks all of K in (t, b) order through a 4-stage
//     cp.async ring of 16 K rows (h_prev and dmh rows, both MN-major, as
//     they lie in memory), the fragments read from shared memory with
//     strides of 8 mod 32 floats.
//   * Sums: the tensor cores' chained additions drift (on an H100 a chain of
//     450 mma.sync strayed 1e-5 of the largest dWr entry from the plain f32
//     product), so they sum short runs only, 8 k-steps of 16 in the
//     recurrences and one stage of 16 K rows in dWr, each run added in f32
//     (round to nearest) in order.
// No atomics on values and no order that depends on timing: two launches
// give the same bits (db_rec per thread, per block in thread order, then over
// the row tiles in order after one grid sync).
// Shapes: U a multiple of 8, any B >= 1; operands 16-byte aligned.
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gxt;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;              // a recurrence block
constexpr int kChunkRows = 128;                    // row tiles hold whole 128-row chunks
constexpr int kRun = 8;                            // k-steps of 16 a tensor-core run sums
constexpr int kDThreads = 512;                     // a dWr block: 16 warps of 32 x 48
constexpr int kDM = 128, kDN = 192, kDK = 16;      // dWr block tile and K rows a stage
constexpr int kDLdA = kDM + 8, kDLdB = kDN + 8;    // their row strides in shared memory
constexpr int kDStageFloats = kDK * (kDLdA + kDLdB);
constexpr int kDStages = 4;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
// row stride (floats) of a Wr slice row of K columns in shared memory
__host__ __device__ inline int ks_of(int K) { return round_up(K, 32) + 16; }

size_t smem_bytes(int part, int ub, int U) {
  if (part == 0) return (size_t)3 * ub * ks_of(U) * 4;
  if (part == 1) {
    // the slice, whose room then holds the threads' db_rec partial sums
    const size_t w = (size_t)ub * ks_of(3 * U) * 4, red = (size_t)kThreads * 24 * 4;
    return w > red ? w : red;
  }
  return (size_t)kDStages * kDStageFloats * 4;
}

__device__ __forceinline__ float subf(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ void ld8(const float* p, float (&f)[8], bool l2_only) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = l2_only ? __ldcg(q) : __ldg(q), b = l2_only ? __ldcg(q + 1) : __ldg(q + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void st8(float* p, const float (&f)[8]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(f[0], f[1], f[2], f[3]);
  q[1] = make_float4(f[4], f[5], f[6], f[7]);
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

// tot[mt][j] = A[rows 16 mt + {g, g + 8} of the warp][0:K16) .
// Bs[8 j + g][0:K16)^T in 3xTF32. Bs is the Wr slice in shared memory (row
// stride ks, zeros from the operand's K on); ld(mt, hf, k) gives A[row of
// (mt, hf)][k..k+3] (zeros past the operand). In a k-step of 16, mma k-slot
// t of the first product is k0 + 4t and slot t + 4 is k0 + 4t + 1; the
// second product's are k0 + 4t + 2 and + 3. The tensor cores sum runs of
// kRun k-steps, each added into tot in f32, in order (see "Sums" above).
template <int MT, int NT, typename Ld>
__device__ __forceinline__ void rows_product(float (&tot)[MT][NT][4], Ld ld, const float* bs,
                                             int ks, int K16, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) tot[mt][j][i] = acc[mt][j][i] = 0.f;
  float4 a[MT][2], an[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) a[mt][hf] = ld(mt, hf, 4 * t);
  for (int k0 = 0; k0 < K16; k0 += 16) {
    const bool more = k0 + 16 < K16;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) an[mt][hf] = more ? ld(mt, hf, k0 + 16 + 4 * t) : zero4();
    uint32_t ah[MT][2][4], al[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      split_tf32(a[mt][0].x, ah[mt][0][0], al[mt][0][0]);
      split_tf32(a[mt][1].x, ah[mt][0][1], al[mt][0][1]);
      split_tf32(a[mt][0].y, ah[mt][0][2], al[mt][0][2]);
      split_tf32(a[mt][1].y, ah[mt][0][3], al[mt][0][3]);
      split_tf32(a[mt][0].z, ah[mt][1][0], al[mt][1][0]);
      split_tf32(a[mt][1].z, ah[mt][1][1], al[mt][1][1]);
      split_tf32(a[mt][0].w, ah[mt][1][2], al[mt][1][2]);
      split_tf32(a[mt][1].w, ah[mt][1][3], al[mt][1][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(bs + (size_t)(8 * j + g) * ks + k0 + 4 * t);
      uint32_t bh[4], bl[4];
      split_tf32(b.x, bh[0], bl[0]);
      split_tf32(b.y, bh[1], bl[1]);
      split_tf32(b.z, bh[2], bl[2]);
      split_tf32(b.w, bh[3], bl[3]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_tf32x<true>(acc[mt][j], ah[mt][0], al[mt][0], bh[0], bh[1], bl[0], bl[1]);
        mma_tf32x<true>(acc[mt][j], ah[mt][1], al[mt][1], bh[2], bh[3], bl[2], bl[3]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) a[mt][hf] = an[mt][hf];
    if (more && (k0 / 16 + 1) % kRun) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tot[mt][j][i] = addf(tot[mt][j][i], acc[mt][j][i]);
          acc[mt][j][i] = 0.f;
        }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  const float* mxs;   // (T, B, 3U)
  const float* h0;    // (B, U)
  const float* wr;    // (U, 3U)
  const float* brec;  // (3U)
  float* ys;          // (T, B, U) out
  float* mhs;         // (T, B, 3U) out
  unsigned* ctr;      // (R) zeros: the row tiles' step counters
  int T, B, U, BR;
};

template <int UB, int MT>
__global__ void __launch_bounds__(kThreads, 1) gru_train_fwd_f32_kernel(const __grid_constant__ FwdArgs a) {
  constexpr int NT = 3 * UB / 8, NJ = UB / 8;
  extern __shared__ float4 smem_f4[];
  float* wr_s = reinterpret_cast<float*>(smem_f4);   // 3 UB rows of KS
  const int T = a.T, B = a.B, U = a.U, G = 3 * U, KS = ks_of(U), K16 = round_up(U, 16);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int NG = U / UB, g = blockIdx.x % NG, r = blockIdx.x / NG;
  const int unit0 = g * UB;
  const int row0 = r * a.BR, row_end = min(B, row0 + a.BR);

  // slice row n = 8 j + c (j = 3 jj + gate) is column `gate` of unit
  // unit0 + 8 jj + c: the accumulator of tile 3 jj + gate hands a lane the
  // three gates of the same two units
  for (int i = tid; i < 3 * UB * KS; i += kThreads) {
    const int n = i % (3 * UB), k = i / (3 * UB), j = n >> 3;
    const int col = (j % 3) * U + unit0 + 8 * (j / 3) + (n & 7);
    wr_s[(size_t)n * KS + k] = k < U ? a.wr[(size_t)k * G + col] : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (t > 0 && tid == 0) tile_wait(a.ctr + r, (unsigned)(NG * t));
    __syncthreads();
    const float* hp = t == 0 ? a.h0 : a.ys + (size_t)(t - 1) * B * U;
    const float* mx = a.mxs + (size_t)t * B * G;
    float* mh = a.mhs + (size_t)t * B * G;
    float* yo = a.ys + (size_t)t * B * U;
    for (int rb = row0 + 16 * MT * warp; rb < row_end; rb += 16 * MT * kWarps) {
      float acc[MT][NT][4];
      rows_product<MT, NT>(acc, [&](int mt, int hf, int k) {
        const int row = rb + 16 * mt + 8 * hf + gq;
        return row < row_end && k < U
                   ? __ldcg(reinterpret_cast<const float4*>(hp + (size_t)row * U + k))
                   : zero4();
      }, wr_s, KS, K16, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = rb + 16 * mt + 8 * hf + gq;
          if (row >= row_end) continue;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            const int u = unit0 + 8 * jj + 2 * tq;
            float2 mxv[3], mhv[3];
#pragma unroll
            for (int gt = 0; gt < 3; ++gt) {
              mxv[gt] = __ldg(reinterpret_cast<const float2*>(mx + (size_t)row * G + gt * U + u));
              const float2 bb = __ldg(reinterpret_cast<const float2*>(a.brec + gt * U + u));
              mhv[gt] = make_float2(addf(acc[mt][3 * jj + gt][2 * hf], bb.x),
                                    addf(acc[mt][3 * jj + gt][2 * hf + 1], bb.y));
            }
            const float2 hv = __ldcg(reinterpret_cast<const float2*>(hp + (size_t)row * U + u));
            float hn[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float mxz = e ? mxv[0].y : mxv[0].x, mxr = e ? mxv[1].y : mxv[1].x;
              const float mxh = e ? mxv[2].y : mxv[2].x;
              const float mhz = e ? mhv[0].y : mhv[0].x, mhr = e ? mhv[1].y : mhv[1].x;
              const float mhh = e ? mhv[2].y : mhv[2].x;
              const float hprev = e ? hv.y : hv.x;
              const float z = sigmoidf(addf(mxz, mhz));
              const float rr = sigmoidf(addf(mxr, mhr));
              const float gg = tanhf(addf(mxh, mulf(rr, mhh)));
              hn[e] = addf(mulf(z, hprev), mulf(subf(1.f, z), gg));
            }
#pragma unroll
            for (int gt = 0; gt < 3; ++gt)
              *reinterpret_cast<float2*>(mh + (size_t)row * G + gt * U + u) = mhv[gt];
            *reinterpret_cast<float2*>(yo + (size_t)row * U + u) = make_float2(hn[0], hn[1]);
          }
        }
    }
    __syncthreads();
    if (tid == 0 && t + 1 < T) tile_arrive(a.ctr + r);
  }
}

// ---------------------------------------------------------------------------
// backward recurrence
// ---------------------------------------------------------------------------

struct BwdArgs {
  const float* mxs;   // (T, B, 3U)
  const float* mhs;   // (T, B, 3U)
  const float* ys;    // (T, B, U)
  const float* dys;   // (T, B, U)
  const float* h0;    // (B, U)
  const float* wr;    // (U, 3U)
  float* dmxs;        // (T, B, 3U) out
  float* plane;       // (T, B, U) out: da * r
  float* dbrec;       // (3U) out
  float* dbpart;      // (R, 3U) scratch: each row tile's db_rec
  float* dh0;         // (B, U) out; the carry during the launch
  unsigned* ctr;      // (R) zeros
  int T, B, U, BR;
};

template <int UB, int MT>
__global__ void __launch_bounds__(kThreads, 1) gru_train_bwd_f32_kernel(const __grid_constant__ BwdArgs a) {
  constexpr int NT = UB / 8;
  constexpr int QB = UB / 8;                 // 8-unit groups a row: threads per row in the gate phase
  constexpr int SLOTS = kThreads / QB;       // rows the gate phase takes at once
  extern __shared__ float4 smem_f4[];
  float* wr_s = reinterpret_cast<float*>(smem_f4);   // UB rows of KS
  const int T = a.T, B = a.B, U = a.U, G = 3 * U, KS = ks_of(G), K16 = round_up(G, 16);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int NG = U / UB, g = blockIdx.x % NG, r = blockIdx.x / NG;
  const int unit0 = g * UB;
  const int row0 = r * a.BR, row_end = min(B, row0 + a.BR);

  // slice row n is Wr's row unit0 + n over all 3U columns: the carry product's B
  for (int i = tid; i < UB * KS; i += kThreads) {
    const int n = i / KS, k = i % KS;
    wr_s[i] = k < G ? a.wr[(size_t)(unit0 + n) * G + k] : 0.f;
  }
  // db_rec partial sums of this thread's rows (its 8-unit group q), every step
  const int q = tid % QB, slot = tid / QB;
  float sb[3][8];
#pragma unroll
  for (int gt = 0; gt < 3; ++gt)
#pragma unroll
    for (int ul = 0; ul < 8; ++ul) sb[gt][ul] = 0.f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    // ---- gate phase: 8 units (group q) of one row a thread
    const float* mx = a.mxs + (size_t)t * B * G;
    const float* mh = a.mhs + (size_t)t * B * G;
    const float* hp = t == 0 ? a.h0 : a.ys + (size_t)(t - 1) * B * U;
    const float* dy = a.dys + (size_t)t * B * U;
    float* dmx = a.dmxs + (size_t)t * B * G;
    float* pl = a.plane + (size_t)t * B * U;
    for (int b = row0 + slot; b < row_end; b += SLOTS) {
      const int u0 = unit0 + 8 * q;
      const size_t og = (size_t)b * G + u0, ou = (size_t)b * U + u0;
      float mxf[3][8], mhf[3][8], hpf[8], dyf[8], cf[8];
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        ld8(mx + og + gt * U, mxf[gt], false);
        ld8(mh + og + gt * U, mhf[gt], false);
      }
      ld8(hp + ou, hpf, false);
      ld8(dy + ou, dyf, false);
      if (t == T - 1) {
#pragma unroll
        for (int ul = 0; ul < 8; ++ul) cf[ul] = 0.f;
      } else {
        ld8(a.dh0 + ou, cf, true);
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
      for (int gt = 0; gt < 3; ++gt) st8(dmx + og + gt * U, ox[gt]);
      st8(pl + ou, dah);
      st8(a.dh0 + ou, cz);
    }
    __syncthreads();
    if (tid == 0) {
      tile_arrive(a.ctr + r);
      tile_wait(a.ctr + r, (unsigned)(NG * (T - t)));
    }
    __syncthreads();

    // ---- carry[rows, own units] += dmh[rows, 0:3U] . Wr[own units]^T
    for (int rb = row0 + 16 * MT * warp; rb < row_end; rb += 16 * MT * kWarps) {
      float acc[MT][NT][4];
      // dmh's columns 0..2U are dmx's, 2U..3U the plane's (2U is a multiple of
      // 16, so no 16-byte read straddles the two)
      rows_product<MT, NT>(acc, [&](int mt, int hf, int k) {
        const int row = rb + 16 * mt + 8 * hf + gq;
        if (row >= row_end || k >= G) return zero4();
        const float* p = k < 2 * U ? dmx + (size_t)row * G + k : pl + (size_t)row * U + k - 2 * U;
        return __ldcg(reinterpret_cast<const float4*>(p));
      }, wr_s, KS, K16, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = rb + 16 * mt + 8 * hf + gq;
          if (row >= row_end) continue;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float2* cp = reinterpret_cast<float2*>(a.dh0 + (size_t)row * U + unit0 + 8 * j + 2 * tq);
            const float2 v = __ldcg(cp);
            *cp = make_float2(addf(v.x, acc[mt][j][2 * hf]), addf(v.y, acc[mt][j][2 * hf + 1]));
          }
        }
    }
    __syncthreads();  // the gate phase of the next step reads the carry
  }

  // db_rec: the threads' partial sums in thread order, then the row tiles in order
  float* red = wr_s;  // (kThreads, 24)
#pragma unroll
  for (int gt = 0; gt < 3; ++gt)
#pragma unroll
    for (int ul = 0; ul < 8; ++ul) red[tid * 24 + gt * 8 + ul] = sb[gt][ul];
  __syncthreads();
  if (tid < 3 * UB) {
    const int gt = tid / UB, ul = tid % UB;
    float s = 0.f;
    for (int i = ul / 8; i < kThreads; i += QB) s = addf(s, red[i * 24 + gt * 8 + ul % 8]);
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
  const float* h0;     // (B, U)
  const float* ys;     // (T, B, U)
  const float* dmxs;   // (T, B, 3U)
  const float* plane;  // (T, B, U)
  float* dwr;          // (U, 3U) out
  int T, B, U;
};

__global__ void __launch_bounds__(kDThreads, 1) gru_train_dwr_f32_kernel(const __grid_constant__ DwrArgs a) {
  extern __shared__ float4 smem_f4[];
  float* ring = reinterpret_cast<float*>(smem_f4);  // kDStages x (A: kDK x kDLdA, B: kDK x kDLdB)
  const int B = a.B, U = a.U, G = 3 * U;
  const long long K = (long long)a.T * B;
  const int nk = (int)((K + kDK - 1) / kDK);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * kDN, m0 = blockIdx.y * kDM;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 48;   // the warp's 32 x 48 of the tile
  constexpr int kChunks = (kDM + kDN) / 4;                  // 16-byte copies a K row

  // K rows kc*kDK.. of h_prev (columns m0..) and dmh (columns n0..) into stage s;
  // rows past K and columns past U / 3U are zeros
  auto load = [&](int kc, int s) {
    float* as = ring + (size_t)s * kDStageFloats;
    float* bs = as + kDK * kDLdA;
    for (int c = tid; c < kDK * kChunks; c += kDThreads) {
      const int i = c / kChunks, col = 4 * (c % kChunks);
      const long long kk = (long long)kc * kDK + i;
      const bool in = kk < K;
      const int t = in ? (int)(kk / B) : 0, b = in ? (int)(kk % B) : 0;
      const float* src = a.h0;
      int bytes = 0;
      float* dst;
      if (col < kDM) {
        const int m = m0 + col;
        dst = as + i * kDLdA + col;
        if (in && m < U) {
          src = (t == 0 ? a.h0 + (size_t)b * U : a.ys + ((size_t)(t - 1) * B + b) * U) + m;
          bytes = 16;
        }
      } else {
        const int n = n0 + col - kDM;
        dst = bs + i * kDLdB + col - kDM;
        if (in && n < G) {
          src = n < 2 * U ? a.dmxs + ((size_t)t * B + b) * G + n
                          : a.plane + ((size_t)t * B + b) * U + n - 2 * U;
          bytes = 16;
        }
      }
      cp_async16(dst, src, bytes);
    }
  };

#pragma unroll
  for (int s = 0; s < kDStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  // each stage's products are summed on the tensor cores (six chained
  // additions), then added into tot in f32, in K order
  float tot[2][6][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 6; ++j) tot[mt][j][0] = tot[mt][j][1] = tot[mt][j][2] = tot[mt][j][3] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kDStages - 2>();
    __syncthreads();   // stage kc is in; every warp is done with stage kc - 1
    if (kc + kDStages - 1 < nk) load(kc + kDStages - 1, (kc + kDStages - 1) % kDStages);
    cp_async_commit();
    const float* as = ring + (size_t)(kc % kDStages) * kDStageFloats;
    const float* bs = as + kDK * kDLdA;
    float acc[2][6][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 6; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < kDK; k0 += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ap = as + (k0 + tq) * kDLdA + wm + 16 * mt + gq;
        split_tf32(ap[0], ah[mt][0], al[mt][0]);
        split_tf32(ap[8], ah[mt][1], al[mt][1]);
        split_tf32(ap[4 * kDLdA], ah[mt][2], al[mt][2]);
        split_tf32(ap[4 * kDLdA + 8], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float* bp = bs + (k0 + tq) * kDLdB + wn + 8 * j + gq;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bp[0], bh0, bl0);
        split_tf32(bp[4 * kDLdB], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_tf32x<true>(acc[mt][j], ah[mt], al[mt], bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) tot[mt][j][i] = addf(tot[mt][j][i], acc[mt][j][i]);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + wm + 16 * mt + 8 * hf + gq;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int n = n0 + wn + 8 * j + 2 * tq;
        if (m < U && n < G)
          *reinterpret_cast<float2*>(a.dwr + (size_t)m * G + n) =
              make_float2(tot[mt][j][2 * hf], tot[mt][j][2 * hf + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename Args>
int launch(void (*kernel)(Args), const Args& a, dim3 grid, int threads, size_t smem, bool coop,
           void* stream) {
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    // every block must be resident at once, or a row tile's barrier never opens
    if (per_sm * sms < (int)grid.x) return (int)cudaErrorCooperativeLaunchTooLarge;
    err = cudaLaunchCooperativeKernel((void*)kernel, grid, threads, kargs, smem,
                                      (cudaStream_t)stream);
  } else {
    err = cudaLaunchKernel((void*)kernel, grid, threads, kargs, smem, (cudaStream_t)stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// rows a row tile holds (a whole number of 128-row chunks; 64 for a lone tile
// of <= 64 rows): the bf16 kernels' cut, so that both forms share the plans
int tile_rows(int B, int R) {
  if (R == 1 && B <= 64) return 64;
  return round_up((B + R - 1) / R, kChunkRows);
}

int check_plan(int B, int U, int ub, int R) {
  if (U <= 0 || U % 8 || (ub != 8 && ub != 16) || U % ub || R < 1 ||
      (R - 1) * tile_rows(B, R) >= B)
    return (int)cudaErrorInvalidValue;
  return 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Bytes of dynamic shared memory a launch takes: part 0 forward, 1 backward
// recurrence (at ub units a block), 2 the dWr GEMM.
extern "C" long long gxt_gru_train_f32_smem(int part, int ub, int U) {
  return (long long)smem_bytes(part, ub, U);
}

extern "C" int gxt_gru_train_fwd_f32(const float* mxs, const float* h0, const float* wr,
                                     const float* brec, float* ys, float* mhs, void* ctr, int T,
                                     int B, int U, int ub, int R, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  int code = check_plan(B, U, ub, R);
  if (code) return code;
  if (!aligned16(mxs) || !aligned16(h0) || !aligned16(ys) || !aligned16(mhs))
    return (int)cudaErrorMisalignedAddress;
  FwdArgs a;
  a.mxs = mxs; a.h0 = h0; a.wr = wr; a.brec = brec; a.ys = ys; a.mhs = mhs;
  a.ctr = static_cast<unsigned*>(ctr);
  a.T = T; a.B = B; a.U = U; a.BR = tile_rows(B, R);
  const int grid = R * (U / ub);
  const size_t smem = smem_bytes(0, ub, U);
  // the m16 tiles a warp takes at once: as many as keep all 8 warps busy, up
  // to 2 (the accumulators of 48 columns take the registers of more)
  const int mt = a.BR >= 256 ? 2 : 1;
  void (*kernel)(FwdArgs) =
      ub == 8 ? (mt == 2 ? gru_train_fwd_f32_kernel<8, 2> : gru_train_fwd_f32_kernel<8, 1>)
              : (mt == 2 ? gru_train_fwd_f32_kernel<16, 2> : gru_train_fwd_f32_kernel<16, 1>);
  return launch(kernel, a, grid, kThreads, smem, true, stream);
}

// `plane` (T, B, U) and `dbpart` (R, 3U) are scratch the launch fills; `ctr`
// (R) must arrive zeroed.
extern "C" int gxt_gru_train_bwd_f32(const float* mxs, const float* mhs, const float* ys,
                                     const float* dys, const float* h0, const float* wr,
                                     float* dmxs, float* plane, float* dbrec, float* dbpart,
                                     float* dh0, void* ctr, int T, int B, int U, int ub, int R,
                                     void* stream) {
  if (T <= 0 || B <= 0) return 0;
  int code = check_plan(B, U, ub, R);
  if (code) return code;
  const void* ptrs[] = {mxs, mhs, ys, dys, h0, dmxs, plane, dh0};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  BwdArgs a;
  a.mxs = mxs; a.mhs = mhs; a.ys = ys; a.dys = dys; a.h0 = h0; a.wr = wr;
  a.dmxs = dmxs; a.plane = plane; a.dbrec = dbrec; a.dbpart = dbpart; a.dh0 = dh0;
  a.ctr = static_cast<unsigned*>(ctr);
  a.T = T; a.B = B; a.U = U; a.BR = tile_rows(B, R);
  const int grid = R * (U / ub);
  const size_t smem = smem_bytes(1, ub, U);
  // the m16 tiles a warp takes at once: as many as keep all 8 warps busy, up
  // to 4 (the carry product waits on the dmh bytes a warp has in flight)
  const int mt = a.BR >= 512 ? 4 : a.BR >= 256 ? 2 : 1;
  void (*kernel)(BwdArgs) =
      ub == 8 ? (mt == 4 ? gru_train_bwd_f32_kernel<8, 4>
                         : mt == 2 ? gru_train_bwd_f32_kernel<8, 2> : gru_train_bwd_f32_kernel<8, 1>)
              : (mt == 4 ? gru_train_bwd_f32_kernel<16, 4>
                         : mt == 2 ? gru_train_bwd_f32_kernel<16, 2> : gru_train_bwd_f32_kernel<16, 1>);
  return launch(kernel, a, grid, kThreads, smem, true, stream);
}

extern "C" int gxt_gru_train_dwr_f32(const float* h0, const float* ys, const float* dmxs,
                                     const float* plane, float* dwr, int T, int B, int U,
                                     void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (U <= 0 || U % 8) return (int)cudaErrorInvalidValue;
  if (!aligned16(h0) || !aligned16(ys) || !aligned16(dmxs) || !aligned16(plane))
    return (int)cudaErrorMisalignedAddress;
  DwrArgs a;
  a.h0 = h0; a.ys = ys; a.dmxs = dmxs; a.plane = plane; a.dwr = dwr;
  a.T = T; a.B = B; a.U = U;
  const dim3 grid((3 * U + kDN - 1) / kDN, (U + kDM - 1) / kDM);
  return launch(gru_train_dwr_f32_kernel, a, grid, kDThreads, smem_bytes(2, 0, U), false,
                stream);
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
