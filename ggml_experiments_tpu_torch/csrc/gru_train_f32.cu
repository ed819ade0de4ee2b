// Fused GRU training sequence at float32: the time loop of the forward pass
// in one cooperative launch, the time loop of the backward pass in another,
// and the recurrent weight gradient as a GEMM launched after it. Every
// product runs in 3xTF32 on tf32 wgmma m64nNk8, A in registers.
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
// The recurrences share a cut: block (r, g) owns row tile r of the batch
// (whole chunks of `rows`) and `units` hidden units for the whole launch
// (ops/fused_gru_train.py `train_plan(..., dtype=float32, part=...)` picks
// (rows, units, R) for each); the R x U/units blocks are co-resident
// (cooperative launch, one a multiprocessor), and the blocks of one row tile
// meet at a release/acquire counter in global memory once a step. A block
// runs two consumer warpgroups and a producer (a warpgroup in the forward, a
// warp in the backward). For each 32-wide K stage the producer copies the
// chunk's rows of the A operand and the block's rows of the B operand's tf32
// hi and lo parts (split once a call by the wrapper) by TMA with the 128-byte
// swizzle into an mbarrier ring. The warpgroups read their A fragments from
// the stage into registers, split into tf32 hi and lo as they are read (one
// 8-wide k-step at a time, in two register sets), and run lo.hi + hi.lo +
// hi.hi as wgmma with A in registers and B in shared memory: the split costs
// no shared-memory pass, no barrier and no room in the ring. Cuts of 128 or
// 256 rows give each warpgroup its own 64 or 128 rows; cuts of 64 rows give
// the two warpgroups alternate K stages of the same rows, whose sums meet in
// shared memory at the chunk's end (warpgroup 0's first). The backward's 288
// threads at one block a multiprocessor cap a thread at 168 registers; the
// forward's producer warpgroup hands its registers over (setmaxnreg), so its
// consumers take 232.
//
// Forward: mh[rows, the block's 3 units columns] = h[rows, 0:U] . Wr[0:U,
// columns]. h (ys of the step before, h0 at t = 0) is K-major as it lies; Wr
// (U, 3U) is MN-major, which tf32 wgmma does not read, so the B operand is
// Wr's transpose (`f32_fwd_weight(wr)`), K padded with zeros to a whole
// stage, its rows in the order the gate phase reads the accumulators in: row
// 24 J + 8 gate + c is column gate * U + 8 J + c, so a lane's fragment holds
// the z, r and h sums of the same two units. A warpgroup's product spans all
// the block's columns, so each h fragment is split once: its sums and f32
// totals (up to 2 x 96 floats a thread at 64 units of 64 rows) need more than
// 168 registers, hence the register handover; at 168 the wide cuts spilled
// and ran slower. The row tile's counter gates only the producer: it sends
// the B halves of the next step's first stages out before the counter opens,
// then the h rows once every block of the tile has written the step before
// (its ys writes, generic-proxy, fenced against the TMA reads). The gate
// phase runs on the totals in registers and writes mh and ys.
//
// Backward recurrence: the carry product carry[rows, units] += dmh[rows,
// 0:3U] . Wr[units, 0:3U]^T has both operands K-major as they lie, with
// nothing resident: A is the chunk's dmh rows ([dmx[t][:, :2U] | plane[t]]
// by two 3-D tensor maps), B Wr's rows split once a call (`f32_bwd_weight`)
// in the same K order. The default is the widest unit group that fills the
// card (64 rows x 128 units at B = 1024): the operand intake, not the
// tensor cores, sets the pace, and a wider product takes more from each dmh
// byte. db_rec: per thread, per block in thread order, then over the row
// tiles in order after one grid sync.
//
// dWr: M = U, N = 3U, K = T*B, both operands MN-major as they lie in memory
// (rows of h_prev and of dmh are K), which tf32 wgmma does not read. A block
// owns a 128 x 128 tile of dWr and a fixed share of K (the K partitions:
// the wrapper picks their number so that tiles x partitions fill whole waves
// of the card). A producer warp copies 32 K rows of both operands a stage by
// TMA into a 5-stage ring. The consumers read each staged f32 of dmh once
// and write its tf32 hi and lo parts K-major in the 128-byte-swizzled
// layout wgmma reads (the transposing split stage, double-buffered), and
// take h_prev's fragments straight into registers, split as they are read
// (its boxes swizzled, and each k-step's slots mapped to K rows so that the
// 32 lanes' reads hit 32 banks; the split of dmh follows the same map);
// each warpgroup then runs its 64 x 128 of the tile with A in registers.
// The partitions' sums land in a scratch array and a second kernel adds
// them in partition order.
//
// Sums: the tensor cores' chained additions drift (on an H100 a chain of 450
// mma.sync strayed 1e-5 of the largest dWr entry from the plain f32
// product), so they sum one 32-wide K stage only (12 chained products), each
// stage's sums added in f32 (round to nearest) in K order.
// No atomics on values and no order that depends on timing: two launches
// give the same bits.
// Shapes: U a multiple of 8, any B >= 1; operands 16-byte aligned. The
// forward's K index space is h's U columns padded with zeros to a whole
// stage. That of the carry product is [dmx columns 0..2U) padded with zeros
// to KA = 2U rounded up to 32, then the plane's U columns (so no TMA box of
// 32 straddles the two); dWr's N index space is the same with KA = 2U
// rounded up to 128 (its box width), and the padding's columns are not
// written.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "hopper_common.cuh"
#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gxt;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;              // a recurrence block's consumers
constexpr int kFwdThreads = kThreads + 128;        // and the forward's producer warpgroup
constexpr int kRecThreads = kThreads + 32;         // or the backward's producer warp
constexpr int kKS = 32;                            // K of a stage: a 128-byte row
constexpr int kMaxStages = 16;                     // a recurrence's ring, at most
constexpr int kSmemLimit = 232448;                 // an H100 block's shared memory
constexpr int kDThreads = kThreads + 32;           // a dWr block: two warpgroups and a producer warp
constexpr int kDM = 128, kDN = 128;                // dWr block tile
constexpr int kDRawBytes = (kDM + kDN) * kKS * 4;  // a stage of raw f32 operands
constexpr int kDSplitBytes = 2 * kDN * kKS * 4;    // B hi, B lo, K-major
constexpr int kDStages = 5;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// a recurrence's ring: a stage holds the chunk's A rows and the block's B
// hi and lo rows (n of each: 3 units forward, units backward), 128 bytes each
__host__ __device__ inline int stage_bytes(int rows, int n) { return (rows + 2 * n) * 128; }
// the second warpgroup's sums where the two take alternate stages (64-row
// cuts): n / 2 floats a thread
__host__ __device__ inline int xchg_bytes(int rows, int n) {
  return rows == 64 ? 128 * (n / 2) * 4 : 0;
}
inline int ring_stages(int rows, int n) {
  const int s = (kSmemLimit - 1024 - xchg_bytes(rows, n)) / (stage_bytes(rows, n) + 16);
  return s < kMaxStages ? s : kMaxStages;
}
inline size_t ring_smem(int rows, int n) {
  return 1024 + (size_t)ring_stages(rows, n) * (stage_bytes(rows, n) + 16) + xchg_bytes(rows, n);
}

// part 0 forward, 1 backward recurrence (x = rows, y = units of the cut), 2 dWr
size_t smem_bytes(int part, int x, int y) {
  if (part == 0) return ring_smem(x, 3 * y);
  if (part == 1) return ring_smem(x, y);
  return 1024 + (size_t)kDStages * (kDRawBytes + 16) + 2 * kDSplitBytes;
}

__device__ __forceinline__ float subf(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

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

// ---------------------------------------------------------------------------
// TMA, barriers and the tf32 split of the wgmma kernels
// ---------------------------------------------------------------------------

// one TMA copy of a box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* tm, int c0, int c1,
                                            int c2, uint64_t* bar) {
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

// a named barrier of `n` threads (0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// four f32 values as their tf32 hi and lo parts (split_tf32 of each)
__device__ __forceinline__ void split4(float a, float b, float c, float d, float4& hi, float4& lo) {
  uint32_t h[4], l[4];
  split_tf32(a, h[0], l[0]);
  split_tf32(b, h[1], l[1]);
  split_tf32(c, h[2], l[2]);
  split_tf32(d, h[3], l[3]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                   __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
}

// acc = the stage's A rows (those of m64 tile `mt`: the lane's row `arow` of
// the stage, + 64 mt, + 8) . B rows [b, b + N)^T in 3xTF32, the 12 products
// chained on the tensor cores. A's fragments are read from the swizzled
// stage and split into tf32 hi and lo as they are read, one k-step at a time
// into two sets of registers: a set is written again only once the products
// of two k-steps back are done. Returns with the products in flight.
template <int N>
__device__ __forceinline__ void stage_product(float (&acc)[N / 2], const unsigned char* st,
                                              int arow, uint32_t b_hi, uint32_t b_lo, int tq) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int ks = 0; ks < kKS / 8; ++ks) {
    const int f = ks & 1;
    if (ks >= 2) wg_wait<1>();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = arow + 8 * (e & 1), k = 8 * ks + tq + 4 * (e >> 1);
      split_tf32(*reinterpret_cast<const float*>(st + swz4(row, k)), ah[f][e], al[f][e]);
    }
    wg_fence();
    wgmma_tf32_rs<N>(acc, al[f], desc_k(b_hi + 32 * ks), ks > 0);
    wgmma_tf32_rs<N>(acc, ah[f], desc_k(b_lo + 32 * ks), 1);
    wgmma_tf32_rs<N>(acc, ah[f], desc_k(b_hi + 32 * ks), 1);
    wg_commit();
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  CUtensorMap tm_h0;   // h0 as (1, B, U), box (32, rows, 1), 128-byte swizzle
  CUtensorMap tm_ys;   // ys (T, B, U), same box
  CUtensorMap tm_wr;   // Wr^T's tf32 parts (2, 3U, KP): hi then lo, box (32, 3 units, 1)
  const float* mxs;    // (T, B, 3U)
  const float* h0;     // (B, U)
  const float* brec;   // (3U)
  float* ys;           // (T, B, U) out
  float* mhs;          // (T, B, 3U) out
  unsigned* ctr;       // (R) zeros: the row tiles' step counters
  int T, B, U, BR, KC, stages;
};

template <int RB, int UN>
__global__ void __launch_bounds__(kFwdThreads, 1) gru_train_fwd_f32_kernel(const __grid_constant__ FwdArgs a) {
  constexpr bool kSplitK = RB == 64;           // the warpgroups take alternate K stages
  constexpr int MT = RB >= 256 ? 2 : 1;        // m64 tiles of a warpgroup
  constexpr int WROWS = 64 * MT;               // rows of a warpgroup
  constexpr int N = 3 * UN;                    // the block's columns
  constexpr int NA = N / 2;                    // accumulator floats of an m64 tile
  constexpr int STAGE = (RB + 2 * N) * 128;
  static_assert(kSplitK ? WROWS == RB : 2 * WROWS == RB, "a cut of 64, 128 or 256 rows");
  static_assert(MT * NA <= 96, "the f32 totals of a thread");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int S = a.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + (size_t)S * STAGE);
  uint64_t* empty = full + S;
  float* xchg = reinterpret_cast<float*>(empty + S);   // (NA, 128) where kSplitK
  const int T = a.T, B = a.B, U = a.U, G = 3 * U, KC = a.KC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int NG = U / UN, g = blockIdx.x % NG, r = blockIdx.x / NG;
  const int unit0 = g * UN;
  const int row0 = r * a.BR, row_end = min(B, row0 + a.BR);
  const int nchunks = (row_end - row0 + RB - 1) / RB;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kSplitK ? 4 : kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kWarps) {   // producer warpgroup: one thread issues the copies
    regs_dec<kProducerRegs>();
    if (warp == kWarps && lane == 0) {
      // the B half of ring position i (K stage kc): it does not wait on the step before
      auto load_b = [&](int i, int kc) {
        const int s = i % S;
        if (i >= S) mbar_wait(empty + s, (i / S - 1) & 1);
        unsigned char* st = base + (size_t)s * STAGE;
        mbar_expect(full + s, STAGE);
        tma_load_3d(st + RB * 128, &a.tm_wr, kKS * kc, 3 * unit0, 0, full + s);
        tma_load_3d(st + (RB + N) * 128, &a.tm_wr, kKS * kc, 3 * unit0, 1, full + s);
      };
      int it = 0;
      for (int t = 0; t < T; ++t)
        for (int c = 0; c < nchunks; ++c) {
          const int pre = c == 0 && t > 0 ? min(S, KC) : 0;
          for (int kc = 0; kc < pre; ++kc) load_b(it + kc, kc);
          if (pre) {
            tile_wait(a.ctr + r, (unsigned)(NG * t));
            fence_proxy_global();
          }
          for (int kc = 0; kc < KC; ++kc, ++it) {
            if (kc >= pre) load_b(it, kc);
            tma_load_3d(base + (size_t)(it % S) * STAGE, t == 0 ? &a.tm_h0 : &a.tm_ys, kKS * kc,
                        row0 + c * RB, t == 0 ? 0 : t - 1, full + it % S);
          }
        }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  const int wg = warp >> 2, wt = tid & 127;
  // the lane's rows of the stage's h tile: 16 (warp % 4) + g (+ 8) of each
  // of the warpgroup's m64 tiles
  const int arow = (kSplitK ? 0 : wg * WROWS) + 16 * (warp & 3) + gq;
  int it = 0;
  for (int t = 0; t < T; ++t) {
    const float* hp = t == 0 ? a.h0 : a.ys + (size_t)(t - 1) * B * U;
    const float* mx = a.mxs + (size_t)t * B * G;
    float* mh = a.mhs + (size_t)t * B * G;
    float* yo = a.ys + (size_t)t * B * U;
    for (int c = 0; c < nchunks; ++c) {
      float tot[MT][NA], acc[NA];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NA; ++i) tot[mt][i] = 0.f;
      for (int kc = 0; kc < KC; ++kc, ++it) {
        if (kSplitK && (it & 1) != wg) continue;
        const int s = it % S;
        mbar_wait(full + s, (it / S) & 1);
        const unsigned char* st = base + (size_t)s * STAGE;
        const uint32_t b_hi = smem_u32(st + RB * 128), b_lo = b_hi + N * 128;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          stage_product<N>(acc, st, arow + 64 * mt, b_hi, b_lo, tq);
          wg_wait<0>();
          wg_pin(acc);
#pragma unroll
          for (int i = 0; i < NA; ++i) tot[mt][i] = addf(tot[mt][i], acc[i]);
        }
        if (lane == 0) mbar_arrive(empty + s);
      }
      if constexpr (kSplitK) {
        // warpgroup 0's stages' sums, then warpgroup 1's
        if (wg == 1)
#pragma unroll
          for (int i = 0; i < NA; ++i) xchg[i * 128 + wt] = tot[0][i];
        bar_sync(2, kThreads);
        if (wg == 0)
#pragma unroll
          for (int i = 0; i < NA; ++i) tot[0][i] = addf(tot[0][i], xchg[i * 128 + wt]);
        bar_sync(2, kThreads);
      }
      // the gate phase: a lane holds the z, r and h sums of units 2 tq, + 1
      // of each of the block's 8-unit groups, for rows g and g + 8 of its
      // warp's 16
      if (!kSplitK || wg == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = row0 + c * RB + (kSplitK ? 0 : wg * WROWS) + 64 * mt +
                            16 * (warp & 3) + gq + 8 * hf;
            if (row >= row_end) continue;
#pragma unroll
            for (int jj = 0; jj < UN / 8; ++jj) {
              const int u = unit0 + 8 * jj + 2 * tq;
              float2 mxv[3], mhv[3];
#pragma unroll
              for (int gt = 0; gt < 3; ++gt) {
                const float* sum = tot[mt] + 4 * (3 * jj + gt) + 2 * hf;
                mxv[gt] = __ldg(reinterpret_cast<const float2*>(mx + (size_t)row * G + gt * U + u));
                const float2 bb = __ldg(reinterpret_cast<const float2*>(a.brec + gt * U + u));
                mhv[gt] = make_float2(addf(sum[0], bb.x), addf(sum[1], bb.y));
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
    }
    // the step's ys are out: every block of the row tile reads them next by TMA
    fence_proxy_global();
    bar_sync(1, kThreads);
    if (tid == 0 && t + 1 < T) tile_arrive(a.ctr + r);
  }
}

// ---------------------------------------------------------------------------
// backward recurrence
// ---------------------------------------------------------------------------

struct BwdArgs {
  CUtensorMap tm_dmx;  // dmxs (T, B, 3U) seen as (T, B, 2U), box (32, rows, 1)
  CUtensorMap tm_pl;   // plane (T, B, U), same box
  CUtensorMap tm_wr;   // Wr's tf32 parts (2, U, KP): hi then lo, box (32, units, 1)
  const float* mxs;    // (T, B, 3U)
  const float* mhs;    // (T, B, 3U)
  const float* ys;     // (T, B, U)
  const float* dys;    // (T, B, U)
  const float* h0;     // (B, U)
  float* dmxs;         // (T, B, 3U) out
  float* plane;        // (T, B, U) out: da * r
  float* dbrec;        // (3U) out
  float* dbpart;       // (R, 3U) scratch: each row tile's db_rec
  float* dh0;          // (B, U) out; the carry during the launch
  unsigned* ctr;       // (R) zeros
  int T, B, U, BR, KA, KC, stages;
};

template <int RB, int UN>
__global__ void __launch_bounds__(kRecThreads, 1) gru_train_bwd_f32_kernel(const __grid_constant__ BwdArgs a) {
  constexpr bool kSplitK = RB == 64;           // the warpgroups take alternate K stages
  constexpr int MT = RB >= 256 ? 2 : 1;        // m64 tiles of a warpgroup
  constexpr int WROWS = 64 * MT;               // rows of a warpgroup
  constexpr int NA = UN / 2;                   // accumulator floats of an m64 tile
  constexpr int QB = UN / 8;                   // 8-unit groups a row: threads per row in the gate phase
  constexpr int SLOTS = kThreads / QB;         // rows the gate phase takes at once
  constexpr int STAGE = (RB + 2 * UN) * 128;
  static_assert(kSplitK ? WROWS == RB : 2 * WROWS == RB, "a cut of 64, 128 or 256 rows");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int S = a.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + (size_t)S * STAGE);
  uint64_t* empty = full + S;
  float* xchg = reinterpret_cast<float*>(empty + S);   // (NA, 128) where kSplitK
  const int T = a.T, B = a.B, U = a.U, G = 3 * U, KA = a.KA, KC = a.KC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int NG = U / UN, g = blockIdx.x % NG, r = blockIdx.x / NG;
  const int unit0 = g * UN;
  const int row0 = r * a.BR, row_end = min(B, row0 + a.BR);
  const int nchunks = (row_end - row0 + RB - 1) / RB;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kSplitK ? 4 : kWarps);
    }
    mbar_init_fence();
  }
  // db_rec partial sums of this thread's rows (its 8-unit group q), every step
  const int q = tid % QB, slot = tid / QB;
  float sb[3][8];
#pragma unroll
  for (int gt = 0; gt < 3; ++gt)
#pragma unroll
    for (int ul = 0; ul < 8; ++ul) sb[gt][ul] = 0.f;
  __syncthreads();

  int it = 0;  // ring position: the producer and the consumers walk the same sequence
  for (int t = T - 1; t >= 0; --t) {
    // ---- gate phase: 8 units (group q) of one row a thread
    if (warp < kWarps) {
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
      fence_proxy_global();   // dmx and the plane are read next by TMA
    }
    __syncthreads();
    if (tid == 0) {
      tile_arrive(a.ctr + r);
      tile_wait(a.ctr + r, (unsigned)(NG * (T - t)));
    }
    __syncthreads();

    // ---- carry[rows, own units] += dmh[rows, 0:3U] . Wr[own units]^T
    if (warp == kWarps) {
      if (lane == 0) {
        fence_proxy_global();
        for (int c = 0; c < nchunks; ++c)
          for (int kc = 0; kc < KC; ++kc, ++it) {
            const int s = it % S, k = kKS * kc;
            if (it >= S) mbar_wait(empty + s, (it / S - 1) & 1);
            unsigned char* st = base + (size_t)s * STAGE;
            mbar_expect(full + s, (RB + 2 * UN) * 128);
            tma_load_3d(st, k < KA ? &a.tm_dmx : &a.tm_pl, k < KA ? k : k - KA, row0 + c * RB, t,
                        full + s);
            tma_load_3d(st + RB * 128, &a.tm_wr, k, unit0, 0, full + s);
            tma_load_3d(st + (RB + UN) * 128, &a.tm_wr, k, unit0, 1, full + s);
          }
      }
    } else {
      const int wg = warp >> 2, wt = tid & 127;
      // the lane's rows of the stage's dmh tile (K-major, 128-byte swizzle):
      // 16 (warp % 4) + g (+ 8) of each of the warpgroup's m64 tiles; with
      // that swizzle the 32 lanes' 4-byte reads of a fragment hit 32 banks
      const int arow = (kSplitK ? 0 : wg * WROWS) + 16 * (warp & 3) + gq;
      for (int c = 0; c < nchunks; ++c) {
        float tot[MT][NA], acc[MT][NA];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < NA; ++i) tot[mt][i] = 0.f;
        for (int kc = 0; kc < KC; ++kc, ++it) {
          if (kSplitK && (it & 1) != wg) continue;
          const int s = it % S;
          mbar_wait(full + s, (it / S) & 1);
          const unsigned char* st = base + (size_t)s * STAGE;
          // dmh's fragments, split into tf32 hi and lo as they are read, one
          // k-step at a time into two sets of registers: a set is written
          // again only once the products of two k-steps back are done
          const uint32_t b_hi = smem_u32(st + RB * 128), b_lo = b_hi + UN * 128;
          uint32_t ah[2][MT][4], al[2][MT][4];
#pragma unroll
          for (int ks = 0; ks < kKS / 8; ++ks) {
            const int f = ks & 1;
            if (ks >= 2) wg_wait<1>();
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int row = arow + 64 * mt + 8 * (e & 1), k = 8 * ks + tq + 4 * (e >> 1);
                split_tf32(*reinterpret_cast<const float*>(st + swz4(row, k)), ah[f][mt][e],
                           al[f][mt][e]);
              }
            wg_fence();
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              wgmma_tf32_rs<UN>(acc[mt], al[f][mt], desc_k(b_hi + 32 * ks), ks > 0);
              wgmma_tf32_rs<UN>(acc[mt], ah[f][mt], desc_k(b_lo + 32 * ks), 1);
              wgmma_tf32_rs<UN>(acc[mt], ah[f][mt], desc_k(b_hi + 32 * ks), 1);
            }
            wg_commit();
          }
          wg_wait<0>();
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) wg_pin(acc[mt]);
          if (lane == 0) mbar_arrive(empty + s);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < NA; ++i) tot[mt][i] = addf(tot[mt][i], acc[mt][i]);
        }
        if constexpr (kSplitK) {
          // warpgroup 0's stages' sums, then warpgroup 1's
          if (wg == 1)
#pragma unroll
            for (int i = 0; i < NA; ++i) xchg[i * 128 + wt] = tot[0][i];
          bar_sync(3, kThreads);
          if (wg == 0)
#pragma unroll
            for (int i = 0; i < NA; ++i) tot[0][i] = addf(tot[0][i], xchg[i * 128 + wt]);
          bar_sync(3, kThreads);
          if (wg == 1) continue;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = row0 + c * RB + (kSplitK ? 0 : wg * WROWS) + 64 * mt +
                            16 * (warp & 3) + gq + 8 * hf;
            if (row >= row_end) continue;
#pragma unroll
            for (int j = 0; j < UN / 8; ++j) {
              float2* cp = reinterpret_cast<float2*>(a.dh0 + (size_t)row * U + unit0 + 8 * j +
                                                     2 * tq);
              const float2 v = __ldcg(cp);
              *cp = make_float2(addf(v.x, tot[mt][4 * j + 2 * hf]),
                                addf(v.y, tot[mt][4 * j + 2 * hf + 1]));
            }
          }
      }
    }
    __syncthreads();  // the gate phase of the next step reads the carry
  }

  // db_rec: the threads' partial sums in thread order, then the row tiles in order
  float* red = reinterpret_cast<float*>(base);  // (kThreads, 24)
  if (warp < kWarps) {
#pragma unroll
    for (int gt = 0; gt < 3; ++gt)
#pragma unroll
      for (int ul = 0; ul < 8; ++ul) red[tid * 24 + gt * 8 + ul] = sb[gt][ul];
  }
  __syncthreads();
  for (int i = tid; i < 3 * UN; i += kRecThreads) {
    const int gt = i / UN, ul = i % UN;
    float s = 0.f;
    for (int j = ul / 8; j < kThreads; j += QB) s = addf(s, red[j * 24 + gt * 8 + ul % 8]);
    a.dbpart[(size_t)r * G + gt * U + unit0 + ul] = s;
  }
  cg::this_grid().sync();
  if (r == 0) {
    const int R = gridDim.x / NG;
    for (int i = tid; i < 3 * UN; i += kRecThreads) {
      const int col = (i / UN) * U + unit0 + i % UN;
      float s = 0.f;
      for (int j = 0; j < R; ++j) s = addf(s, __ldcg(a.dbpart + (size_t)j * G + col));
      a.dbrec[col] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// dWr = [h0; ys[0:T-1]]^T . [dmx[:, :, 0:2U] | plane]
// ---------------------------------------------------------------------------

struct DwrArgs {
  CUtensorMap tm_h0;   // h0 as (1, B, U), box (32, 32, 1), 128-byte swizzle
  CUtensorMap tm_ys;   // ys (T, B, U), same box
  CUtensorMap tm_dmx;  // dmxs (T, B, 3U) seen as (T, B, 2U), box (128, 32, 1), no swizzle
  CUtensorMap tm_pl;   // plane (T, B, U), same box
  float* out;          // (P, U, 3U): each K partition's sums (dWr itself where P = 1)
  int T, B, U, KA, P;
};

// K row of a stage (0..31) that k-slot s of k-step ks holds: 8 ks + 2 (s % 4)
// + s / 4. A lane's A fragment (slots q and q + 4 of rows g, g + 8) then reads
// rows 8 ks + 2q (+1), whose swizzle spreads the 32 lanes over 32 banks.
__device__ __forceinline__ int dwr_krow(int ks, int s) { return 8 * ks + 2 * (s & 3) + (s >> 2); }

// K is walked in stages of 32 rows: stage st is rows 32 (st % nb).. of step
// t = st / nb (nb = ceil(B / 32), rows past B read as zeros); partition p
// takes stages [p NS / P, (p + 1) NS / P) of the NS = T nb.
__global__ void __launch_bounds__(kDThreads, 1) gru_train_dwr_f32_kernel(const __grid_constant__ DwrArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  // kDStages x (A: 4 swizzled boxes of 32 K rows x 32 columns, B: 32 x 128)
  unsigned char* raw = base;
  unsigned char* split = raw + kDStages * kDRawBytes;      // 2 x (B hi, B lo)
  uint64_t* full = reinterpret_cast<uint64_t*>(split + 2 * kDSplitBytes);
  uint64_t* empty = full + kDStages;
  const int B = a.B, U = a.U, G = 3 * U, KA = a.KA;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * kDN, m0 = blockIdx.y * kDM, p = blockIdx.z;
  const int nb = (B + kKS - 1) / kKS;
  const long long ns = (long long)a.T * nb;
  const int st0 = (int)(ns * p / a.P), nst = (int)(ns * (p + 1) / a.P) - st0;

  if (tid == 0) {
    for (int s = 0; s < kDStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {
    if (lane == 0) {
      // A boxes wholly past U are not copied: they feed only rows not written
      const int boxes = min(kDM / 32, (U - m0 + 31) / 32);
      for (int i = 0; i < nst; ++i) {
        const int s = i % kDStages, st = st0 + i, t = st / nb, b0 = (st % nb) * kKS;
        if (i >= kDStages) mbar_wait(empty + s, (i / kDStages - 1) & 1);
        unsigned char* buf = raw + (size_t)s * kDRawBytes;
        mbar_expect(full + s, (boxes * 32 + kDN) * kKS * 4);
        for (int j = 0; j < boxes; ++j)
          tma_load_3d(buf + j * 32 * kKS * 4, t == 0 ? &a.tm_h0 : &a.tm_ys, m0 + 32 * j, b0,
                      t == 0 ? 0 : t - 1, full + s);
        tma_load_3d(buf + kDM * kKS * 4, n0 < KA ? &a.tm_dmx : &a.tm_pl, n0 < KA ? n0 : n0 - KA,
                    b0, t, full + s);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  // the lane's A rows (columns of h_prev) in the warpgroup's 64: their box
  // and column there
  const int am = 64 * wg + 16 * (warp & 3) + gq;
  // each stage's products are summed on the tensor cores (12 chained
  // additions), then added into tot in f32, in K order
  float tot[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = 0.f;
  for (int i = 0; i < nst; ++i) {
    const int s = i % kDStages;
    mbar_wait(full + s, (i / kDStages) & 1);
    const unsigned char* ra = raw + (size_t)s * kDRawBytes;
    const float* rb = reinterpret_cast<const float*>(ra + kDM * kKS * 4);   // [32][128]
    if (i > 0) {
      // the products of stage i - 1, done: into the totals
      wg_wait<0>();
      wg_pin(acc);
#pragma unroll
      for (int e = 0; e < 64; ++e) tot[e] = addf(tot[e], acc[e]);
    }
    unsigned char* sp = split + (size_t)(i & 1) * kDSplitBytes;
    // B's transposing split: a thread takes the 4 K rows of one column that
    // fill 4 consecutive k-slots (16 bytes) of its row of the K-major tile and
    // writes their hi and lo parts; the lanes of a warp take 32 consecutive
    // columns
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qd = j * kThreads + tid, n = qd & 127, kq = qd >> 7;
      const float* src = rb + n;
      float4 hi, lo;
      split4(src[dwr_krow(kq >> 1, 4 * (kq & 1)) * 128], src[dwr_krow(kq >> 1, 4 * (kq & 1) + 1) * 128],
             src[dwr_krow(kq >> 1, 4 * (kq & 1) + 2) * 128], src[dwr_krow(kq >> 1, 4 * (kq & 1) + 3) * 128],
             hi, lo);
      unsigned char* dst = sp + swz4(n, 4 * kq);
      *reinterpret_cast<float4*>(dst) = hi;
      *reinterpret_cast<float4*>(dst + kDN * kKS * 4) = lo;
    }
    fence_async_smem();
    bar_sync(1, kThreads);   // the split of stage i is written; every product of i - 1 done
    const uint32_t bh = smem_u32(sp), bl = bh + kDN * kKS * 4;
    // A's fragments from the swizzled boxes, split into tf32 hi and lo as they
    // are read, one k-step at a time into two sets of registers
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int ks = 0; ks < kKS / 8; ++ks) {
      const int f = ks & 1;
      if (ks >= 2) wg_wait<1>();
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = am + 8 * (e & 1), k = dwr_krow(ks, tq + 4 * (e >> 1));
        split_tf32(*reinterpret_cast<const float*>(ra + (m >> 5) * 32 * kKS * 4 + swz4(k, m & 31)),
                   ah[f][e], al[f][e]);
      }
      wg_fence();
      wgmma_tf32_rs<128>(acc, al[f], desc_k(bh + 32 * ks), ks > 0);
      wgmma_tf32_rs<128>(acc, ah[f], desc_k(bl + 32 * ks), 1);
      wgmma_tf32_rs<128>(acc, ah[f], desc_k(bh + 32 * ks), 1);
      wg_commit();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);   // the stage's raw operands are read
  }
  if (nst > 0) {
    wg_wait<0>();
    wg_pin(acc);
#pragma unroll
    for (int e = 0; e < 64; ++e) tot[e] = addf(tot[e], acc[e]);
  }
  float* out = a.out + (size_t)p * U * G;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = m0 + 64 * wg + 16 * (warp & 3) + gq + 8 * hf;
    if (m >= U) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * tq;
      const int col = n < 2 * U ? n : (n >= KA && n < KA + U ? 2 * U + n - KA : -1);
      if (col >= 0)
        *reinterpret_cast<float2*>(out + (size_t)m * G + col) =
            make_float2(tot[4 * j + 2 * hf], tot[4 * j + 2 * hf + 1]);
    }
  }
}

// dWr = the K partitions' sums added in partition order
__global__ void gru_train_dwr_f32_reduce(const float4* __restrict__ part, float4* __restrict__ dwr,
                                         int n4, int P) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int p = 1; p < P; ++p) {
      const float4 v = part[(size_t)p * n4 + i];
      s = make_float4(addf(s.x, v.x), addf(s.y, v.y), addf(s.z, v.z), addf(s.w, v.w));
    }
    dwr[i] = s;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// an f32 array (d2, d1, d0 of every `ld`) as a 3-D tensor map read in (box0,
// box1, 1) boxes; reads past the array give zeros
int make_map(CUtensorMap* m, const void* ptr, int d0, int d1, int d2, int ld, int box0, int box1,
             CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)ld * 4 * d1};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t es[3] = {1, 1, 1};
  const CUresult res = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                          strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

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
    if (per_sm * sms < (int)(grid.x * grid.y * grid.z)) return (int)cudaErrorCooperativeLaunchTooLarge;
    err = cudaLaunchCooperativeKernel((void*)kernel, grid, threads, kargs, smem,
                                      (cudaStream_t)stream);
  } else {
    err = cudaLaunchKernel((void*)kernel, grid, threads, kargs, smem, (cudaStream_t)stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the recurrences' cuts (rows, units); a row tile holds whole chunks of `rows`
bool fwd_cut(int rows, int units) {
  if (rows == 128) return units == 64 || units == 32;
  if (rows == 256) return units == 32;
  return rows == 64 && (units == 8 || units == 16 || units == 32 || units == 64);
}
bool bwd_cut(int rows, int units) {
  if (rows == 128) return units == 64;
  if (rows == 256) return units == 32;
  return rows == 64 && (units == 8 || units == 16 || units == 32 || units == 64 || units == 128);
}
int cut_tile_rows(int B, int R, int rows) { return round_up((B + R - 1) / R, rows); }
bool cut_takes(int B, int U, int rows, int units, int R) {
  return U > 0 && U % 8 == 0 && U % units == 0 && R >= 1 &&
         (R - 1) * cut_tile_rows(B, R, rows) < B;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int RB, int UN>
int launch_fwd(const FwdArgs& a, int grid, void* stream) {
  return launch(gru_train_fwd_f32_kernel<RB, UN>, a, dim3(grid), kFwdThreads, smem_bytes(0, RB, UN),
                true, stream);
}

template <int RB, int UN>
int launch_bwd(const BwdArgs& a, int grid, void* stream) {
  return launch(gru_train_bwd_f32_kernel<RB, UN>, a, dim3(grid), kRecThreads, smem_bytes(1, RB, UN),
                true, stream);
}

}  // namespace

// Bytes of dynamic shared memory a launch takes: part 0 forward, 1 backward
// recurrence (x = rows, y = units of the cut), 2 the dWr GEMM.
extern "C" long long gxt_gru_train_f32_smem(int part, int x, int y) {
  return (long long)smem_bytes(part, x, y);
}

// `wrt` (2, 3U, KP) is Wr's transpose as tf32 hi and lo parts (KP = U rounded
// up to 32, zeros past U), row 24 J + 8 gate + c holding column gate U + 8 J +
// c of Wr; `ctr` (R) must arrive zeroed.
extern "C" int gxt_gru_train_fwd_f32(const float* mxs, const float* h0, const float* wrt,
                                     const float* brec, float* ys, float* mhs, void* ctr, int T,
                                     int B, int U, int rows, int units, int R, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (!fwd_cut(rows, units) || !cut_takes(B, U, rows, units, R)) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {mxs, h0, wrt, ys, mhs};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  FwdArgs a;
  a.KC = (U + kKS - 1) / kKS;
  const int KP = a.KC * kKS;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  int code;
  if ((code = make_map(&a.tm_h0, h0, U, B, 1, U, kKS, rows, sw))) return code;
  if ((code = make_map(&a.tm_ys, ys, U, B, T, U, kKS, rows, sw))) return code;
  if ((code = make_map(&a.tm_wr, wrt, KP, 3 * U, 2, KP, kKS, 3 * units, sw))) return code;
  a.mxs = mxs; a.h0 = h0; a.brec = brec; a.ys = ys; a.mhs = mhs;
  a.ctr = static_cast<unsigned*>(ctr);
  a.T = T; a.B = B; a.U = U; a.BR = cut_tile_rows(B, R, rows);
  a.stages = ring_stages(rows, 3 * units);
  const int grid = R * (U / units);
  if (rows == 256) return launch_fwd<256, 32>(a, grid, stream);
  if (rows == 128) return units == 64 ? launch_fwd<128, 64>(a, grid, stream)
                                      : launch_fwd<128, 32>(a, grid, stream);
  switch (units) {
    case 8: return launch_fwd<64, 8>(a, grid, stream);
    case 16: return launch_fwd<64, 16>(a, grid, stream);
    case 32: return launch_fwd<64, 32>(a, grid, stream);
    default: return launch_fwd<64, 64>(a, grid, stream);
  }
}

// `wrs` (2, U, KP) is Wr's tf32 hi and lo parts in the carry product's K
// order (KP = KA + U rounded up to 32, zeros elsewhere); `plane` (T, B, U) and
// `dbpart` (R, 3U) are scratch the launch fills; `ctr` (R) must arrive zeroed.
extern "C" int gxt_gru_train_bwd_f32(const float* mxs, const float* mhs, const float* ys,
                                     const float* dys, const float* h0, const float* wrs,
                                     float* dmxs, float* plane, float* dbrec, float* dbpart,
                                     float* dh0, void* ctr, int T, int B, int U, int rows,
                                     int units, int R, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (!bwd_cut(rows, units) || !cut_takes(B, U, rows, units, R)) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {mxs, mhs, ys, dys, h0, wrs, dmxs, plane, dh0};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  BwdArgs a;
  a.KA = round_up(2 * U, kKS);
  a.KC = (a.KA + U + kKS - 1) / kKS;
  const int KP = a.KC * kKS;
  int code;
  if ((code = make_map(&a.tm_dmx, dmxs, 2 * U, B, T, 3 * U, kKS, rows, CU_TENSOR_MAP_SWIZZLE_128B)))
    return code;
  if ((code = make_map(&a.tm_pl, plane, U, B, T, U, kKS, rows, CU_TENSOR_MAP_SWIZZLE_128B)))
    return code;
  if ((code = make_map(&a.tm_wr, wrs, KP, U, 2, KP, kKS, units, CU_TENSOR_MAP_SWIZZLE_128B)))
    return code;
  a.mxs = mxs; a.mhs = mhs; a.ys = ys; a.dys = dys; a.h0 = h0;
  a.dmxs = dmxs; a.plane = plane; a.dbrec = dbrec; a.dbpart = dbpart; a.dh0 = dh0;
  a.ctr = static_cast<unsigned*>(ctr);
  a.T = T; a.B = B; a.U = U; a.BR = cut_tile_rows(B, R, rows);
  a.stages = ring_stages(rows, units);
  const int grid = R * (U / units);
  if (rows == 128) return launch_bwd<128, 64>(a, grid, stream);
  if (rows == 256) return launch_bwd<256, 32>(a, grid, stream);
  switch (units) {
    case 8: return launch_bwd<64, 8>(a, grid, stream);
    case 16: return launch_bwd<64, 16>(a, grid, stream);
    case 32: return launch_bwd<64, 32>(a, grid, stream);
    case 64: return launch_bwd<64, 64>(a, grid, stream);
    default: return launch_bwd<64, 128>(a, grid, stream);
  }
}

// `part` (P, U, 3U) is scratch for the K partitions' sums (unused where P = 1)
extern "C" int gxt_gru_train_dwr_f32(const float* h0, const float* ys, const float* dmxs,
                                     const float* plane, float* dwr, float* part, int T, int B,
                                     int U, int P, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (U <= 0 || U % 8 || P < 1 || (long long)P > (long long)T * ((B + kKS - 1) / kKS))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(h0) || !aligned16(ys) || !aligned16(dmxs) || !aligned16(plane) ||
      !aligned16(dwr) || (P > 1 && !aligned16(part)))
    return (int)cudaErrorMisalignedAddress;
  DwrArgs a;
  a.KA = round_up(2 * U, kDN);
  int code;
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if ((code = make_map(&a.tm_h0, h0, U, B, 1, U, 32, kKS, sw))) return code;
  if ((code = make_map(&a.tm_ys, ys, U, B, T, U, 32, kKS, sw))) return code;
  if ((code = make_map(&a.tm_dmx, dmxs, 2 * U, B, T, 3 * U, kDN, kKS, none))) return code;
  if ((code = make_map(&a.tm_pl, plane, U, B, T, U, kDN, kKS, none))) return code;
  a.out = P > 1 ? part : dwr;
  a.T = T; a.B = B; a.U = U; a.P = P;
  const dim3 grid((a.KA + U + kDN - 1) / kDN, (U + kDM - 1) / kDM, P);
  code = launch(gru_train_dwr_f32_kernel, a, grid, kDThreads, smem_bytes(2, 0, 0), false,
                stream);
  if (code || P == 1) return code;
  int n4 = 3 * U * U / 4;
  const float4* src = reinterpret_cast<const float4*>(part);
  float4* dst = reinterpret_cast<float4*>(dwr);
  void* rargs[] = {&src, &dst, &n4, &P};
  const int blocks = (n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024;
  const cudaError_t err = cudaLaunchKernel((void*)gru_train_dwr_f32_reduce, dim3(blocks),
                                           dim3(256), rargs, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
