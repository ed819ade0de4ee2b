// Fused GRU training sequence: the whole time loop of the forward pass and
// of the backward pass, each in ONE cooperative launch.
//
//   gxt_gru_train_fwd  replaces ggml_experiments_tpu/ops/fused_gru_train.py
//                      `_fwd_core_call` (pallas_call :186; body `_fwd_kernel`
//                      :54, `_gates` :45)
//   gxt_gru_train_bwd  replaces the same file's `_bwd_core_call` (pallas_call
//                      :285; body `_bwd_kernel` :81)
//
// Arithmetic, as the TPU bodies have it (bf16 storage, f32 sums and gate
// math): forward, per step, mh = h.Wr + b_rec is summed in f32, rounded to
// bf16 and stored; the gates use the ROUNDED mh; h' = z*h + (1-z)*g is
// rounded to bf16 and is both the output and the next step's operand.
// Backward, time reversed: gates rebuilt from the stored mx and mh;
// dh = dy + carry (f32); dmx = [daz, dar, da] and dmh = [daz, dar, da*r]
// rounded to bf16; carry = dh*z + dmh.Wr^T (f32); dWr += h_prev^T.dmh and
// db_rec += sum_b dmh (the unrounded dmh) summed in f32 over every (b, t) and
// written once; dh0 is the last carry. Every product the TPU bodies compute is
// computed here, on tensor cores (mma.sync m16n8k16, bf16 in, f32 sums).
//
// Bound on an H100 at the training shape (T=100, B=1024, U=1024): forward
// 2*T*B*U*3U = 0.64 TFLOP against 1.47 GB streamed (mx in, y and mh out), so
// the operations bound it (0.65 ms at the bf16 tensor-core peak against
// 0.44 ms of HBM time); backward twice the operations against 2.3 GB.
//
// The TPU kernel keeps all of Wr and the f32 dWr accumulator in one core's
// VMEM and walks the batch tiles and time steps in order. A Hopper block has
// 227 KB, so the work is spread over the grid as in gru_persistent.cu: block
// i owns 8 hidden units for the whole launch and the grid steps through time
// together, one grid sync a step.
//   * forward: the block keeps its 24 gate columns of Wr in shared memory
//     ([column][K], bf16). Per step each warp takes 16-row batch tiles, reads
//     h_{t-1} (the previous step's y, or h0) straight from L2 as 16-byte A
//     fragments, and ends with all three gates of its (row, unit) pairs in
//     registers, so mh, the gates and h' need no exchange.
//   * backward: the block keeps its 8 ROWS of Wr ([unit][3U]) and its 24
//     COLUMNS of dWr (all U rows, f32, 96 KB) in shared memory. A step is:
//     gate phase for the block's units and every batch row (elementwise;
//     writes dmx, its columns of dmh to a global staging buffer and to shared
//     memory, its rows of h_{t-1}^T to a second staging buffer, and dh*z to
//     the carry) -> grid sync -> carry[:, own units] += dmh.Wr[own rows]^T
//     (K = 3U, dmh read from L2) and dWr[:, own columns] += h_{t-1}^T.dmh[:,
//     own columns] (K = B, h_{t-1}^T read from L2). Both staging buffers are
//     double-buffered by the parity of t, which is why one grid sync a step is
//     enough. No sum crosses a block and no atomic is used: the order of every
//     sum is fixed, so two launches on the same inputs give the same bits.
//   * the K index of an mma is permuted (a thread's 16-byte load feeds slots
//     2tq, 2tq+1, 2tq+8, 2tq+9 of two mmas with eight consecutive k); A and B
//     use the same permutation, so the sums are over the same terms.
// Values written during the launch by other blocks (y, dmh, h^T) and the
// carry are read with __ldcg, so no stale L1 line survives a grid sync.
//
// Shapes: U a multiple of 8 with U / 8 blocks co-resident (U <= 1056 on 132
// SMs); any B >= 1 whose backward staging fits shared memory (B <= 1760 at
// U = 1024). The launch functions return cudaErrorInvalidValue or
// cudaErrorCooperativeLaunchTooLarge otherwise; the Python wrapper checks
// the same conditions first and names the shape.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUB = 8;    // hidden units per block
constexpr int kNC = 24;   // gate columns per block (3 gates x kUB)
constexpr int kPF = 4;    // 32-wide K steps whose loads are in flight together

struct FwdArgs {
  const bf16* mxs;    // (T, B, 3U)
  const bf16* h0;     // (B, U)
  const bf16* wr;     // (U, 3U)
  const float* brec;  // (3U)
  bf16* ys;           // (T, B, U) out
  bf16* mhs;          // (T, B, 3U) out
  int T, B, U, ldw;
};

struct BwdArgs {
  const bf16* mxs;    // (T, B, 3U)
  const bf16* mhs;    // (T, B, 3U)
  const bf16* ys;     // (T, B, U)
  const bf16* dys;    // (T, B, U)
  const bf16* h0;     // (B, U)
  const bf16* wr;     // (U, 3U)
  bf16* dmxs;         // (T, B, 3U) out
  float* dwr;         // (U, 3U) out
  float* dbrec;       // (3U) out
  float* dh0;         // (B, U) out; the carry during the launch
  bf16* dmh;          // (2, B, 3U) staging
  bf16* hpT;          // (2, U, Bp) staging, columns B..Bp-1 zero
  int T, B, U, Bp, ldw, ldb;
};

// Row length (bf16 elements) for a shared-memory operand of K columns read
// as 16-byte mma fragments: whole 32-wide K steps, and (ld / 2) % 32 == 16 so
// that the eight lanes of a quarter warp (two rows x four 16-byte pieces)
// hit 32 distinct banks.
__host__ __device__ inline int padded_ld(int k) {
  int ld = (k + 31) & ~31;
  if ((ld / 2) % 32 != 16) ld += 32;
  return ld;
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

// c += a (16x16, row-major) . b (16x8, column-major); bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[n] += A (16 rows x K, two row pointers per lane, in global memory) .
// B_n (K x 8, n-th group of 8 rows of a shared [column][K] operand), for NT
// groups. `a0`/`a1` point at the lane's two rows (null: a row of zeros),
// already offset by 8*tq; `bs` points at the lane's column of group 0, offset
// likewise; `bstep` is the distance between groups. K is walked in 32-wide
// steps, kPF of them loaded before any is used; 16-byte pieces at or past
// `k_end` read as zeros.
template <int NT>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], const bf16* a0, const bf16* a1,
                                         const bf16* bs, int bstep, int k_end, int tq) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < k_end; k0 += 32 * kPF) {
    uint4 x0[kPF], x1[kPF];
#pragma unroll
    for (int q = 0; q < kPF; ++q) {
      const int k = k0 + 32 * q;
      const bool in = k + 8 * tq < k_end;
      x0[q] = (a0 && in) ? __ldcg(reinterpret_cast<const uint4*>(a0 + k)) : zero;
      x1[q] = (a1 && in) ? __ldcg(reinterpret_cast<const uint4*>(a1 + k)) : zero;
    }
#pragma unroll
    for (int q = 0; q < kPF; ++q) {
      const int k = k0 + 32 * q;
      if (k >= k_end) break;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint4 w = *reinterpret_cast<const uint4*>(bs + (size_t)n * bstep + k);
        mma_bf16(acc[n], x0[q].x, x1[q].x, x0[q].y, x1[q].y, w.x, w.y);
        mma_bf16(acc[n], x0[q].z, x1[q].z, x0[q].w, x1[q].w, w.z, w.w);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1) gru_train_fwd_kernel(FwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wr_s = reinterpret_cast<bf16*>(smem_raw);  // (kNC, ldw): [gate*8 + unit][K]
  const int T = a.T, B = a.B, U = a.U, G = 3 * U, ldw = a.ldw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int unit0 = blockIdx.x * kUB;

  for (int i = tid; i < kNC * ldw; i += kThreads) {
    const int c = i / ldw, k = i % ldw;
    wr_s[i] = k < U ? a.wr[(size_t)k * G + (c >> 3) * U + unit0 + (c & 7)]
                    : __float2bfloat16_rn(0.f);
  }
  // the lane's two units (2tq, 2tq+1) of each gate
  float br[3][2];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    br[g][0] = a.brec[g * U + unit0 + 2 * tq];
    br[g][1] = a.brec[g * U + unit0 + 2 * tq + 1];
  }
  __syncthreads();

  const int mtiles = (B + 15) / 16;
  for (int t = 0; t < T; ++t) {
    const bf16* hp = t == 0 ? a.h0 : a.ys + (size_t)(t - 1) * B * U;
    const bf16* mx = a.mxs + (size_t)t * B * G;
    bf16* mh = a.mhs + (size_t)t * B * G;
    bf16* yo = a.ys + (size_t)t * B * U;
    for (int mt = warp; mt < mtiles; mt += kWarps) {
      const int row[2] = {mt * 16 + gq, mt * 16 + gq + 8};
      // this lane's operands of the gate math, asked for before the products
      uint32_t mxv[2][3], hv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = row[j] < B;
        const size_t o = (size_t)row[j] * G + unit0 + 2 * tq;
#pragma unroll
        for (int g = 0; g < 3; ++g)
          mxv[j][g] = ok ? __ldg(reinterpret_cast<const uint32_t*>(mx + o + g * U)) : 0u;
        hv[j] = ok ? __ldcg(reinterpret_cast<const uint32_t*>(hp + (size_t)row[j] * U + unit0 +
                                                              2 * tq))
                   : 0u;
      }
      float acc[3][4];
#pragma unroll
      for (int g = 0; g < 3; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
      mma_rows<3>(acc, row[0] < B ? hp + (size_t)row[0] * U + 8 * tq : nullptr,
                  row[1] < B ? hp + (size_t)row[1] * U + 8 * tq : nullptr,
                  wr_s + (size_t)gq * ldw + 8 * tq, 8 * ldw, U, tq);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (row[j] >= B) continue;
        uint32_t mhv[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          mhv[g] = pack_bf16(addf(acc[g][2 * j], br[g][0]), addf(acc[g][2 * j + 1], br[g][1]));
          *reinterpret_cast<uint32_t*>(mh + (size_t)row[j] * G + g * U + unit0 + 2 * tq) = mhv[g];
        }
        float hn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float mxz = e ? hi_f(mxv[j][0]) : lo_f(mxv[j][0]);
          const float mxr = e ? hi_f(mxv[j][1]) : lo_f(mxv[j][1]);
          const float mxh = e ? hi_f(mxv[j][2]) : lo_f(mxv[j][2]);
          const float mhz = e ? hi_f(mhv[0]) : lo_f(mhv[0]);
          const float mhr = e ? hi_f(mhv[1]) : lo_f(mhv[1]);
          const float mhh = e ? hi_f(mhv[2]) : lo_f(mhv[2]);
          const float hprev = e ? hi_f(hv[j]) : lo_f(hv[j]);
          const float z = sigmoidf(addf(mxz, mhz));
          const float r = sigmoidf(addf(mxr, mhr));
          const float gg = tanhf(addf(mxh, mulf(r, mhh)));
          hn[e] = addf(mulf(z, hprev), mulf(subf(1.f, z), gg));
        }
        *reinterpret_cast<uint32_t*>(yo + (size_t)row[j] * U + unit0 + 2 * tq) =
            pack_bf16(hn[0], hn[1]);
      }
    }
    grid.sync();
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  f[0] = lo_f(v.x); f[1] = hi_f(v.x); f[2] = lo_f(v.y); f[3] = hi_f(v.y);
  f[4] = lo_f(v.z); f[5] = hi_f(v.z); f[6] = lo_f(v.w); f[7] = hi_f(v.w);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

__global__ void __launch_bounds__(kThreads, 1) gru_train_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T = a.T, B = a.B, U = a.U, G = 3 * U, Bp = a.Bp, ldw = a.ldw, ldb = a.ldb;
  bf16* wr_s = reinterpret_cast<bf16*>(smem_raw);     // (kUB, ldw): the block's rows of Wr
  bf16* dmh_s = wr_s + (size_t)kUB * ldw;              // (kNC, ldb): [gate*8 + unit][b]
  float* dwr_s = reinterpret_cast<float*>(dmh_s + (size_t)kNC * ldb);  // (U, kNC) f32
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int unit0 = blockIdx.x * kUB;
  const bf16 zero_bf = __float2bfloat16_rn(0.f);

  for (int i = tid; i < kUB * ldw; i += kThreads) {
    const int ul = i / ldw, c = i % ldw;
    wr_s[i] = c < G ? a.wr[(size_t)(unit0 + ul) * G + c] : zero_bf;
  }
  for (int i = tid; i < kNC * ldb; i += kThreads) dmh_s[i] = zero_bf;
  for (int i = tid; i < U * kNC; i += kThreads) dwr_s[i] = 0.f;
  // db_rec partial sums of this thread's batch rows, every step
  float sb[3][kUB];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int ul = 0; ul < kUB; ++ul) sb[g][ul] = 0.f;
  __syncthreads();

  const int btiles = (B + 15) / 16, utiles = (U + 15) / 16;
  for (int t = T - 1; t >= 0; --t) {
    const int p = t & 1;
    const bf16* mx = a.mxs + (size_t)t * B * G;
    const bf16* mh = a.mhs + (size_t)t * B * G;
    const bf16* hp = t == 0 ? a.h0 : a.ys + (size_t)(t - 1) * B * U;
    const bf16* dy = a.dys + (size_t)t * B * U;
    bf16* dmx = a.dmxs + (size_t)t * B * G;
    bf16* dmh = a.dmh + (size_t)p * B * G;
    bf16* hpT = a.hpT + (size_t)p * U * Bp;

    // ---- gate phase: the block's 8 units of batch row b, one row a thread
    for (int b = tid; b < B; b += kThreads) {
      const size_t og = (size_t)b * G + unit0, ou = (size_t)b * U + unit0;
      float mxf[3][8], mhf[3][8], hpf[8], dyf[8], cf[8];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        unpack8(__ldg(reinterpret_cast<const uint4*>(mx + og + g * U)), mxf[g]);
        unpack8(__ldg(reinterpret_cast<const uint4*>(mh + og + g * U)), mhf[g]);
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
      float ox[3][8], oh[3][8], cz[8];
#pragma unroll
      for (int ul = 0; ul < 8; ++ul) {
        const float z = sigmoidf(addf(mxf[0][ul], mhf[0][ul]));
        const float r = sigmoidf(addf(mxf[1][ul], mhf[1][ul]));
        const float mhh = mhf[2][ul];
        const float gg = tanhf(addf(mxf[2][ul], mulf(r, mhh)));
        const float dh = addf(dyf[ul], cf[ul]);
        const float dz = mulf(dh, subf(hpf[ul], gg));
        const float da = mulf(mulf(dh, subf(1.f, z)), subf(1.f, mulf(gg, gg)));
        const float dr = mulf(da, mhh);
        const float daz = mulf(mulf(dz, z), subf(1.f, z));
        const float dar = mulf(mulf(dr, r), subf(1.f, r));
        const float dah = mulf(da, r);
        ox[0][ul] = daz; ox[1][ul] = dar; ox[2][ul] = da;
        oh[0][ul] = daz; oh[1][ul] = dar; oh[2][ul] = dah;
        sb[0][ul] = addf(sb[0][ul], daz);
        sb[1][ul] = addf(sb[1][ul], dar);
        sb[2][ul] = addf(sb[2][ul], dah);
        cz[ul] = mulf(dh, z);
      }
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        *reinterpret_cast<uint4*>(dmx + og + g * U) = pack8(ox[g]);
        *reinterpret_cast<uint4*>(dmh + og + g * U) = pack8(oh[g]);
#pragma unroll
        for (int ul = 0; ul < 8; ++ul)
          dmh_s[(size_t)(g * 8 + ul) * ldb + b] = __float2bfloat16_rn(oh[g][ul]);
      }
#pragma unroll
      for (int ul = 0; ul < 8; ++ul)
        hpT[(size_t)(unit0 + ul) * Bp + b] = __float2bfloat16_rn(hpf[ul]);  // exact
      float4* cp = reinterpret_cast<float4*>(a.dh0 + ou);
      cp[0] = make_float4(cz[0], cz[1], cz[2], cz[3]);
      cp[1] = make_float4(cz[4], cz[5], cz[6], cz[7]);
    }
    grid.sync();

    // ---- carry[:, own units] += dmh . Wr[own rows]^T   (K = 3U)
    for (int mt = warp; mt < btiles; mt += kWarps) {
      const int r0 = mt * 16 + gq, r1 = r0 + 8;
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      mma_rows<1>(acc, r0 < B ? dmh + (size_t)r0 * G + 8 * tq : nullptr,
                  r1 < B ? dmh + (size_t)r1 * G + 8 * tq : nullptr,
                  wr_s + (size_t)gq * ldw + 8 * tq, 0, G, tq);
      if (r0 < B) {
        float2* c = reinterpret_cast<float2*>(a.dh0 + (size_t)r0 * U + unit0 + 2 * tq);
        const float2 v = __ldcg(c);
        *c = make_float2(addf(v.x, acc[0][0]), addf(v.y, acc[0][1]));
      }
      if (r1 < B) {
        float2* c = reinterpret_cast<float2*>(a.dh0 + (size_t)r1 * U + unit0 + 2 * tq);
        const float2 v = __ldcg(c);
        *c = make_float2(addf(v.x, acc[0][2]), addf(v.y, acc[0][3]));
      }
    }
    // ---- dWr[:, own columns] += h_prev^T . dmh[:, own columns]   (K = B)
    for (int mt = warp; mt < utiles; mt += kWarps) {
      const int r0 = mt * 16 + gq, r1 = r0 + 8;
      float acc[3][4];
#pragma unroll
      for (int g = 0; g < 3; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
      mma_rows<3>(acc, r0 < U ? hpT + (size_t)r0 * Bp + 8 * tq : nullptr,
                  r1 < U ? hpT + (size_t)r1 * Bp + 8 * tq : nullptr,
                  dmh_s + (size_t)gq * ldb + 8 * tq, 8 * ldb, Bp, tq);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        if (r0 < U) {
          float2* d = reinterpret_cast<float2*>(dwr_s + (size_t)r0 * kNC + g * 8 + 2 * tq);
          *d = make_float2(addf(d->x, acc[g][0]), addf(d->y, acc[g][1]));
        }
        if (r1 < U) {
          float2* d = reinterpret_cast<float2*>(dwr_s + (size_t)r1 * kNC + g * 8 + 2 * tq);
          *d = make_float2(addf(d->x, acc[g][2]), addf(d->y, acc[g][3]));
        }
      }
    }
    __syncthreads();  // the carry and dmh_s are rewritten by the next gate phase
  }

  for (int i = tid; i < U * kNC; i += kThreads) {
    const int u = i / kNC, c = i % kNC;
    a.dwr[(size_t)u * G + (c >> 3) * U + unit0 + (c & 7)] = dwr_s[i];
  }
  __syncthreads();
  // db_rec: the threads' partial sums added in thread order
  float* red = dwr_s;  // (kThreads, kNC)
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int ul = 0; ul < kUB; ++ul) red[tid * kNC + g * 8 + ul] = sb[g][ul];
  __syncthreads();
  if (tid < kNC) {
    float s = 0.f;
    for (int i = 0; i < kThreads; ++i) s = addf(s, red[i * kNC + tid]);
    a.dbrec[(tid >> 3) * U + unit0 + (tid & 7)] = s;
  }
}

template <typename Args>
int launch(void (*kernel)(Args), const Args& a, size_t smem, void* stream) {
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = a.U / kUB;
  // every block must be resident at once, or a grid sync never returns
  if (per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  Args ka = a;
  void* kargs[] = {&ka};
  err = cudaLaunchCooperativeKernel((void*)kernel, grid, kThreads, kargs, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

size_t bwd_smem(int U, int Bp) {
  return (size_t)kUB * padded_ld(3 * U) * sizeof(bf16) + (size_t)kNC * padded_ld(Bp) * sizeof(bf16) +
         (size_t)(U > kThreads ? U : kThreads) * kNC * sizeof(float);
}

}  // namespace

extern "C" int gxt_gru_train_fwd(const void* mxs, const void* h0, const void* wr,
                                 const float* brec, void* ys, void* mhs, int T, int B, int U,
                                 void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (U <= 0 || U % kUB) return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.mxs = static_cast<const bf16*>(mxs);
  a.h0 = static_cast<const bf16*>(h0);
  a.wr = static_cast<const bf16*>(wr);
  a.brec = brec;
  a.ys = static_cast<bf16*>(ys);
  a.mhs = static_cast<bf16*>(mhs);
  a.T = T; a.B = B; a.U = U;
  a.ldw = padded_ld(U);
  return launch(gru_train_fwd_kernel, a, (size_t)kNC * a.ldw * sizeof(bf16), stream);
}

// `dmh` (2, B, 3U) and `hpT` (2, U, Bp) are bf16 staging buffers, Bp = B
// rounded up to 32; hpT must arrive zeroed (its columns B..Bp-1 stay zero).
extern "C" int gxt_gru_train_bwd(const void* mxs, const void* mhs, const void* ys,
                                 const void* dys, const void* h0, const void* wr, void* dmxs,
                                 float* dwr, float* dbrec, float* dh0, void* dmh, void* hpT,
                                 int T, int B, int U, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (U <= 0 || U % kUB) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.mxs = static_cast<const bf16*>(mxs);
  a.mhs = static_cast<const bf16*>(mhs);
  a.ys = static_cast<const bf16*>(ys);
  a.dys = static_cast<const bf16*>(dys);
  a.h0 = static_cast<const bf16*>(h0);
  a.wr = static_cast<const bf16*>(wr);
  a.dmxs = static_cast<bf16*>(dmxs);
  a.dwr = dwr;
  a.dbrec = dbrec;
  a.dh0 = dh0;
  a.dmh = static_cast<bf16*>(dmh);
  a.hpT = static_cast<bf16*>(hpT);
  a.T = T; a.B = B; a.U = U;
  a.Bp = (B + 31) & ~31;
  a.ldw = padded_ld(3 * U);
  a.ldb = padded_ld(a.Bp);
  return launch(gru_train_bwd_kernel, a, bwd_smem(U, a.Bp), stream);
}

// Bytes of dynamic shared memory the backward launch needs at (B, U): the
// wrapper holds them against the device's limit before it launches.
extern "C" int gxt_gru_train_bwd_smem(int B, int U) {
  return (int)bwd_smem(U, (B + 31) & ~31);
}

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
