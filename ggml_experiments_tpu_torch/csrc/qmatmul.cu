// Fused block dequant + matmul: out (M, N) = x (M, K) @ dequantize(W), for
// every block format (q8_0, q4_0, q4_1, q5_0, q5_1, q4_k).
//
// Replaces: ggml_experiments_tpu/quant/pallas_kernels.py `_qmatmul_2d`
// (pallas_call at :253) with its six bodies: `_q8_kernel` :106, `_q4_kernel`
// :117, `_q4_1_kernel` :129, `_q5_0_kernel` :144, `_q5_1_kernel` :156 and
// `_q4_k_kernel` :173.
//
// Layout (quant/qtensor.py), ldc = the lane-padded column count, N <= ldc:
//   codes   int8 (Kp, ldc) for q8_0, else uint8 (Kp/2, ldc): byte row
//           blk*16 + (t & 15) of block blk = k >> 5 holds block-local rows
//           t (low nibble, t < 16) and t + 16 (high nibble)
//   scales  f32 (Kp/32, ldc); q4_k: uint8 sub-block scale codes
//   mins    f32 (Kp/32, ldc) q4_1/q5_1; uint8 min codes for q4_k
//   hibits  uint8 (Kp/8, ldc) q5_0/q5_1: row blk*4 + (t & 3), bit t >> 2
//   supers  f32 (2*ns, ldc) q4_k: D = supers[blk >> 3], Mn = supers[ns + (blk >> 3)]
//
// What bounds it on an H100. At the main path's M=64 (generate at B=64,
// K=1024, N=3072) the work is 0.4 GFLOP against 1.6-3.4 MB of planes, so the
// bytes bound it (~1 us), and in practice the latency of each block's walk
// over K: one 32-row step costs about a microsecond of dependent shared
// loads, conversions, mmas and barriers, however early its data arrives.
// At M=1024 and bf16 the tensor cores would leave it bound by bytes (~6 us);
// what limits it there is the L2 traffic of x, which each of the N / 64
// column tiles reads again. At f32 the products run as 3xTF32, whose bound
// is the tf32 rate / 3 (165 TFLOP/s: ~39 us at M=1024).
//
// Design. One kernel templated on a per-format decoder, on the route (bf16
// or 3xTF32), on x's dtype and on the tile height BM (64 or 128); the tile
// is BM x 64 output columns, BM * 2 threads, each warp a 32 x 32 sub-tile.
// K is walked one quantization block (32 rows) a step through a four-stage
// cp.async ring: the step's x tile (as the wrapper passes it) and the packed
// planes of its 32 x 64 weight tile arrive in 16-byte copies three steps
// ahead. Each step decodes its weight tile once into shared memory (each
// scale, min and super read once per block and column; every thread
// decodes), then the warps multiply:
//   bf16  both operands rounded to bf16 (f32 x while its fragments are
//         built; bf16 x, which the wrapper passes from M=256 on or when x
//         arrives in bf16, as staged), mma.sync m16n8k16 with f32 sums; the
//         weight fragments come from the decoded [k][n] tile by ldmatrix.trans;
//   f32   3xTF32 (x = hi + lo, three m16n8k8 tf32 products, small terms
//         first): f32-accurate products and f32 sums on the tensor cores.
// The decoders keep the roundings of the plain version (multiply, round,
// then add the offset: never one fused multiply-add), so a decoded weight is
// bit-equal to the plain version's before it is rounded to bf16.
// Small M fills the card by splitting K: the launch's z blocks form one
// thread-block cluster per output tile, each takes a run of whole
// quantization blocks, and the partial tiles are summed through distributed
// shared memory in rank order, so two launches are bit-equal (no atomics).
// `quant/qmatmul.py launch_config` picks BM and the split. K and N are
// guarded, so nothing depends on what the padding decodes to; the Python
// router still sends q4_k with Kp % 256 != 0 to dequantize + matmul, as the
// TPU package does.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

using gxt::bf16;

constexpr int kBN = 64;      // output columns per block
constexpr int kKT = 32;      // K rows per step: one quantization block
constexpr int kStages = 4;   // depth of the cp.async ring
constexpr int kWS = 72;      // row stride of the decoded tile (elements)
constexpr int kPS = kBN + 4; // row stride of a partial tile (floats)
constexpr int kMaxSplit = 8; // a portable cluster

// The planes of one weight; a decoder reads the ones its format has.
struct Planes {
  const uint8_t* codes;
  const uint8_t* scales;
  const uint8_t* mins;
  const uint8_t* hibits;
  const uint8_t* supers;
  int ldc;
  int ns;  // q4_k: super-block rows per half of `supers`
};

// cp.async `rows` plane rows of `row_bytes` (a multiple of 16) from row
// `row0`, starting `col_byte` bytes into each row, to dst (rows packed).
__device__ __forceinline__ void copy_rows(uint8_t* dst, const uint8_t* plane, size_t ld_bytes,
                                          int row0, int rows, int row_bytes, size_t col_byte,
                                          int tid, int nthreads) {
  const int per_row = row_bytes >> 4;
  for (int i = tid; i < rows * per_row; i += nthreads) {
    const int r = i / per_row, c = i - r * per_row;
    gxt::cp_async16(dst + r * row_bytes + c * 16,
                    plane + (size_t)(row0 + r) * ld_bytes + col_byte + c * 16, 16);
  }
}

__device__ __forceinline__ int byte_at(const uint2& v, int j) {
  return (int)(((j < 4 ? v.x : v.y) >> (8 * (j & 3))) & 0xffu);
}

// W (4 or 8) consecutive bytes of a raw slot
template <int W>
__device__ __forceinline__ uint2 ld_bytes(const uint8_t* p) {
  if constexpr (W == 8) return *reinterpret_cast<const uint2*>(p);
  return make_uint2(*reinterpret_cast<const uint32_t*>(p), 0u);
}

// A decoder loads the packed planes of one 32 x 64 weight tile (block blk,
// columns n0..n0+63) into a raw slot of kBytes, and decodes one unit: byte
// row r (0..15) x columns c8..c8+W-1 of the tile, giving block-local rows r
// (lo) and r + 16 (hi).
struct DecQ8_0 {
  static constexpr int kCodes = kKT * kBN, kBytes = kCodes + kBN * 4;
  static __device__ __forceinline__ void load(const Planes& p, int blk, int n0, uint8_t* raw,
                                              int tid, int nt) {
    copy_rows(raw, p.codes, p.ldc, blk * kKT, kKT, kBN, n0, tid, nt);
    copy_rows(raw + kCodes, p.scales, (size_t)p.ldc * 4, blk, 1, kBN * 4, (size_t)n0 * 4, tid,
              nt);
  }
  template <int W>
  static __device__ __forceinline__ void unit(const uint8_t* raw, int r, int c8, float (&lo)[W],
                                              float (&hi)[W]) {
    const uint2 a = ld_bytes<W>(raw + r * kBN + c8);
    const uint2 b = ld_bytes<W>(raw + (r + 16) * kBN + c8);
    const float* s = reinterpret_cast<const float*>(raw + kCodes) + c8;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      lo[j] = __fmul_rn((float)(int8_t)byte_at(a, j), s[j]);
      hi[j] = __fmul_rn((float)(int8_t)byte_at(b, j), s[j]);
    }
  }
};

// q4_0 (no mins, no fifth bit, offset -8), q4_1 (mins), q5_0 (fifth bit,
// offset -16), q5_1 (mins and fifth bit)
template <bool kMins, bool kHi, int kOffset>
struct DecNibble {
  static constexpr int kCodes = 16 * kBN;
  static constexpr int kScales = kCodes, kMinsAt = kScales + kBN * 4;
  static constexpr int kHiAt = kMinsAt + (kMins ? kBN * 4 : 0);
  static constexpr int kBytes = kHiAt + (kHi ? 4 * kBN : 0);
  static __device__ __forceinline__ void load(const Planes& p, int blk, int n0, uint8_t* raw,
                                              int tid, int nt) {
    copy_rows(raw, p.codes, p.ldc, blk * 16, 16, kBN, n0, tid, nt);
    copy_rows(raw + kScales, p.scales, (size_t)p.ldc * 4, blk, 1, kBN * 4, (size_t)n0 * 4, tid,
              nt);
    if constexpr (kMins)
      copy_rows(raw + kMinsAt, p.mins, (size_t)p.ldc * 4, blk, 1, kBN * 4, (size_t)n0 * 4, tid,
                nt);
    if constexpr (kHi) copy_rows(raw + kHiAt, p.hibits, p.ldc, blk * 4, 4, kBN, n0, tid, nt);
  }
  template <int W>
  static __device__ __forceinline__ void unit(const uint8_t* raw, int r, int c8, float (&lo)[W],
                                              float (&hi)[W]) {
    const uint2 b = ld_bytes<W>(raw + r * kBN + c8);
    const float* s = reinterpret_cast<const float*>(raw + kScales) + c8;
    const float* mn = reinterpret_cast<const float*>(raw + kMinsAt) + c8;
    uint2 hb = make_uint2(0u, 0u);
    if constexpr (kHi) hb = ld_bytes<W>(raw + kHiAt + (r & 3) * kBN + c8);
    const int sh = r >> 2;  // row r's fifth bit; row r + 16's is bit sh + 4
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int byte = byte_at(b, j);
      int ql = (byte & 15) + kOffset, qh = (byte >> 4) + kOffset;
      if (kHi) {
        const int h = byte_at(hb, j);
        ql += 16 * ((h >> sh) & 1);
        qh += 16 * ((h >> (sh + 4)) & 1);
      }
      lo[j] = __fmul_rn((float)ql, s[j]);
      hi[j] = __fmul_rn((float)qh, s[j]);
      if (kMins) {
        lo[j] = __fadd_rn(lo[j], mn[j]);
        hi[j] = __fadd_rn(hi[j], mn[j]);
      }
    }
  }
};
using DecQ4_0 = DecNibble<false, false, -8>;
using DecQ4_1 = DecNibble<true, false, 0>;
using DecQ5_0 = DecNibble<false, true, -16>;
using DecQ5_1 = DecNibble<true, true, 0>;

struct DecQ4_K {
  static constexpr int kCodes = 16 * kBN, kSc = kCodes, kMn = kSc + kBN, kSup = kMn + kBN;
  static constexpr int kBytes = kSup + 2 * kBN * 4;
  static __device__ __forceinline__ void load(const Planes& p, int blk, int n0, uint8_t* raw,
                                              int tid, int nt) {
    const int sb = min(blk >> 3, p.ns - 1);
    copy_rows(raw, p.codes, p.ldc, blk * 16, 16, kBN, n0, tid, nt);
    copy_rows(raw + kSc, p.scales, p.ldc, blk, 1, kBN, n0, tid, nt);
    copy_rows(raw + kMn, p.mins, p.ldc, blk, 1, kBN, n0, tid, nt);
    copy_rows(raw + kSup, p.supers, (size_t)p.ldc * 4, sb, 1, kBN * 4, (size_t)n0 * 4, tid, nt);
    copy_rows(raw + kSup + kBN * 4, p.supers, (size_t)p.ldc * 4, p.ns + sb, 1, kBN * 4,
              (size_t)n0 * 4, tid, nt);
  }
  template <int W>
  static __device__ __forceinline__ void unit(const uint8_t* raw, int r, int c8, float (&lo)[W],
                                              float (&hi)[W]) {
    const uint2 b = ld_bytes<W>(raw + r * kBN + c8);
    const float* d = reinterpret_cast<const float*>(raw + kSup) + c8;
    const float* mn = d + kBN;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      // eff_d and eff_m are their own f32 products, as in the plain version
      const float eff_d = __fmul_rn(d[j], (float)raw[kSc + c8 + j]);
      const float eff_m = __fmul_rn(mn[j], (float)raw[kMn + c8 + j]);
      const int byte = byte_at(b, j);
      lo[j] = __fsub_rn(__fmul_rn((float)(byte & 15), eff_d), eff_m);
      hi[j] = __fsub_rn(__fmul_rn((float)(byte >> 4), eff_d), eff_m);
    }
  }
};

// elements per staged x row, for conflict-free fragment loads: f32 x read
// as float2 (bf16 route) or as scalars (tf32 route), bf16 x as 32-bit pairs
__host__ __device__ constexpr int x_stride(bool bf16_route, int x_bytes) {
  return x_bytes == 2 ? 40 : (bf16_route ? 40 : 36);
}

template <class Dec, bool kBf16, typename XT, int BM>
constexpr size_t smem_bytes() {
  return (size_t)kStages * BM * x_stride(kBf16, sizeof(XT)) * sizeof(XT) +
         (size_t)kStages * Dec::kBytes + (size_t)kKT * kWS * (kBf16 ? 2 : 4);
}

// x is f32, or bf16 on the bf16 route (XT); the output is f32
template <class Dec, bool kBf16, typename XT, int BM>
__global__ void __launch_bounds__(BM * 2) qmatmul_kernel(const XT* __restrict__ x, Planes p,
                                                         float* __restrict__ out, int M, int K,
                                                         int N, int nblk, int bps, int xvec) {
  constexpr int T = BM * 2;
  constexpr int XS = x_stride(kBf16, sizeof(XT));
  constexpr int XV = 16 / sizeof(XT);  // x elements per 16-byte copy
  using WT = typename std::conditional<kBf16, bf16, float>::type;
  extern __shared__ __align__(16) uint8_t smem[];
  XT* xs = reinterpret_cast<XT*>(smem);                                // [kStages][BM][XS]
  uint8_t* raw = smem + (size_t)kStages * BM * XS * sizeof(XT);        // [kStages][kBytes]
  WT* wd = reinterpret_cast<WT*>(raw + (size_t)kStages * Dec::kBytes); // [kKT][kWS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's 32 x 32 sub-tile
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int blk0 = blockIdx.z * bps;
  const int nsteps = max(0, min(nblk, blk0 + bps) - blk0);

  // step s's x tile and packed weight tile into ring slot s % kStages; one
  // commit group per step, empty past the end
  auto load = [&](int s) {
    if (s < nsteps) {
      const int blk = blk0 + s, slot = s % kStages, k0 = blk * kKT;
      XT* xd = xs + (size_t)slot * BM * XS;
      if (xvec) {
        for (int i = tid; i < BM * (kKT / XV); i += T) {
          const int r = i / (kKT / XV), c = (i % (kKT / XV)) * XV, m = m0 + r, k = k0 + c;
          const bool ok = m < M && k < K;
          gxt::cp_async16(xd + r * XS + c, ok ? x + (size_t)m * K + k : x, ok ? 16 : 0);
        }
      } else if constexpr (sizeof(XT) == 4) {
        for (int i = tid; i < BM * kKT; i += T) {
          const int r = i / kKT, c = i % kKT, m = m0 + r, k = k0 + c;
          const bool ok = m < M && k < K;
          gxt::cp_async4(xd + r * XS + c, ok ? x + (size_t)m * K + k : x, ok ? 4 : 0);
        }
      }
      Dec::load(p, blk, n0, raw + (size_t)slot * Dec::kBytes, tid, T);
    }
    gxt::cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s);

  for (int s = 0; s < nsteps; ++s) {
    gxt::cp_async_wait<kStages - 2>();
    __syncthreads();  // step s has landed; slot s - 1 and the decoded tile are free
    load(s + kStages - 1);
    const int slot = s % kStages, blk = blk0 + s;

    // decode the step's weight tile once: one unit of 2 x W weights a
    // thread (W = 4 at 256 threads, 8 at 128)
    const uint8_t* rs = raw + (size_t)slot * Dec::kBytes;
    constexpr int W = T >= 256 ? 4 : 8, UPR = kBN / W;
    for (int u = tid; u < 16 * UPR; u += T) {
      const int r = u / UPR, c8 = (u % UPR) * W;
      float lo[W], hi[W];
      Dec::template unit<W>(rs, r, c8, lo, hi);
      const int klo = blk * kKT + r;
      if (klo + 16 >= K) {
#pragma unroll
        for (int j = 0; j < W; ++j) {
          if (klo >= K) lo[j] = 0.f;
          hi[j] = 0.f;
        }
      }
      WT* dlo = wd + r * kWS + c8;
      WT* dhi = wd + (r + 16) * kWS + c8;
      if constexpr (kBf16) {
        uint32_t pl[W / 2], ph[W / 2];
#pragma unroll
        for (int j = 0; j < W / 2; ++j) {
          pl[j] = gxt::pack_bf16(lo[2 * j], lo[2 * j + 1]);
          ph[j] = gxt::pack_bf16(hi[2 * j], hi[2 * j + 1]);
        }
        if constexpr (W == 8) {
          *reinterpret_cast<uint4*>(dlo) = make_uint4(pl[0], pl[1], pl[2], pl[3]);
          *reinterpret_cast<uint4*>(dhi) = make_uint4(ph[0], ph[1], ph[2], ph[3]);
        } else {
          *reinterpret_cast<uint2*>(dlo) = make_uint2(pl[0], pl[1]);
          *reinterpret_cast<uint2*>(dhi) = make_uint2(ph[0], ph[1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < W; j += 4) {
          *reinterpret_cast<float4*>(dlo + j) = make_float4(lo[j], lo[j + 1], lo[j + 2], lo[j + 3]);
          *reinterpret_cast<float4*>(dhi + j) = make_float4(hi[j], hi[j + 1], hi[j + 2], hi[j + 3]);
        }
      }
    }
    __syncthreads();

    const XT* xa = xs + (size_t)slot * BM * XS + (wm * 32) * XS;
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const XT* r0 = xa + (mt * 16 + g) * XS + kk + 2 * t;
          if constexpr (sizeof(XT) == 2) {
            a[mt][0] = gxt::lds32(r0);
            a[mt][1] = gxt::lds32(r0 + 8 * XS);
            a[mt][2] = gxt::lds32(r0 + 8);
            a[mt][3] = gxt::lds32(r0 + 8 * XS + 8);
          } else {
            const float2 v0 = *reinterpret_cast<const float2*>(r0);
            const float2 v1 = *reinterpret_cast<const float2*>(r0 + 8 * XS);
            const float2 v2 = *reinterpret_cast<const float2*>(r0 + 8);
            const float2 v3 = *reinterpret_cast<const float2*>(r0 + 8 * XS + 8);
            a[mt][0] = gxt::pack_bf16(v0.x, v0.y);
            a[mt][1] = gxt::pack_bf16(v1.x, v1.y);
            a[mt][2] = gxt::pack_bf16(v2.x, v2.y);
            a[mt][3] = gxt::pack_bf16(v3.x, v3.y);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const WT* bp = wd + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kWS + wn * 32 + j * 16 +
                         ((lane >> 4) << 3);
          gxt::ldmatrix_x4_trans(bp, b[2 * j][0], b[2 * j][1], b[2 * j + 1][0], b[2 * j + 1][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            gxt::mma_bf16(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[nt][0], b[nt][1]);
      }
    } else {
      const float* xf = reinterpret_cast<const float*>(xa);
      const float* wf = reinterpret_cast<const float*>(wd);
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 8) {
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* r0 = xf + (mt * 16 + g) * XS + kk + t;
          gxt::split_tf32(r0[0], ah[mt][0], al[mt][0]);
          gxt::split_tf32(r0[8 * XS], ah[mt][1], al[mt][1]);
          gxt::split_tf32(r0[4], ah[mt][2], al[mt][2]);
          gxt::split_tf32(r0[8 * XS + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* c0 = wf + (kk + t) * kWS + wn * 32 + nt * 8 + g;
          gxt::split_tf32(c0[0], bh[nt][0], bl[nt][0]);
          gxt::split_tf32(c0[4 * kWS], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            gxt::mma_tf32x<true>(acc[mt][nt], ah[mt], al[mt], bh[nt][0], bh[nt][1], bl[nt][0],
                                 bl[nt][1]);
      }
    }
  }

  if (gridDim.z == 1) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = m0 + wm * 32 + mt * 16 + g + (i >> 1) * 8;
          const int col = n0 + wn * 32 + nt * 8 + 2 * t + (i & 1);
          if (row < M && col < N) out[(size_t)row * N + col] = acc[mt][nt][i];
        }
    return;
  }

  // split K: the cluster's blocks hold partial tiles of the same outputs.
  // Each writes its own into shared memory (over the idle ring), then sums
  // every (ks)-th row of the tile over the ranks in order 0, 1, ...
  gxt::cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);  // [BM][kPS]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = wm * 32 + mt * 16 + g, c = wn * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(part + r * kPS + c) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(part + (r + 8) * kPS + c) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ks = (int)gridDim.z, rank = (int)cluster.block_rank();
  const int rows = min(BM, M - m0);
  const int mine = rows > rank ? (rows - rank + ks - 1) / ks : 0;
  for (int i = tid; i < mine * (kBN / 4); i += T) {
    const int r = rank + (i / (kBN / 4)) * ks, c = (i % (kBN / 4)) * 4;
    float4 s = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0) + r * kPS + c);
    for (int q = 1; q < ks; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) + r * kPS + c);
      s.x = __fadd_rn(s.x, v.x);
      s.y = __fadd_rn(s.y, v.y);
      s.z = __fadd_rn(s.z, v.z);
      s.w = __fadd_rn(s.w, v.w);
    }
    const float sv[4] = {s.x, s.y, s.z, s.w};
    float* o = out + (size_t)(m0 + r) * N + n0 + c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + c + j < N) o[j] = sv[j];
  }
  cluster.sync();  // no block leaves while another reads its partial tile
}

template <class Dec, bool kBf16, typename XT, int BM>
int launch_t(const void* xv, const Planes& p, float* out, int M, int K, int N, int nblk, int bps,
             int ks, void* stream) {
  auto kernel = qmatmul_kernel<Dec, kBf16, XT, BM>;
  const size_t smem = smem_bytes<Dec, kBf16, XT, BM>();
  static bool smem_set = false;  // the attribute is the kernel's: set it once
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const XT* x = static_cast<const XT*>(xv);
  // 16-byte copies of x need whole 16-byte groups in every row; bf16 x
  // comes only that way (the wrapper sends f32 x otherwise)
  const int xvec = (K % (16 / (int)sizeof(XT)) == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  if (sizeof(XT) == 2 && !xvec) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kBN - 1) / kBN, (M + BM - 1) / BM, ks);
  cfg.blockDim = dim3(BM * 2);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ks;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, p, out, M, K, N, nblk, bps, xvec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class Dec>
int launch(const void* x, const Planes& p, float* out, int M, int K, int N, int bf16_route,
           int x_bf16, int bm, int ks, int bps, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int nblk = (K + kKT - 1) / kKT;
  // the split must cover K with no empty rank, in one portable cluster
  if (ks < 1 || ks > kMaxSplit || bps < 1 || (long long)ks * bps < nblk ||
      (long long)(ks - 1) * bps >= nblk || (bm != 64 && bm != 128) || (x_bf16 && !bf16_route))
    return (int)cudaErrorInvalidValue;
  if (x_bf16)
    return bm == 64 ? launch_t<Dec, true, bf16, 64>(x, p, out, M, K, N, nblk, bps, ks, stream)
                    : launch_t<Dec, true, bf16, 128>(x, p, out, M, K, N, nblk, bps, ks, stream);
  if (bf16_route)
    return bm == 64 ? launch_t<Dec, true, float, 64>(x, p, out, M, K, N, nblk, bps, ks, stream)
                    : launch_t<Dec, true, float, 128>(x, p, out, M, K, N, nblk, bps, ks, stream);
  return bm == 64 ? launch_t<Dec, false, float, 64>(x, p, out, M, K, N, nblk, bps, ks, stream)
                  : launch_t<Dec, false, float, 128>(x, p, out, M, K, N, nblk, bps, ks, stream);
}

}  // namespace

// What stays fixed between calls on one weight at one M: built once by the
// wrapper and passed by pointer (a call then converts five arguments, not
// eighteen). Planes a format lacks are null; every plane pointer must be
// 16-byte aligned (the wrapper checks). bm, ksplit and bps (quantization
// blocks per split) come from `launch_config`; x_bf16 marks bf16 x on the
// bf16 route (K a multiple of 8), else x is f32.
struct QmmArgs {
  const void* codes;
  const void* scales;
  const void* mins;
  const void* hibits;
  const void* supers;
  int K, N, ldc, ns, bf16, x_bf16, bm, ksplit, bps;
};

#define GXT_QMATMUL_ENTRY(name, Dec)                                                          \
  extern "C" int gxt_qmatmul_##name(const void* x, float* out, int M, const QmmArgs* a,        \
                                    void* stream) {                                            \
    Planes p{static_cast<const uint8_t*>(a->codes), static_cast<const uint8_t*>(a->scales),    \
             static_cast<const uint8_t*>(a->mins), static_cast<const uint8_t*>(a->hibits),     \
             static_cast<const uint8_t*>(a->supers), a->ldc, a->ns};                           \
    return launch<Dec>(x, p, out, M, a->K, a->N, a->bf16, a->x_bf16, a->bm, a->ksplit, a->bps, \
                       stream);                                                                \
  }

GXT_QMATMUL_ENTRY(q8_0, DecQ8_0)
GXT_QMATMUL_ENTRY(q4_0, DecQ4_0)
GXT_QMATMUL_ENTRY(q4_1, DecQ4_1)
GXT_QMATMUL_ENTRY(q5_0, DecQ5_0)
GXT_QMATMUL_ENTRY(q5_1, DecQ5_1)
GXT_QMATMUL_ENTRY(q4_k, DecQ4_K)

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
