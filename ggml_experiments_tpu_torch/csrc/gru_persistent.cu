// Persistent GRU decode loop: the whole multi-step decode in ONE
// cooperative launch. Two entry points share the kernel:
//
//   gxt_fused_gru_decode  replaces ggml_experiments_tpu/ops/fused_gru_decode.py
//                         `_fused_decode_jit` (pallas_call :227; body `_kernel`
//                         :104, `_gru_step` :58, `_dequant_to` :42)
//   gxt_fused_slot_tick   replaces the same file's `_tick_call` (pallas_call
//                         :774; body `_tick_kernel` :564, `_filter_topk_vb`
//                         :508, `_filter_topp_vb` :533, `_hash_bits_u32` :476)
//
// Offline decode is the tick with every slot starting at pos 0, h 0, prev 0
// and total = steps, so one kernel serves both; only the wrappers differ.
// The step (gather -> gates -> h update -> logits -> token) is the device
// code below, shared as `_gru_step` is shared in JAX.
//
// The weights arrive by one of three routes (Args.wmode), as `_dequant_to`
// takes them on the TPU: q8_0 (int8 codes x f32 block scales) and q4_0
// (block-local packed nibbles, (nib - 8) x scale) are decoded here, in the
// setup; "dense" planes were dequantized to f32 beforehand (q4_1, q5_0,
// q5_1, q4_k and mixed formats) and are copied. All three are rounded to
// the compute dtype in the setup, and the step loop never sees the route.
//
// Bound on an H100 at the reference shape (U=1024, E=256, V=66): per step
// and slot 2*(3U*U + U*V) = 6.4 MFLOP of gate and head products and no
// weight bytes (the weights are read once), so the operations bound it:
// ~6.5 ns per slot-step at the bf16 tensor-core peak, ~96 ns at the f32
// CUDA-core peak. At bf16 the gate products (98% of the operations) run on
// tensor cores (mma.sync, phase_a_mma); at f32, and for the small head
// product in both, they are f32 FMAs on CUDA cores, whose peak is then the
// ceiling.
//
// The TPU kernel keeps every dequantized plane in one core's 100 MB VMEM.
// A Hopper block has 227 KB, so the design is spread over the grid:
//   * block i owns ub hidden units (all three gate columns of each unit:
//     u, U+u, 2U+u); its slice of the dequantized recurrent plane (U x 3ub)
//     and of the vocab-wide input-projection table emb.W (V x 3ub) stay in
//     shared memory for the whole decode: ~105 KB at U=1024, ub=8 in f32
//     (the recurrent slice is held as bf16 when bf16 is set);
//   * the dense head is dequantized once into a global scratch (U x V,
//     270 KB, L2-resident);
//   * the state h is double-buffered in global memory (L2-resident up to
//     B of a few thousand). Phase A of a step reads h_cur and writes the
//     block's units of h_next for every slot (f32: each thread holds 8
//     slots x 3 gate columns of one unit in registers; bf16: m16n8k16
//     tensor-core tiles over a bf16 copy of h kept beside the f32 state).
//     Grid sync. Phase B gives each block tiles of 32
//     slots: logits from staged h and D chunks (16 slots x 2 vocab entries
//     per thread), greedy/sampled token, cursors. Grid sync;
//   * the input projection is a row gather of the table (the TPU kernel's
//     one-hot contraction computes the same values).
// Values that change during the loop (h, prev, pos) are read with __ldcg so
// that no stale L1 line survives a grid sync.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// the launch arguments, filled by the Python wrapper (_Args in
// ops/fused_gru_decode.py mirrors this layout); outside the anonymous
// namespace so that the extern "C" entry points keep external linkage
struct Args {
  const float* emb;     // (V, E)
  const void* wc;       // input kernel, G = 3U columns: int8 (Ke, G) codes,
                        // uint8 (Ke/2, G) packed nibbles, or f32 (E, G) dense
  const float* ws;      // (Ke/32, G) block scales; null for dense
  const void* uc;       // recurrent kernel: (U, G), (U/2, G) or f32 (U, G)
  const float* us;      // (U/32, G)
  const float* bias;    // (2, G): input, recurrent
  const void* dc;       // dense head: (U, V), (U/2, V) or f32 (U, V)
  const float* ds;      // (U/32, V)
  const float* dbias;   // (V)
  const int* prompt;    // (B, P)
  const int* plen;      // (B)
  const int* total;     // (B)
  int* prev;            // (B) in/out
  int* pos;             // (B) in/out
  float* h0;            // (B, U) initial state
  float* h1;            // (B, U) second buffer
  float* ddeq;          // (U, V) scratch
  void* toks;           // (B, steps) int32 or uint8
  const float* temp;    // (B) or null
  void* hb0;            // (B, U) bf16 copy of h0, bf16 compute only (else null)
  void* hb1;            // (B, U) bf16 copy of h1
  int V, E, U, P, B, steps, toks_u8, bf16;
  int sampling, top_k;
  int wmode;            // weight route: 0 q8_0, 1 q4_0, 2 dense
  float top_p;
  uint32_t seed;
};

namespace {

constexpr int kThreads = 256;
// phase A: 8 units x 32 slot groups of 8 slots per pass
constexpr int kUG = 8;              // units per pass (thread & 7)
constexpr int kSPT = 8;             // slots per thread
constexpr int kST = 32 * kSPT;      // slots per staged tile (256)
constexpr int kKT = 32;             // K rows per staged h chunk
constexpr int kHS = kST + 4;        // padded row (16-byte aligned, 4-way stores)
// phase B: 32-slot tiles, 2 halves of 16 slots x 128 vocab lanes
constexpr int kLT = 32;
constexpr int kLK = 32;             // K rows per staged h / D chunk
constexpr int kLS = kLT + 4;        // padded row of the staged h chunk
constexpr int kMaxV = 256;          // vocab handled by the per-slot warp (8/lane)
constexpr int kVR = kMaxV / 32;
constexpr float kNeg = -1e30f;      // the TPU kernel's NEG mask value
// bf16 phase A on tensor cores: 128-slot tiles (8 warps x 16 rows)
constexpr int kMS = 128;            // slots per tile
constexpr int kMK = 64;             // K per staged chunk
constexpr int kMA = kMK + 8;        // padded bf16 row of the staged h tile
constexpr int kACS = 28;            // padded f32 row of the gate-sum tile
static_assert(kMS * kMA / 2 + kMS * kACS <= kKT * kHS, "bf16 phase A staging fits phase A's work area");


// launch geometry, derived from Args on the host
struct Geom {
  int ub;        // units per block
  int proj_off;  // float offsets into dynamic shared memory
  int work_off;
  int tok_off;
};

__host__ __device__ inline int align4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float rc(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Weight (k, col) of a plane with ld columns, by the weight route. One
// multiply, one rounding, as the plain version's dequantize.
__device__ __forceinline__ float wdec(const void* codes, const float* scales, int k, int col,
                                      int ld, int wmode) {
  if (wmode == 2) return static_cast<const float*>(codes)[(size_t)k * ld + col];
  const float d = scales[(size_t)(k >> 5) * ld + col];
  if (wmode == 0)
    return __fmul_rn((float)static_cast<const int8_t*>(codes)[(size_t)k * ld + col], d);
  // q4_0: byte row blk*16 + (t & 15) holds block-local rows t (low nibble)
  // and t + 16 (high nibble)
  const int blk = k >> 5, t = k & 31;
  const int byte = static_cast<const uint8_t*>(codes)[(size_t)(blk * 16 + (t & 15)) * ld + col];
  const int nib = t < 16 ? (byte & 15) : (byte >> 4);
  return __fmul_rn((float)(nib - 8), d);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_min_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The TPU kernel's interpret-mode hash lattice (fused_gru_decode.py:476):
// bits for (seed, step j, vocab row r, slot column c, first slot slot0).
// The slot tick keys c on the global slot with slot0 = 0, which is the JAX
// tick's stream only while JAX runs its slots untiled (FUSED_TICK_MAX_UNTILED);
// once JAX tiles, it keys c within a tile plus the tile's first slot.
__device__ __forceinline__ uint32_t hash_bits(uint32_t seed, uint32_t j, uint32_t r,
                                              uint32_t c, uint32_t slot0) {
  uint32_t x = seed * 0x9E3779B9u + j * 0x85EBCA6Bu + r * 0xC2B2AE35u + c * 0x27D4EB2Fu;
  x ^= x >> 13;
  x *= 0xD168AAADu;
  x += slot0 * 0x165667B1u;
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 15;
  x *= 0x297A2D39u;
  x ^= x >> 16;
  return x;
}

// First index of the maximum over the lanes' live entries.
__device__ __forceinline__ int warp_argmax(const float (&s)[kVR], int V) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kVR; ++i) m = fmaxf(m, s[i]);
  m = warp_max(m);
  int cand = 1 << 30;
#pragma unroll
  for (int i = 0; i < kVR; ++i) {
    const int v = lane + 32 * i;
    if (v < V && s[i] == m) cand = min(cand, v);
  }
  return warp_min_i(cand);
}

// One slot's next token from its logits, by one whole warp. Greedy unless
// temp > 0; then Gumbel-argmax over the temperature-scaled logits after the
// top-k and top-p masks of the TPU tick (threshold by extraction, boundary
// ties kept as a group). Entries v >= V stay -inf and never take part.
__device__ int select_token(const float* lg, const Args& a, float temp, int j, int b) {
  const int lane = threadIdx.x & 31;
  const int V = a.V;
  float s[kVR];
#pragma unroll
  for (int i = 0; i < kVR; ++i) {
    const int v = lane + 32 * i;
    s[i] = v < V ? lg[v] : -INFINITY;
  }
  if (!(temp > 0.f)) return warp_argmax(s, V);

  const float inv_t = 1.f / fmaxf(temp, 1e-6f);
#pragma unroll
  for (int i = 0; i < kVR; ++i) s[i] *= inv_t;
  if (a.top_k > 0) {
    const int k = min(a.top_k, V);
    float cur[kVR];
#pragma unroll
    for (int i = 0; i < kVR; ++i) cur[i] = s[i];
    float thr = kNeg;
    int cnt = 0;
    for (int it = 0; it < k; ++it) {
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < kVR; ++i) m = fmaxf(m, cur[i]);
      m = warp_max(m);
      if (cnt < k) thr = m;
      int tied = 0;
#pragma unroll
      for (int i = 0; i < kVR; ++i) {
        if (cur[i] == m) {
          ++tied;
          cur[i] = kNeg;
        }
      }
      cnt += warp_sum_i(tied);
    }
#pragma unroll
    for (int i = 0; i < kVR; ++i)
      if (lane + 32 * i < V) s[i] = s[i] >= thr ? s[i] : kNeg;
  }
  if (a.top_p > 0.f) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kVR; ++i) mx = fmaxf(mx, s[i]);
    mx = warp_max(mx);
    float e[kVR], cur[kVR], tot = 0.f;
#pragma unroll
    for (int i = 0; i < kVR; ++i) {
      e[i] = s[i] > kNeg * 0.5f ? expf(s[i] - mx) : 0.f;
      tot += e[i];
      cur[i] = s[i];
    }
    const float target = a.top_p * warp_sum(tot);
    float thr = kNeg, cum = 0.f;
    for (int it = 0; it < V; ++it) {
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < kVR; ++i) m = fmaxf(m, cur[i]);
      m = warp_max(m);
      float grp = 0.f;
#pragma unroll
      for (int i = 0; i < kVR; ++i) {
        if (cur[i] == m) {
          grp += e[i];
          cur[i] = kNeg;
        }
      }
      grp = warp_sum(grp);
      if (cum < target && m > kNeg * 0.5f) thr = m;
      cum += grp;
    }
#pragma unroll
    for (int i = 0; i < kVR; ++i)
      if (lane + 32 * i < V) s[i] = s[i] >= thr ? s[i] : kNeg;
  }
#pragma unroll
  for (int i = 0; i < kVR; ++i) {
    const int v = lane + 32 * i;
    if (v < V) {
      const uint32_t bits = hash_bits(a.seed, (uint32_t)j, (uint32_t)v, (uint32_t)b, 0u);
      const float u01 = ((float)(bits >> 9) + 0.5f) * (1.f / 8388608.f);
      s[i] += -logf(-logf(u01));
    }
  }
  return warp_argmax(s, V);
}

// The token slot b feeds at the step its cursor p points to: its prompt
// while p < plen (token 0 where p lies past the prompt buffer, as the TPU
// tick's masked reduction finds no row there), else its last prediction.
__device__ __forceinline__ int fed_token(const Args& a, int b, int p) {
  if (p < a.plen[b]) return p < a.P ? a.prompt[(size_t)b * a.P + p] : 0;
  return __ldcg(a.prev + b);
}

// h_next of slot b, unit `unit` (block-local ul) from its three recurrent
// sums: the gates of `_gru_step`, h held while the slot is inactive. The
// bf16 copy of h_next is written too when there is one.
__device__ __forceinline__ void update_unit(const Args& a, const float* proj_s, int nc, int tok,
                                            int active, int b, int unit, int ul, float mz,
                                            float mr, float mh, const float* hc, float* hn,
                                            __nv_bfloat16* hbn) {
  const int U = a.U;
  const float* b0 = a.bias;
  const float* b1 = a.bias + 3 * U;
  const float* pr = proj_s + (size_t)tok * nc + ul * 3;
  const float z = sigmoidf((pr[0] + b0[unit]) + (mz + b1[unit]));
  const float r = sigmoidf((pr[1] + b0[U + unit]) + (mr + b1[U + unit]));
  const float hh = tanhf((pr[2] + b0[2 * U + unit]) + r * (mh + b1[2 * U + unit]));
  const float hprev = __ldcg(hc + (size_t)b * U + unit);
  const float hnew = active ? z * hprev + (1.f - z) * hh : hprev;
  hn[(size_t)b * U + unit] = hnew;
  if (hbn) hbn[(size_t)b * U + unit] = __float2bfloat16_rn(hnew);
}

// Phase A: this block's units of h_next = gru(h_cur, token), every slot.
// h is staged 32 K rows at a time (float4 loads); the next chunk's loads
// are issued into registers before the current chunk's FMAs, so the L2
// latency hides behind the arithmetic.
__device__ void phase_a(const Args& a, const Geom& g, const float* u_s, const float* proj_s,
                        float* work, int* tok_s, int* act_s, const float* hc, float* hn) {
  constexpr int kQ = kST * kKT / 4 / kThreads;  // float4 per thread per chunk (8)
  const int U = a.U, B = a.B, nc = 3 * g.ub, bf16 = a.bf16;
  const int tid = threadIdx.x, uo = tid & (kUG - 1), sg = tid / kUG;
  const int unit0 = blockIdx.x * g.ub;
  for (int s0 = 0; s0 < B; s0 += kST) {
    __syncthreads();  // the previous tile's readers of tok_s / act_s are done
    for (int s = tid; s < kST; s += kThreads) {
      const int b = s0 + s;
      int tk = 0, ac = 0;
      if (b < B) {
        const int p = __ldcg(a.pos + b);
        tk = fed_token(a, b, p);
        ac = p < a.total[b];
      }
      tok_s[s] = tk;
      act_s[s] = ac;
    }
    for (int ug = 0; ug < g.ub; ug += kUG) {
      const int ul = ug + uo, unit = unit0 + ul;
      const bool live = ul < g.ub && unit < U;
      float acc[kSPT][3];
#pragma unroll
      for (int i = 0; i < kSPT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.f;
      float4 pre[kQ];
      auto fetch = [&](int k0) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int i = tid + q * kThreads, kq = i % (kKT / 4), b = s0 + i / (kKT / 4);
          pre[q] = b < B ? __ldcg(reinterpret_cast<const float4*>(hc + (size_t)b * U + k0) + kq)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      };
      fetch(0);
      for (int k0 = 0; k0 < U; k0 += kKT) {
        __syncthreads();  // the previous chunk's readers are done
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int i = tid + q * kThreads, kq = i % (kKT / 4), s = i / (kKT / 4);
          float* w = work + 4 * kq * kHS + s;
          w[0] = rc(pre[q].x, bf16);
          w[kHS] = rc(pre[q].y, bf16);
          w[2 * kHS] = rc(pre[q].z, bf16);
          w[3 * kHS] = rc(pre[q].w, bf16);
        }
        __syncthreads();
        if (k0 + kKT < U) fetch(k0 + kKT);
        if (live) {
          const float* up = u_s + (size_t)k0 * nc + ul * 3;
          const float* hp = work + sg * kSPT;
#pragma unroll 8
          for (int kk = 0; kk < kKT; ++kk) {
            const float w0 = up[kk * nc], w1 = up[kk * nc + 1], w2 = up[kk * nc + 2];
            const float4 ha = *reinterpret_cast<const float4*>(hp + kk * kHS);
            const float4 hb = *reinterpret_cast<const float4*>(hp + kk * kHS + 4);
            const float hv[kSPT] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
            for (int i = 0; i < kSPT; ++i) {
              acc[i][0] = fmaf(hv[i], w0, acc[i][0]);
              acc[i][1] = fmaf(hv[i], w1, acc[i][1]);
              acc[i][2] = fmaf(hv[i], w2, acc[i][2]);
            }
          }
        }
      }
      if (live) {
#pragma unroll
        for (int i = 0; i < kSPT; ++i) {
          const int s = sg * kSPT + i, b = s0 + s;
          if (b < B)
            update_unit(a, proj_s, nc, tok_s[s], act_s[s], b, unit, ul, acc[i][0], acc[i][1],
                        acc[i][2], hc, hn, nullptr);
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// Phase A at bf16 compute, on tensor cores: the same sums as phase_a (bf16
// operands, exact products, f32 sums, in another order). Each warp owns 16
// slots of a 128-slot tile and the 24 gate columns of 8 units (3 n-tiles of
// m16n8k16). A fragments come from the staged bf16 copy of h (slot rows,
// K contiguous), B fragments from the block's recurrent slice kept in
// shared memory as bf16 [column][K]; both padded so that the 32 lanes of a
// fragment load hit 32 banks. The f32 sums go through a small shared tile
// to the unit update, which needs all three gates of a unit at once.
__device__ void phase_a_mma(const Args& a, const Geom& g, const __nv_bfloat16* u_bf,
                            const float* proj_s, float* work, int* tok_s, int* act_s,
                            const float* hc, float* hn, const __nv_bfloat16* hbc,
                            __nv_bfloat16* hbn) {
  constexpr int kQ = kMS * kMK / 8 / kThreads;  // 16-byte loads per thread per chunk (4)
  const int U = a.U, B = a.B, nc = 3 * g.ub, ksu = U + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int unit0 = blockIdx.x * g.ub;
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(work);  // (kMS, kMA) bf16
  float* accs = work + kMS * kMA / 2;                           // (kMS, kACS) f32
  for (int s0 = 0; s0 < B; s0 += kMS) {
    __syncthreads();  // the previous tile's readers of tok_s / act_s are done
    for (int s = tid; s < kMS; s += kThreads) {
      const int b = s0 + s;
      int tk = 0, ac = 0;
      if (b < B) {
        const int p = __ldcg(a.pos + b);
        tk = fed_token(a, b, p);
        ac = p < a.total[b];
      }
      tok_s[s] = tk;
      act_s[s] = ac;
    }
    for (int ug = 0; ug < g.ub; ug += kUG) {
      const int c0 = 3 * ug;  // first gate column of this group of units
      float acc[3][4];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      uint4 pre[kQ];
      auto fetch = [&](int k0) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int i = tid + q * kThreads, kq = i % (kMK / 8), b = s0 + i / (kMK / 8);
          const int k = k0 + 8 * kq;
          pre[q] = (b < B && k < U)
                       ? __ldcg(reinterpret_cast<const uint4*>(hbc + (size_t)b * U + k))
                       : make_uint4(0u, 0u, 0u, 0u);
        }
      };
      fetch(0);
      for (int k0 = 0; k0 < U; k0 += kMK) {
        __syncthreads();  // the previous chunk's readers are done
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int i = tid + q * kThreads, kq = i % (kMK / 8), s = i / (kMK / 8);
          *reinterpret_cast<uint4*>(hs + s * kMA + 8 * kq) = pre[q];
        }
        __syncthreads();
        if (k0 + kMK < U) fetch(k0 + kMK);
        const __nv_bfloat16* ar = hs + (warp * 16 + gq) * kMA + 2 * tq;
#pragma unroll
        for (int ks = 0; ks < kMK; ks += 16) {
          const uint32_t a0 = ld32(ar + ks), a1 = ld32(ar + 8 * kMA + ks);
          const uint32_t a2 = ld32(ar + ks + 8), a3 = ld32(ar + 8 * kMA + ks + 8);
          const int kb = k0 + ks + 2 * tq;
#pragma unroll
          for (int nt = 0; nt < 3; ++nt) {
            const int c = c0 + nt * 8 + gq;
            uint32_t b0 = 0u, b1 = 0u;
            if (c < nc) {
              const __nv_bfloat16* br = u_bf + (size_t)c * ksu + kb;
              if (kb < U) b0 = ld32(br);
              if (kb + 8 < U) b1 = ld32(br + 8);
            }
            mma_bf16(acc[nt], a0, a1, a2, a3, b0, b1);
          }
        }
      }
      const int r = warp * 16 + gq;
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
        const int col = nt * 8 + 2 * tq;
        accs[r * kACS + col] = acc[nt][0];
        accs[r * kACS + col + 1] = acc[nt][1];
        accs[(r + 8) * kACS + col] = acc[nt][2];
        accs[(r + 8) * kACS + col + 1] = acc[nt][3];
      }
      __syncthreads();
      for (int i = tid; i < kMS * kUG; i += kThreads) {
        const int s = i / kUG, uo = i % kUG, ul = ug + uo, unit = unit0 + ul, b = s0 + s;
        if (ul >= g.ub || unit >= U || b >= B) continue;
        const float* m = accs + s * kACS + uo * 3;
        update_unit(a, proj_s, nc, tok_s[s], act_s[s], b, unit, ul, m[0], m[1], m[2], hc, hn,
                    hbn);
      }
    }
  }
}

// Phase B: logits, next token and cursors for 32-slot tiles of h_next.
// h and the dequantized head are staged 32 K rows at a time, the next
// chunk prefetched into registers during the current chunk's FMAs.
__device__ void phase_b(const Args& a, float* work, const float* hn, int j) {
  constexpr int kDQ = kLK * kMaxV / 4 / kThreads;  // most float4 of D per thread (8)
  const int U = a.U, V = a.V, B = a.B, bf16 = a.bf16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vl = tid & 127, half = tid >> 7;  // vocab lane; slots half*16 .. +15
  const int nd = kLK * V / 4;                  // float4 of D per chunk
  float* hb = work;              // (kLK, kLS) staged rc(h), slot-contiguous rows
  float* db = hb + kLK * kLS;    // (kLK, V) staged dequantized head rows
  float* lg = db + kLK * V;      // (kLT, V) logits
  for (int t0 = blockIdx.x * kLT; t0 < B; t0 += gridDim.x * kLT) {
    float acc[2][16];
#pragma unroll
    for (int vi = 0; vi < 2; ++vi)
#pragma unroll
      for (int s = 0; s < 16; ++s) acc[vi][s] = 0.f;
    // one float4 of h per thread: slot tid / 8, K quad tid % 8
    const int hs = tid / (kLK / 4), hq = tid % (kLK / 4), hbidx = t0 + hs;
    float4 hpre, dpre[kDQ];
    auto fetch = [&](int k0) {
      hpre = hbidx < B
                 ? __ldcg(reinterpret_cast<const float4*>(hn + (size_t)hbidx * U + k0) + hq)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4* dsrc = reinterpret_cast<const float4*>(a.ddeq + (size_t)k0 * V);
#pragma unroll
      for (int q = 0; q < kDQ; ++q) {
        const int i = tid + q * kThreads;
        if (i < nd) dpre[q] = __ldcg(dsrc + i);
      }
    };
    fetch(0);
    for (int k0 = 0; k0 < U; k0 += kLK) {
      __syncthreads();  // the previous chunk's (or tile's) readers are done
      {
        float* w = hb + 4 * hq * kLS + hs;
        w[0] = rc(hpre.x, bf16);
        w[kLS] = rc(hpre.y, bf16);
        w[2 * kLS] = rc(hpre.z, bf16);
        w[3 * kLS] = rc(hpre.w, bf16);
      }
#pragma unroll
      for (int q = 0; q < kDQ; ++q) {
        const int i = tid + q * kThreads;
        if (i < nd) reinterpret_cast<float4*>(db)[i] = dpre[q];
      }
      __syncthreads();
      if (k0 + kLK < U) fetch(k0 + kLK);
#pragma unroll 4
      for (int kk = 0; kk < kLK; ++kk) {
        const float4* hp = reinterpret_cast<const float4*>(hb + kk * kLS + half * 16);
        const float4 q0 = hp[0], q1 = hp[1], q2 = hp[2], q3 = hp[3];
        const float hv[16] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                              q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w};
#pragma unroll
        for (int vi = 0; vi < 2; ++vi) {
          const int v = vl + 128 * vi;
          if (v < V) {
            const float d = db[kk * V + v];
#pragma unroll
            for (int s = 0; s < 16; ++s) acc[vi][s] = fmaf(hv[s], d, acc[vi][s]);
          }
        }
      }
    }
#pragma unroll
    for (int vi = 0; vi < 2; ++vi) {
      const int v = vl + 128 * vi;
      if (v < V) {
#pragma unroll
        for (int s = 0; s < 16; ++s) lg[(half * 16 + s) * V + v] = acc[vi][s] + a.dbias[v];
      }
    }
    __syncthreads();
    for (int s = warp; s < kLT; s += kThreads / 32) {
      const int b = t0 + s;
      if (b >= B) continue;  // warp-uniform
      const int p = __ldcg(a.pos + b);
      const int tk = fed_token(a, b, p);
      const float temp = a.sampling ? a.temp[b] : 0.f;
      const int pred = select_token(lg + (size_t)s * V, a, temp, j, b);
      if (lane == 0) {
        const size_t o = (size_t)b * a.steps + j;
        if (a.toks_u8) {
          ((uint8_t*)a.toks)[o] = (uint8_t)tk;
        } else {
          ((int*)a.toks)[o] = tk;
        }
        if (p < a.total[b]) {
          a.prev[b] = pred;
          a.pos[b] = p + 1;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) gru_loop_kernel(Args a, Geom g) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int U = a.U, G = 3 * U, V = a.V, E = a.E;
  const int nc = 3 * g.ub, bf16 = a.bf16, wmode = a.wmode;
  float* u_s = smem;                 // (U, nc) dequantized recurrent slice
  float* proj_s = smem + g.proj_off;  // (V, nc) input-projection slice
  float* work = smem + g.work_off;   // phase A / phase B staging
  int* tok_s = reinterpret_cast<int*>(smem + g.tok_off);  // (kST) token fed
  int* act_s = tok_s + kST;          // (kST) slot active
  const int tid = threadIdx.x;
  const int unit0 = blockIdx.x * g.ub;

  // ---- setup: weight slices into shared memory, head into global scratch
  if (bf16) {
    // (nc, U + 8) bf16, [column][K]: the tensor-core B operand of phase_a_mma
    __nv_bfloat16* u_bf = reinterpret_cast<__nv_bfloat16*>(u_s);
    const int ksu = U + 8;
    for (int i = tid; i < nc * ksu; i += kThreads) {
      const int c = i / ksu, k = i % ksu, unit = unit0 + c / 3;
      float v = 0.f;
      if (k < U && unit < U) {
        const int col = (c % 3) * U + unit;
        v = wdec(a.uc, a.us, k, col, G, wmode);
      }
      u_bf[i] = __float2bfloat16_rn(v);
    }
  } else {
    for (int i = tid; i < U * nc; i += kThreads) {
      const int k = i / nc, c = i % nc, unit = unit0 + c / 3;
      float v = 0.f;
      if (unit < U) {
        const int col = (c % 3) * U + unit;
        v = wdec(a.uc, a.us, k, col, G, wmode);
      }
      u_s[i] = v;
    }
  }
  for (int i = tid; i < V * nc; i += kThreads) {
    const int vv = i / nc, c = i % nc, unit = unit0 + c / 3;
    float acc = 0.f;
    if (unit < U) {
      const int col = (c % 3) * U + unit;
      for (int e = 0; e < E; ++e) {
        const float w = rc(wdec(a.wc, a.ws, e, col, G, wmode), bf16);
        acc = fmaf(rc(a.emb[(size_t)vv * E + e], bf16), w, acc);
      }
    }
    proj_s[i] = rc(acc, bf16);
  }
  for (size_t i = (size_t)blockIdx.x * kThreads + tid; i < (size_t)U * V;
       i += (size_t)gridDim.x * kThreads) {
    const int k = (int)(i / V), vv = (int)(i % V);
    a.ddeq[i] = rc(wdec(a.dc, a.ds, k, vv, V, wmode), bf16);
  }
  grid.sync();

  for (int j = 0; j < a.steps; ++j) {
    const float* hc = (j & 1) ? a.h1 : a.h0;
    float* hn = (j & 1) ? a.h0 : a.h1;
    if (bf16) {
      const __nv_bfloat16* hbc = static_cast<const __nv_bfloat16*>((j & 1) ? a.hb1 : a.hb0);
      __nv_bfloat16* hbn = static_cast<__nv_bfloat16*>((j & 1) ? a.hb0 : a.hb1);
      phase_a_mma(a, g, reinterpret_cast<const __nv_bfloat16*>(u_s), proj_s, work, tok_s,
                  act_s, hc, hn, hbc, hbn);
    } else {
      phase_a(a, g, u_s, proj_s, work, tok_s, act_s, hc, hn);
    }
    grid.sync();
    phase_b(a, work, hn, j);
    grid.sync();
  }
}

int launch(const Args& a, void* stream) {
  if (a.B <= 0 || a.steps <= 0) return 0;
  // whole 32-row chunks of K: U % 32 == 0 (the wrapper checks it too)
  if (a.V > kMaxV || a.V <= 0 || a.U <= 0 || a.U % kKT || a.E <= 0 ||
      (a.bf16 && (a.hb0 == nullptr || a.hb1 == nullptr)) || a.wmode < 0 || a.wmode > 2 ||
      a.wc == nullptr || a.uc == nullptr || a.dc == nullptr ||
      (a.wmode != 2 && (a.ws == nullptr || a.us == nullptr || a.ds == nullptr)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  Geom g;
  g.ub = (a.U + sms - 1) / sms;
  const int grid = (a.U + g.ub - 1) / g.ub;
  const int nc = 3 * g.ub;
  const int work_a = kKT * kHS;
  const int work_b = kLK * kLS + 2 * kLT * a.V;
  g.proj_off = align4(a.U * nc);
  g.work_off = g.proj_off + align4(a.V * nc);
  g.tok_off = g.work_off + align4(work_a > work_b ? work_a : work_b);
  const size_t smem = ((size_t)g.tok_off + 2 * kST) * sizeof(float);
  err = cudaFuncSetAttribute(gru_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gru_loop_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // every block must be resident at once, or a grid sync never returns
  if (per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  Args ka = a;
  void* kargs[] = {&ka, &g};
  err = cudaLaunchCooperativeKernel((void*)gru_loop_kernel, grid, kThreads, kargs, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gxt_fused_gru_decode(const Args* a, void* stream) {
  Args c = *a;
  c.sampling = 0;
  c.temp = nullptr;
  return launch(c, stream);
}

extern "C" int gxt_fused_slot_tick(const Args* a, void* stream) { return launch(*a, stream); }

extern "C" int gxt_args_size() { return (int)sizeof(Args); }

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
