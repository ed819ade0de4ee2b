// Persistent GRU decode loop: the whole multi-step decode in one launch of
// a loop kernel, after a short setup launch on the same stream. Two entry
// points share the kernels:
//
//   gxt_fused_gru_decode  replaces ggml_experiments_tpu/ops/fused_gru_decode.py
//                         `_fused_decode_jit` (pallas_call :227; body `_kernel`
//                         :104, `_gru_step` :58, `_dequant_to` :42)
//   gxt_fused_slot_tick   replaces the same file's `_tick_call` (pallas_call
//                         :774; body `_tick_kernel` :564, `_filter_topk_vb`
//                         :508, `_filter_topp_vb` :533, `_hash_bits_u32` :476)
//
// Offline decode is the tick with every slot starting at pos 0, h 0, prev 0
// and total = steps, so the kernels serve both; only the wrappers differ.
// The step (gather -> gates -> h update -> logits -> token) is `_gru_step`:
// planes and table rounded to the compute dtype, h rounded before each
// product, f32 sums and f32 state, the first index of the maximum.
//
// Setup (setup_kernel). The weights arrive by one of three routes
// (Args.wmode), as `_dequant_to` takes them: q8_0 (int8 codes x f32 block
// scales) and q4_0 (block-local packed nibbles, (nib - 8) x scale) are
// decoded here, "dense" planes (q4_1, q5_0, q5_1, q4_k and mixed formats,
// dequantized to f32 beforehand) are copied. It writes, once per launch:
// the input-projection table round(round(emb) . round(W)) (V x 3U; bf16 at
// bf16 compute, whose values it already is, f32 otherwise); at bf16 the
// recurrent plane as bf16 rows [unit group of 8][gate][unit] x K padded to
// 64 (`wl`) and the head as bf16 [vocab][K] (`dl`), for the slot-owned loop
// cut into the tiles of its ring, each contiguous and swizzled; at f32 the
// head as f32 (U, V). The loop kernels never see the route.
//
// Bound on an H100 at the reference shape (U=1024, E=256, V=66). Per step
// and slot 2*(3U*U + U*V) = 6.4 MFLOP of gate and head products: at the
// bf16 tensor-core peak 6.5 ns per slot-step (decode B=8192, T=512: 27 ms;
// one 512 x 128 tick: 0.43 ms). No weight byte needs to come from HBM more
// than once, so the operations bound both. What the card cannot avoid is
// moving operands from L2 into the multiprocessors every step, and how many
// depends on how the work is cut:
//   * unit-owned: a block keeps the plane columns of its 8 units (24 x U
//     bf16, 48 KB) in shared memory and must read ALL of h (B x U bf16)
//     every step: 2 KB x B a block, 128 blocks (2.1 GB a step at B=8192,
//     128 MB at B=512), plus two grid syncs a step (h and the tokens cross
//     blocks);
//   * slot-owned: a block owns 64 slots for the whole loop, keeps their h
//     (128 KB bf16) in shared memory, and streams the whole plane (6.3 MB)
//     and the head (0.15 MB) every step: 6.4 MB a block, B / 64 blocks (0.8
//     GB a step at B=8192). No slot depends on another: no grid sync, no
//     cooperative launch.
// On an H100 a block takes in its operands at ~20-27 GB/s whichever way
// (bulk copies or cp.async, 3 or 4 stages, one copy or eight a tile, half
// the L2 reads through a cluster multicast, all tried: PERF.md), and two
// blocks on a multiprocessor at nearly twice that. So a slot-owned step
// takes ~270 us at any B and a unit-owned one grows with B; they cross near
// B=3300. ops/fused_gru_decode.py `decode_plan` picks the cut from B
// (Args.decomp) and, slot-owned, the deepest ring that fits shared memory
// (Args.stages).
//
// slot_loop_kernel (bf16 only). 8 consumer warps (two warpgroups) and a
// producer warp. The producer streams the plane (per 64-unit pass, 16 K
// chunks of 192 rows, [group][gate][unit]) and then the head through a
// ring of 24 KB tiles, each one TMA bulk copy of a tile the setup wrote
// contiguous and already swizzled; full/empty mbarriers hand the buffers
// over. The gate products run on wgmma
// (m64n96k16 per warpgroup: all 64 slots x 4 unit groups), so a lane holds
// the z, r and h sums of its units and the update needs no exchange; the
// ring runs on across passes and steps (the weights do not change). h_next
// cannot overwrite h in shared memory before the last pass has read it, so
// the update writes it (bf16) to global memory and the block reloads its
// rows before the head product; the f32 state is updated in place (each
// entry has one reader and writer, the same thread). Head logits on
// mma.sync into the buffer of the last head tile, then a warp per slot
// picks the token.
//
// unit_loop_kernel (bf16 and f32; cooperative, U/8 unit groups, each owned
// at f32 by one block and at bf16 by two blocks that share a multiprocessor
// and deal the slot tiles between them). bf16: the group's plane columns
// live in shared memory; h streams through a three-stage cp.async ring of
// 128-slot x 64-K tiles that runs on across slot tiles; products on
// mma.sync. f32: the plane slice in shared memory as f32, h staged through
// registers, CUDA-core FMAs (the f32 route is held token-exact). Grid sync.
// Then the logits: every block takes its share of B / grid slots (the whole
// grid works), bf16 on tensor cores with K split over the 8 warps and
// summed in warp order, f32 on CUDA cores in K order with h and the head
// rows through a two-stage cp.async ring; a warp per slot picks the token.
// Grid sync.
//
// Any vocabulary (the TPU wrapper pads V to 128, fused_gru_decode.py:345): the
// slot-owned head streams in vocabulary tiles of up to 192 rows, the f32
// unit-owned head in chunks of 256 columns. Where a block's logits outgrow
// shared memory (past 96 entries slot-owned, past kSmemV unit-owned) they
// go through Args::lg, a (B, Vp) f32 scratch the wrapper keeps, and past
// kSmemV a unit-owned block reads its table entries from device memory
// instead of keeping its V x 24 slice. The slot's warp holds up to kRegV
// logits in registers and past that walks its row in memory
// (select_token_wide). U is padded to a multiple of 32 by the wrapper (zero
// gate columns and biases: the padded units stay 0), as the TPU wrapper
// pads it (fused_gru_decode.py:352).
//
// Values that change during a unit-owned loop (h, prev, pos) are read with
// __ldcg (or cp.async.cg, which bypasses L1) so that no stale L1 line
// survives a grid sync. No atomics and no
// order that depends on timing: two launches give the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "hopper_common.cuh"
#include "mma_common.cuh"

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
  float* h0;            // (B, U) initial state; the state of a slot-owned loop
  float* h1;            // (B, U) second buffer (unit-owned)
  void* toks;           // (B, steps) int32 or uint8
  const float* temp;    // (B) or null
  void* hb0;            // (B, U) bf16 copy of h0, bf16 compute only (else null)
  void* hb1;            // (B, U) bf16 copy of h1 (unit-owned)
  void* proj;           // (V, G) input-projection table: bf16 at bf16, else f32
  void* wl;             // bf16: (G, Kp) recurrent plane [group][gate][unit] x K
  void* dl;             // head: bf16 (Vp, Kp) [vocab][K] at bf16; f32 at f32, chunks of
                        // (U, f32_vc(V)) vocab columns
  float* lg;            // (B, Vp) f32 logits scratch where they leave shared memory
                        // (slot-owned past slot_lg_in_ring, unit-owned past kSmemV), else null
  int V, E, U, P, B, steps, toks_u8, bf16;
  int sampling, top_k;
  int wmode;            // weight route: 0 q8_0, 1 q4_0, 2 dense
  int decomp;           // 0 unit-owned, 1 slot-owned
  int stages;           // slot-owned: depth of the weight ring (3 or 4)
  int slot_base;        // sampling: the global slot of the launch's column 0
  int key_tile;         // sampling: the width of a noise block; 0 = the whole launch
  float top_p;
  uint32_t seed;
};

namespace {

using gxt::bf16;
using gxt::cp_async16;
using gxt::cp_async_commit;
using gxt::cp_async_wait;
using gxt::mma_bf16;
using gxt::bulk_load;
using gxt::desc_k;
using gxt::fence_async_smem;
using gxt::mbar_arrive;
using gxt::mbar_expect;
using gxt::mbar_init;
using gxt::mbar_init_fence;
using gxt::mbar_wait;
using gxt::smem_u32;
using gxt::wg_commit;
using gxt::wg_fence;
using gxt::wg_pin;
using gxt::wg_wait;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowK = 64;           // K of a unit-owned ring row: 128 bytes of bf16
constexpr int kUnitSlots = 128;     // slots of a unit-owned h tile (8 warps x 16)
constexpr int kUnitStages = 3;      // bf16 unit-owned h ring: what fits two blocks a multiprocessor
constexpr int kUnitSplit = 2;       // bf16 unit-owned blocks a unit group's slot tiles are dealt to
constexpr int kSlotS = 64;          // slots of a slot-owned block: one wgmma M tile
constexpr int kPassRows = 192;      // plane rows of a slot-owned 64-unit pass
constexpr int kTileElems = kPassRows * kRowK;   // a slot-owned ring tile: 24 KB
constexpr int kHsBlock = kSlotS * kRowK;        // one 64-K block of a slot-owned h
constexpr int kRegV = 256;          // vocab the per-slot warp holds in registers (8 a lane);
                                    // past it the warp walks the row in memory
constexpr int kVR = kRegV / 32;
constexpr int kHeadRows = 192;      // vocab rows of a slot-owned head tile: a 24 KB ring buffer
constexpr int kSmemV = 128;         // unit-owned: the table slice and the logits stay in shared
                                    // memory up to this V (two bf16 blocks an SM at U = 1024)
constexpr int kVC = 256;            // f32 unit-owned: vocab columns of a head chunk past 256
constexpr int kHeadNT = 9;          // n-tiles of a unit-owned head chunk: 72 columns, the
                                    // reference's V=66 in one pass (12 made the bf16
                                    // unit-owned loop spill at its 128 registers)
constexpr float kNeg = -1e30f;      // the TPU kernel's NEG mask value
// f32 unit-owned phase A (as before: 8 units x 32 slot groups of 8 slots)
constexpr int kUG = 8;
constexpr int kSPT = 8;
constexpr int kST = 32 * kSPT;
constexpr int kKT = 32;
constexpr int kHS = kST + 4;
constexpr int kBK = 32;             // K rows of an f32 phase-B chunk (U % 32 == 0)

__host__ __device__ inline int kp_of(int u) { return (u + kRowK - 1) / kRowK * kRowK; }
__host__ __device__ inline int vp_of(int v) { return (v + 7) & ~7; }
__host__ __device__ inline int f32_vc(int v) { return v <= kVC ? v : kVC; }
__host__ __device__ inline bool unit_small(int v) { return v <= kSmemV; }
// rows of slot-owned head tile vt (the last may be short)
__host__ __device__ inline int head_rows(int vp, int vt) {
  return vp - kHeadRows * vt < kHeadRows ? vp - kHeadRows * vt : kHeadRows;
}
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// element offset of 16-byte chunk c of row r in a swizzled bf16 tile whose
// rows are `ld` elements (a multiple of 64): the low three bits of the
// chunk index are XORed with the row's, so eight rows read at one logical
// chunk fall in eight distinct bank groups
__device__ __forceinline__ int swz(int r, int c, int ld) { return r * ld + ((c ^ (r & 7)) << 3); }

__device__ __forceinline__ void ldsm_x4(const bf16* p, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

__device__ __forceinline__ float rc(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

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

// h_next of one unit from its three input projections (bias added here),
// its three recurrent sums and h: the gates of `_gru_step`, h held while
// the slot is inactive
__device__ __forceinline__ float gru_unit(const float* bias, int U, int unit, float px, float pr,
                                          float ph, float mz, float mr, float mh, float hprev,
                                          int active) {
  const float* b0 = bias;
  const float* b1 = bias + 3 * U;
  const float z = sigmoidf((px + b0[unit]) + (mz + b1[unit]));
  const float r = sigmoidf((pr + b0[U + unit]) + (mr + b1[U + unit]));
  const float hh = tanhf((ph + b0[2 * U + unit]) + r * (mh + b1[2 * U + unit]));
  return active ? z * hprev + (1.f - z) * hh : hprev;
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
// The TPU tick keys each block (a tile of its sequential grid, or a shard of
// a slot-partitioned tick) on the column within the block plus the block's
// first global slot; select_token cuts the launch into the same blocks
// (Args::key_tile wide, the first at global slot Args::slot_base).
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
  const int tile0 = a.key_tile > 0 ? b / a.key_tile * a.key_tile : 0;
#pragma unroll
  for (int i = 0; i < kVR; ++i) {
    const int v = lane + 32 * i;
    if (v < V) {
      const uint32_t bits = hash_bits(a.seed, (uint32_t)j, (uint32_t)v, (uint32_t)(b - tile0),
                                      (uint32_t)(a.slot_base + tile0));
      const float u01 = ((float)(bits >> 9) + 0.5f) * (1.f / 8388608.f);
      s[i] += -logf(-logf(u01));
    }
  }
  return warp_argmax(s, V);
}

// select_token past kRegV: the warp walks the slot's logits row in memory
// (shared or the device scratch), 32 entries a pass, and writes nothing back:
// the scaled, masked and noised scores are recomputed from the row at each
// pass. Extraction needs no copy of the row either: its next group is the
// maximum of the scores below the last group's value. The same thresholds
// as select_token: top-k's after k counted entries, top-p's where the mass
// reaches top_p (the walk stops there, as no later group moves it).
__device__ int select_token_wide(const float* lg, const Args& a, float temp, int j, int b) {
  const int lane = threadIdx.x & 31;
  const int V = a.V;
  // the first index of the maximum of f(v) over v < V
  auto argmax = [&](auto f) {
    float m = -INFINITY;
    int idx = 1 << 30;
    for (int v = lane; v < V; v += 32) {
      const float x = f(v);
      if (x > m) {
        m = x;
        idx = v;
      }
    }
    const float mm = warp_max(m);
    return warp_min_i(m == mm ? idx : 1 << 30);
  };
  if (!(temp > 0.f)) return argmax([&](int v) { return lg[v]; });

  const float inv_t = 1.f / fmaxf(temp, 1e-6f);
  float thr_k = -INFINITY;  // no top-k mask: every score is kept
  auto sk = [&](int v) {
    const float x = lg[v] * inv_t;
    return x >= thr_k ? x : kNeg;
  };
  if (a.top_k > 0) {
    const int k = min(a.top_k, V);
    float thr = kNeg, above = INFINITY;
    int cnt = 0;
    while (cnt < k) {
      float lm = -INFINITY;
      int lc = 0;
      for (int v = lane; v < V; v += 32) {
        const float x = lg[v] * inv_t;
        if (x < above) {
          if (x > lm) {
            lm = x;
            lc = 1;
          } else if (x == lm) {
            ++lc;
          }
        }
      }
      const float m = warp_max(lm);
      const int c = warp_sum_i(lm == m ? lc : 0);
      if (c == 0) break;  // nothing left below the last group
      thr = m;
      cnt += c;
      above = m;
    }
    thr_k = thr;
  }
  float thr_p = -INFINITY;
  if (a.top_p > 0.f) {
    float lmx = -INFINITY;
    for (int v = lane; v < V; v += 32) lmx = fmaxf(lmx, sk(v));
    const float mx = warp_max(lmx);
    float tot = 0.f;
    for (int v = lane; v < V; v += 32) {
      const float x = sk(v);
      tot += x > kNeg * 0.5f ? expf(x - mx) : 0.f;
    }
    const float target = a.top_p * warp_sum(tot);
    float thr = kNeg, cum = 0.f, above = INFINITY;
    while (cum < target) {
      // the next group below `above`: its value and its mass, in one pass
      float lm = -INFINITY, ls = 0.f;
      for (int v = lane; v < V; v += 32) {
        const float x = sk(v);
        if (x < above && x >= lm) {
          const float e = x > kNeg * 0.5f ? expf(x - mx) : 0.f;
          ls = x > lm ? e : ls + e;
          lm = x;
        }
      }
      const float m = warp_max(lm);
      if (!(m > kNeg * 0.5f)) break;  // no live score left
      thr = m;
      cum += warp_sum(lm == m ? ls : 0.f);
      above = m;
    }
    thr_p = thr;
  }
  const int tile0 = a.key_tile > 0 ? b / a.key_tile * a.key_tile : 0;
  return argmax([&](int v) {
    const float x = sk(v);
    const uint32_t bits = hash_bits(a.seed, (uint32_t)j, (uint32_t)v, (uint32_t)(b - tile0),
                                    (uint32_t)(a.slot_base + tile0));
    const float u01 = ((float)(bits >> 9) + 0.5f) * (1.f / 8388608.f);
    return (x >= thr_p ? x : kNeg) + -logf(-logf(u01));
  });
}

// The token slot b feeds at the step its cursor p points to: its prompt
// while p < plen (token 0 where p lies past the prompt buffer, as the TPU
// tick's masked reduction finds no row there), else its last prediction.
__device__ __forceinline__ int fed_token(const Args& a, int b, int p) {
  if (p < a.plen[b]) return p < a.P ? a.prompt[(size_t)b * a.P + p] : 0;
  return __ldcg(a.prev + b);
}

// Slot b's token for step j from its logits row (one warp): the fed token
// is recorded, and an active slot moves its cursor and keeps its prediction.
// WV: the vocabulary is past kSmemV. The loop kernels are instantiated for
// each: a narrow vocabulary's code keeps everything in shared memory and
// registers, the wide one's takes the device scratch, the table in device
// memory and, past kRegV, the walk of the row in memory.
template <bool WV>
__device__ __forceinline__ void finish_slot(const Args& a, const float* lg, int j, int b, int tk,
                                            int p) {
  const float temp = a.sampling ? a.temp[b] : 0.f;
  int pred;
  if constexpr (WV) {
    pred = a.V <= kRegV ? select_token(lg, a, temp, j, b) : select_token_wide(lg, a, temp, j, b);
  } else {
    pred = select_token(lg, a, temp, j, b);
  }
  if ((threadIdx.x & 31) == 0) {
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

// ---------------------------------------------------------------------------
// setup: the table, and the planes in the loop kernels' layouts
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) setup_kernel(Args a) {
  const int U = a.U, G = 3 * U, V = a.V, E = a.E, Kp = kp_of(U), Vp = vp_of(V);
  const int use_bf16 = a.bf16, wmode = a.wmode;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nth = (size_t)gridDim.x * blockDim.x;
  for (size_t i = tid; i < (size_t)V * G; i += nth) {
    const int v = (int)(i / G), col = (int)(i % G);
    float acc = 0.f;
    for (int e = 0; e < E; ++e) {
      const float w = rc(wdec(a.wc, a.ws, e, col, G, wmode), use_bf16);
      acc = fmaf(rc(a.emb[(size_t)v * E + e], use_bf16), w, acc);
    }
    if (use_bf16) {
      static_cast<bf16*>(a.proj)[i] = __float2bfloat16_rn(acc);
    } else {
      static_cast<float*>(a.proj)[i] = acc;
    }
  }
  if (use_bf16 && a.decomp == 1) {
    // slot-owned: tile (pass p, K chunk kc) holds plane rows 192 p .. +191
    // (row 24 g + c of a pass: gate c / 8 of unit 8 (8 p + g) + c % 8) x K
    // 64 kc .. +63, each row's 16-byte chunks swizzled; then the head's
    // tiles (vocab tile vt: head_rows(Vp, vt) rows from 192 vt, x 64 K)
    // likewise, K chunk after K chunk within a vocab tile
    const int NK = Kp / kRowK, NP = (U + 63) / 64;
    for (size_t i = tid; i < (size_t)NP * NK * kTileElems; i += nth) {
      const int tile = (int)(i / kTileElems), e = (int)(i % kTileElems);
      const int r = e / kRowK, pc = (e % kRowK) >> 3;
      const int k = 64 * (tile % NK) + 8 * (pc ^ (r & 7)) + (e & 7);
      const int g = 8 * (tile / NK) + r / 24, c = r % 24;
      const int col = (c >> 3) * U + 8 * g + (c & 7);
      const float v = (8 * g < U && k < U) ? wdec(a.uc, a.us, k, col, G, wmode) : 0.f;
      static_cast<bf16*>(a.wl)[i] = __float2bfloat16_rn(v);
    }
    for (size_t i = tid; i < (size_t)Vp * Kp; i += nth) {
      const int vt = (int)(i / ((size_t)kHeadRows * Kp)), rows = head_rows(Vp, vt);
      const size_t r = i - (size_t)vt * kHeadRows * Kp;
      const int tile = (int)(r / ((size_t)rows * kRowK)), e = (int)(r % ((size_t)rows * kRowK));
      const int nl = e / kRowK, pc = (e % kRowK) >> 3, k = 64 * tile + 8 * (pc ^ (nl & 7)) + (e & 7);
      const int n = kHeadRows * vt + nl;
      const float v = (n < V && k < U) ? wdec(a.dc, a.ds, k, n, V, wmode) : 0.f;
      static_cast<bf16*>(a.dl)[i] = __float2bfloat16_rn(v);
    }
  } else if (use_bf16) {
    // unit-owned: row (group g, c24) holds gate c24 / 8 of unit 8g + c24 % 8
    for (size_t i = tid; i < (size_t)G * Kp; i += nth) {
      const int row = (int)(i / Kp), k = (int)(i % Kp);
      const int g = row / 24, c = row % 24;
      const int col = (c >> 3) * U + 8 * g + (c & 7);
      const float v = k < U ? wdec(a.uc, a.us, k, col, G, wmode) : 0.f;
      static_cast<bf16*>(a.wl)[i] = __float2bfloat16_rn(v);
    }
    for (size_t i = tid; i < (size_t)Vp * Kp; i += nth) {
      const int n = (int)(i / Kp), k = (int)(i % Kp);
      const float v = (n < V && k < U) ? wdec(a.dc, a.ds, k, n, V, wmode) : 0.f;
      static_cast<bf16*>(a.dl)[i] = __float2bfloat16_rn(v);
    }
  } else {
    // chunk c of f32_vc(V) vocab columns: (U, f32_vc(V)), zeros past V
    const int VC = f32_vc(V), NVC = (V + VC - 1) / VC;
    for (size_t i = tid; i < (size_t)NVC * U * VC; i += nth) {
      const int c = (int)(i / ((size_t)U * VC)), r = (int)(i % ((size_t)U * VC));
      const int k = r / VC, n = c * VC + r % VC;
      static_cast<float*>(a.dl)[i] = n < V ? wdec(a.dc, a.ds, k, n, V, wmode) : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// slot-owned loop (bf16)
// ---------------------------------------------------------------------------

// The slot-owned loop takes 64 slots a block: the M of one warpgroup's
// wgmma. Its weight stream is a ring of tiles of 64 K: per 64-unit pass 192
// plane rows ([group][gate][unit], 24 KB), then the head's Vp rows. The
// setup writes both planes tile by tile, each tile contiguous and already in
// the 128-byte swizzle that wgmma and ldmatrix read (16-byte chunk c of row
// r at chunk c ^ (r % 8)), so one bulk copy (TMA) fills a ring buffer.

// wgmma shared-memory operand: K-major, 128-byte swizzle, 8-row groups 1024
// bytes apart; the K step of 16 moves the start address by 32 bytes
__device__ __forceinline__ uint64_t wg_desc(const void* p) { return desc_k(smem_u32(p)); }

// d (64 x 96, f32, the warpgroup's fragment) += a (64 x 16) . b (16 x 96);
// scale_d == 0 overwrites d instead
__device__ __forceinline__ void wgmma_m64n96(float (&d)[48], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wg_wait_all(float (&d)[48]) {
  wg_wait<0>();
  wg_pin(d);
}
// the logits of a slot-owned block live in the ring buffer its last head
// tile left free when they fit there (one vocab tile of at most 96 rows),
// else in the block's rows of the device scratch Args::lg
__host__ __device__ inline bool slot_lg_in_ring(int V) {
  return (size_t)kSlotS * vp_of(V) * 4 <= (size_t)kTileElems * 2;
}

__host__ __device__ inline size_t slot_smem(int NST, int U) {
  return 1024 + (size_t)kSlotS * kp_of(U) * 2 + (size_t)NST * kTileElems * 2 +
         (size_t)2 * kSlotS * 4 + (size_t)2 * NST * 8;
}

// A slot-owned block is 8 consumer warps (two warpgroups) and one producer
// warp. The producer's lane 0 walks the weight stream: it waits until the
// consumers have released a ring buffer (its `empty` barrier), then copies
// the next tile into it. The consumers sync among themselves (named
// barrier 1).
constexpr int kSlotThreads = kThreads + 32;

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

template <int NST, bool WV>
__global__ void __launch_bounds__(kSlotThreads, 1) slot_loop_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int U = a.U, V = a.V, B = a.B, Kp = kp_of(U), Vp = vp_of(V);
  const int NK = Kp / kRowK, NP = (U + 63) / 64;
  const int NVT = WV ? (Vp + kHeadRows - 1) / kHeadRows : 1;  // V <= kSmemV: one tile
  const int per_step = NP * NK + NVT * NK;
  const bool lg_in_ring = slot_lg_in_ring(V);
  // the swizzle is a function of address bits 7-9: buffers start on 1024 bytes
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* hs = reinterpret_cast<bf16*>(base);                 // Kp/64 blocks of (64, 64)
  bf16* ring = hs + (size_t)kSlotS * Kp;                     // NST x (192, 64)
  int* tok_s = reinterpret_cast<int*>(ring + (size_t)NST * kTileElems);
  int* act_s = tok_s + kSlotS;
  uint64_t* full = reinterpret_cast<uint64_t*>(act_s + kSlotS);
  uint64_t* empty = full + NST;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup; warp within it
  const int gq = lane >> 2, tq = lane & 3;
  const int s0 = blockIdx.x * kSlotS;
  const bf16* wt = static_cast<const bf16*>(a.wl);
  const bf16* dt = static_cast<const bf16*>(a.dl);
  const bf16* proj = static_cast<const bf16*>(a.proj);
  bf16* hb = static_cast<bf16*>(a.hb0);
  float* h = a.h0;

  // the consumers are done with tile it's buffer (one consumer thread,
  // after the consumers' barrier)
  auto release = [&](int it) { mbar_arrive(empty + it % NST); };
  auto wait_tile = [&](int it) -> const bf16* {
    mbar_wait(full + it % NST, (it / NST) & 1);
    return ring + (size_t)(it % NST) * kTileElems;
  };
  // the block's rows of the bf16 state into hs (zeros past B and past U)
  auto load_h = [&]() {
    const int cpr = Kp / 8;
    for (int q = tid; q < kSlotS * cpr; q += kThreads) {
      const int r = q / cpr, c = q % cpr, b = s0 + r, k = c * 8;
      const bool ok = b < B && k < U;
      cp_async16(hs + (size_t)(c >> 3) * kHsBlock + swz(r, c & 7, kRowK),
                 ok ? hb + (size_t)b * U + k : hb, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
  };

  if (tid == 0) {
    for (int q = 0; q < NST; ++q) {
      mbar_init(full + q, 1);
      mbar_init(empty + q, 1);
    }
    mbar_init_fence();
  }
  if (warp < kWarps) load_h();
  __syncthreads();  // the barriers exist before any copy or arrival reaches them

  if (warp == kWarps) {
    // ---- the producer: tile `it` of the weight stream (per step NP passes
    // x NK K-chunks of the plane, 192 rows, then per vocab tile NK K-chunks
    // of the head, up to 192 rows) into ring buffer it % NST
    if (lane == 0) {
      for (int it = 0; it < a.steps * per_step; ++it) {
        const int i = it % per_step, buf = it % NST;
        if (it >= NST) mbar_wait(empty + buf, (it / NST - 1) & 1);
        const bf16* src;
        int bytes;
        if (i < NP * NK) {
          src = wt + (size_t)i * kTileElems;
          bytes = kTileElems * 2;
        } else if constexpr (WV) {
          const int hi = i - NP * NK, vt = hi / NK, rows = head_rows(Vp, vt);
          src = dt + (size_t)vt * kHeadRows * Kp + (size_t)(hi % NK) * rows * kRowK;
          bytes = rows * kRowK * 2;
        } else {  // one vocabulary tile of Vp rows
          src = dt + (size_t)(i - NP * NK) * Vp * kRowK;
          bytes = Vp * kRowK * 2;
        }
        mbar_expect(full + buf, bytes);
        bulk_load(ring + (size_t)buf * kTileElems, src, bytes, full + buf);
      }
    }
  } else {
  int it = 0;  // tiles consumed

  for (int j = 0; j < a.steps; ++j) {
    for (int s = tid; s < kSlotS; s += kThreads) {
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

    // ---- gates: h (64 x K, shared) . plane, a 64-unit pass at a time;
    // warpgroup wg takes unit groups 4 wg .. 4 wg + 3 of the pass, so a
    // lane holds z, r and h of its units 2 tq, 2 tq + 1 in each group
    for (int p = 0; p < NP; ++p) {
      float d[48];
      for (int kc = 0; kc < NK; ++kc) {
        const bf16* t = wait_tile(it);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_m64n96(d, wg_desc(hs + (size_t)kc * kHsBlock + 16 * ks),
                       wg_desc(t + (size_t)wg * 96 * kRowK + 16 * ks), kc > 0 || ks > 0);
        wg_commit();
        wg_wait_all(d);
        consumers_sync();
        if (tid == 0) release(it);
        ++it;
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int u0 = 8 * (8 * p + 4 * wg + g) + 2 * tq;
        if (u0 >= U) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int sl = 16 * wq + gq + 8 * hf, b = s0 + sl;
          if (b >= B) continue;
          const int tk = tok_s[sl], act = act_s[sl];
          const bf16* pr = proj + (size_t)tk * 3 * U + u0;
          const uint32_t px = gxt::lds32(pr), pq = gxt::lds32(pr + U), ph = gxt::lds32(pr + 2 * U);
          const float2 hp = *reinterpret_cast<const float2*>(h + (size_t)b * U + u0);
          const int z = 4 * (3 * g) + 2 * hf, r = z + 4, c = z + 8;
          const float n0 = gru_unit(a.bias, U, u0, bf_lo(px), bf_lo(pq), bf_lo(ph), d[z], d[r],
                                    d[c], hp.x, act);
          const float n1 = gru_unit(a.bias, U, u0 + 1, bf_hi(px), bf_hi(pq), bf_hi(ph),
                                    d[z + 1], d[r + 1], d[c + 1], hp.y, act);
          *reinterpret_cast<float2*>(h + (size_t)b * U + u0) = make_float2(n0, n1);
          *reinterpret_cast<uint32_t*>(hb + (size_t)b * U + u0) = gxt::pack_bf16(n0, n1);
        }
      }
    }

    // ---- h_next into shared memory (every pass has read h)
    consumers_sync();
    load_h();
    consumers_sync();

    // ---- logits on mma.sync: h_next (64 x K) . head (K x Vp), a vocab
    // tile of up to 192 rows at a time; warp w takes n-tiles w + 8 q of it
    float* lg = lg_in_ring ? nullptr : a.lg + (size_t)s0 * Vp;
    for (int vt = 0; vt < NVT; ++vt) {
      const int NTH = head_rows(Vp, vt) / 8;
      float acc[4][3][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int q = 0; q < 3; ++q) acc[mt][q][0] = acc[mt][q][1] = acc[mt][q][2] = acc[mt][q][3] = 0.f;
      for (int kc = 0; kc < NK; ++kc) {
        const bf16* t = wait_tile(it);
#pragma unroll
        for (int k32 = 0; k32 < 2; ++k32) {
          uint32_t bq[3][4];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const int nt = warp + 8 * q;
            if (nt < NTH)
              ldsm_x4(t + swz(8 * nt + (lane & 7), 4 * k32 + (lane >> 3), kRowK), bq[q][0], bq[q][1],
                      bq[q][2], bq[q][3]);
          }
#pragma unroll
          for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              const int r = 16 * mt + (lane & 15);
              uint32_t a0, a1, a2, a3;
              ldsm_x4(hs + (size_t)kc * kHsBlock + swz(r, 4 * k32 + 2 * kh + (lane >> 4), kRowK), a0,
                      a1, a2, a3);
#pragma unroll
              for (int q = 0; q < 3; ++q)
                if (warp + 8 * q < NTH)
                  mma_bf16(acc[mt][q], a0, a1, a2, a3, bq[q][2 * kh], bq[q][2 * kh + 1]);
            }
          }
        }
        consumers_sync();
        // the last head tile's buffer holds the logits until the tokens are
        // chosen; it is handed to the next load after that
        if (kc < NK - 1 || !lg_in_ring) {
          if (tid == 0) release(it);
        } else {
          lg = reinterpret_cast<float*>(ring + (size_t)(it % NST) * kTileElems);
        }
        ++it;
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int nt = warp + 8 * q;
        if (nt >= NTH) continue;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = 16 * mt + gq + 8 * (i >> 1);
            const int col = kHeadRows * vt + 8 * nt + 2 * tq + (i & 1);
            if (col < V && s0 + row < B) lg[row * Vp + col] = acc[mt][q][i] + a.dbias[col];
          }
      }
    }
    consumers_sync();
    for (int s = warp; s < kSlotS; s += kWarps) {
      const int b = s0 + s;
      if (b >= B) continue;  // warp-uniform
      finish_slot<WV>(a, lg + (size_t)s * Vp, j, b, tok_s[s], __ldcg(a.pos + b));
    }
    fence_async_smem();  // the logits' writes come before the next load into their buffer
    consumers_sync();    // lg, tok_s and the cursors are rewritten next step
    if (lg_in_ring && tid == 0) release(it - 1);
  }
  }
}

// ---------------------------------------------------------------------------
// unit-owned loop (cooperative)
// ---------------------------------------------------------------------------

struct Geom {
  int proj_off;  // byte offsets into dynamic shared memory
  int work_off;
  int tok_off;   // f32 phase A's token / active arrays
};

// f32 phase A: this block's units of h_next = gru(h_cur, token), every slot.
// h is staged 32 K rows at a time (float4 loads); the next chunk's loads
// are issued into registers before the current chunk's FMAs, so the L2
// latency hides behind the arithmetic.
template <bool WV>
__device__ void phase_a_f32(const Args& a, const float* u_s, const float* proj_s, float* work,
                            int* tok_s, int* act_s, const float* hc, float* hn, int unit0) {
  constexpr int kQ = kST * kKT / 4 / kThreads;  // float4 per thread per chunk (8)
  constexpr int nc = 24;
  const int U = a.U, B = a.B;
  const int tid = threadIdx.x, uo = tid & (kUG - 1), sg = tid / kUG;
  const int unit = unit0 + uo;
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
        w[0] = pre[q].x;
        w[kHS] = pre[q].y;
        w[2 * kHS] = pre[q].z;
        w[3 * kHS] = pre[q].w;
      }
      __syncthreads();
      if (k0 + kKT < U) fetch(k0 + kKT);
      const float* up = u_s + (size_t)k0 * nc + uo * 3;
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
    if (unit < U) {
#pragma unroll
      for (int i = 0; i < kSPT; ++i) {
        const int s = sg * kSPT + i, b = s0 + s;
        if (b >= B) continue;
        float px, pr, ph;
        if constexpr (!WV) {
          const float* p3 = proj_s + (size_t)tok_s[s] * nc + uo * 3;
          px = p3[0], pr = p3[1], ph = p3[2];
        } else {  // the table's row of the token in device memory
          const float* pt = static_cast<const float*>(a.proj) + (size_t)tok_s[s] * 3 * U + unit;
          px = __ldg(pt), pr = __ldg(pt + U), ph = __ldg(pt + 2 * U);
        }
        hn[(size_t)b * U + unit] =
            gru_unit(a.bias, U, unit, px, pr, ph, acc[i][0], acc[i][1], acc[i][2],
                     __ldcg(hc + (size_t)b * U + unit), act_s[s]);
      }
    }
  }
}

// bf16 phase A on tensor cores: h streams through a cp.async ring of
// (128 slots x 64 K) tiles, slot tile after slot tile; warp w takes 16
// slots of each tile against the block's 24 plane rows kept in shared memory.
// The slot tiles are dealt to the kUnitSplit blocks of the unit group: this
// block takes tiles sp, sp + kUnitSplit, ...
template <bool WV>
__device__ void phase_a_bf16(const Args& a, const bf16* u_bf, const float* proj_s, bf16* ring,
                             const float* hc, float* hn, const bf16* hbc, bf16* hbn, int unit0,
                             int sp) {
  const int U = a.U, B = a.B, Kp = kp_of(U), NK = Kp / kRowK;
  const int nst = (B + kUnitSlots - 1) / kUnitSlots;
  constexpr int NST = kUnitStages, SP = kUnitSplit;
  const int ntiles = (nst - sp + SP - 1) / SP * NK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int u0 = unit0 + 2 * tq;
  auto load = [&](int t) {
    const int st = sp + SP * (t / NK), kc = t % NK;
    bf16* dst = ring + (size_t)(t % NST) * kUnitSlots * kRowK;
    for (int q = tid; q < kUnitSlots * 8; q += kThreads) {
      const int r = q >> 3, c = q & 7, b = st * kUnitSlots + r, k = kc * kRowK + c * 8;
      const bool ok = b < B && k < U;
      cp_async16(dst + swz(r, c, kRowK), ok ? hbc + (size_t)b * U + k : hbc, ok ? 16 : 0);
    }
  };
  for (int q = 0; q < NST - 1; ++q) {
    if (q < ntiles) load(q);
    cp_async_commit();
  }
  float acc[3][4];
#pragma unroll
  for (int nt = 0; nt < 3; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  int tk[2] = {0, 0}, pc[2] = {0, 0};
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // tile t landed for every thread; tile t-1's buffer is free
    if (t + NST - 1 < ntiles) load(t + NST - 1);
    cp_async_commit();
    const bf16* tile = ring + (size_t)(t % NST) * kUnitSlots * kRowK;
    const int kc = t % NK, st = sp + SP * (t / NK);
    if (kc == 0) {
      // the fed tokens of this lane's two slots, asked for a slot tile ahead
      // of the update that needs them
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int b = st * kUnitSlots + 16 * warp + gq + 8 * hf;
        pc[hf] = b < B ? __ldcg(a.pos + b) : 0;
        tk[hf] = b < B ? fed_token(a, b, pc[hf]) : 0;
      }
    }
#pragma unroll
    for (int k32 = 0; k32 < 2; ++k32) {
      uint32_t bq[3][4];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
        ldsm_x4(u_bf + swz(8 * nt + (lane & 7), kc * 8 + 4 * k32 + (lane >> 3), Kp), bq[nt][0],
                bq[nt][1], bq[nt][2], bq[nt][3]);
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int r = 16 * warp + (lane & 15);
        uint32_t a0, a1, a2, a3;
        ldsm_x4(tile + swz(r, 4 * k32 + 2 * kh + (lane >> 4), kRowK), a0, a1, a2, a3);
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
          mma_bf16(acc[nt], a0, a1, a2, a3, bq[nt][2 * kh], bq[nt][2 * kh + 1]);
      }
    }
    if (kc == NK - 1) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int b = st * kUnitSlots + 16 * warp + gq + 8 * hf;
        if (b >= B || u0 >= U) continue;
        const int act = pc[hf] < a.total[b];
        float pr[6];  // z, r, n of unit u0, then of u0 + 1
        if constexpr (!WV) {
#pragma unroll
          for (int q = 0; q < 6; ++q) pr[q] = proj_s[(size_t)tk[hf] * 24 + 6 * tq + q];
        } else {  // the table's row of the token in device memory, two units a load
          const bf16* pt = static_cast<const bf16*>(a.proj) + (size_t)tk[hf] * 3 * U + u0;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(pt + c * U));
            pr[c] = bf_lo(w);
            pr[3 + c] = bf_hi(w);
          }
        }
        const float2 hp = __ldcg(reinterpret_cast<const float2*>(hc + (size_t)b * U + u0));
        const float n0 = gru_unit(a.bias, U, u0, pr[0], pr[1], pr[2], acc[0][2 * hf],
                                  acc[1][2 * hf], acc[2][2 * hf], hp.x, act);
        const float n1 = gru_unit(a.bias, U, u0 + 1, pr[3], pr[4], pr[5], acc[0][2 * hf + 1],
                                  acc[1][2 * hf + 1], acc[2][2 * hf + 1], hp.y, act);
        *reinterpret_cast<float2*>(hn + (size_t)b * U + u0) = make_float2(n0, n1);
        *reinterpret_cast<uint32_t*>(hbn + (size_t)b * U + u0) = gxt::pack_bf16(n0, n1);
      }
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    }
  }
  cp_async_wait<0>();
}

// bf16 logits of the block's slots, 16 at a time: h_next (bf16, L2) . head
// (bf16 [vocab][K], L2) on tensor cores, K split over the warps in 32-wide
// steps (a lane's 16-byte loads of A and B feed two mmas with the same
// permutation of K), the warps' partial sums added in warp order.
template <bool WV>
__device__ void phase_b_bf16(const Args& a, float* work, const bf16* hbn, int j) {
  const int U = a.U, V = a.V, B = a.B, Kp = kp_of(U), Vp = vp_of(V), NTH = Vp / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const bf16* dl = static_cast<const bf16*>(a.dl);
  float* red = work;                                 // (kWarps, 16, 8 kHeadNT)
  const int per = (B + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * per, r1 = min(B, r0 + per);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int m0 = r0; m0 < r1; m0 += 16) {
    // (16, Vp): in shared memory up to kSmemV, else the slots' scratch rows
    float* lg = WV ? a.lg + (size_t)m0 * Vp : work + kWarps * 16 * 8 * kHeadNT;
    const int ra = m0 + gq, rb = ra + 8;
    for (int n0 = 0; n0 < NTH; n0 += kHeadNT) {
      const int nn = min(kHeadNT, NTH - n0);
      float acc[kHeadNT][4];
#pragma unroll
      for (int q = 0; q < kHeadNT; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
      for (int ks = warp; ks < Kp / 32; ks += kWarps) {
        const int k = 32 * ks + 8 * tq;
        const uint4 xa = (ra < r1 && k < U)
                             ? __ldcg(reinterpret_cast<const uint4*>(hbn + (size_t)ra * U + k))
                             : zero;
        const uint4 xb = (rb < r1 && k < U)
                             ? __ldcg(reinterpret_cast<const uint4*>(hbn + (size_t)rb * U + k))
                             : zero;
#pragma unroll
        for (int q = 0; q < kHeadNT; ++q) {
          if (q < nn) {
            const uint4 w =
                __ldg(reinterpret_cast<const uint4*>(dl + (size_t)(8 * (n0 + q) + gq) * Kp + k));
            mma_bf16(acc[q], xa.x, xb.x, xa.y, xb.y, w.x, w.y);
            mma_bf16(acc[q], xa.z, xb.z, xa.w, xb.w, w.z, w.w);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kHeadNT; ++q) {
        if (q < nn) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            red[(warp * 16 + gq + 8 * (i >> 1)) * 8 * kHeadNT + 8 * q + 2 * tq + (i & 1)] =
                acc[q][i];
        }
      }
      __syncthreads();
      for (int i = tid; i < 16 * 8 * nn; i += kThreads) {
        const int row = i / (8 * nn), c = i % (8 * nn), col = 8 * n0 + c;
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += red[(w * 16 + row) * 8 * kHeadNT + c];
        if (col < V && (!WV || m0 + row < r1)) lg[row * Vp + col] = s + a.dbias[col];
      }
      __syncthreads();
    }
    for (int s = warp; s < 16; s += kWarps) {
      const int b = m0 + s;
      if (b >= r1) continue;  // warp-uniform
      const int p = __ldcg(a.pos + b);
      finish_slot<WV>(a, lg + (size_t)s * Vp, j, b, fed_token(a, b, p), p);
    }
    __syncthreads();  // lg and red are rewritten by the next 16 slots
  }
}

// f32 logits of the block's slots, 16 at a time, a head chunk of
// f32_vc(V) vocab columns at a time (one chunk up to V = 256): h_next and
// the chunk's head rows arrive kBK K rows at a time through a two-stage
// cp.async ring (chunk c + 1 lands while chunk c is summed); thread t sums
// slots 4 (t / 64) .. +3 and vocab entries t % 64 + 64 q of the chunk over
// K in order (one FMA chain each, as the plain product's terms).
template <bool WV>
__device__ void phase_b_f32(const Args& a, float* work, const float* hn, int j) {
  const int U = a.U, V = a.V, B = a.B, Vp = vp_of(V), NC = U / kBK;
  // f32_vc(V): V <= kSmemV is one chunk of V columns
  const int VC = WV ? f32_vc(V) : V, NVC = WV ? (V + VC - 1) / VC : 1;
  const int tid = threadIdx.x, warp = tid >> 5;
  const float* dl = static_cast<const float*>(a.dl);
  float* hst = work;                           // 2 x (16, kBK)
  float* dst = work + 2 * 16 * kBK;            // 2 x (kBK, VC)
  const int per = (B + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * per, r1 = min(B, r0 + per);
  const int sq = 4 * (tid >> 6), vl = tid & 63;
  for (int m0 = r0; m0 < r1; m0 += 16) {
    // (16, Vp): in shared memory up to kSmemV, else the slots' scratch rows
    float* lg = WV ? a.lg + (size_t)m0 * Vp : dst + (size_t)2 * kBK * VC;
    for (int vc = 0; vc < NVC; ++vc) {
      auto load = [&](int c) {
        float* hb = hst + (c & 1) * 16 * kBK;
        float* db = dst + (size_t)(c & 1) * kBK * VC;
        const int k0 = c * kBK;
        for (int i = tid; i < 16 * kBK / 4; i += kThreads) {
          const int s = i / (kBK / 4), q = i % (kBK / 4), b = m0 + s;
          const bool ok = b < r1;
          cp_async16(hb + s * kBK + 4 * q, ok ? hn + (size_t)b * U + k0 + 4 * q : hn, ok ? 16 : 0);
        }
        // kBK whole rows of the chunk: contiguous
        const float* src = dl + ((size_t)vc * U + k0) * VC;
        for (int i = tid; i < kBK * VC / 4; i += kThreads) cp_async16(db + 4 * i, src + 4 * i, 16);
        cp_async_commit();
      };
      float acc[4][kVC / 64];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < kVC / 64; ++q) acc[i][q] = 0.f;
      load(0);
      for (int c = 0; c < NC; ++c) {
        // chunk c + 1 goes to the buffer chunk c - 1 left, free since the
        // barrier that closed the previous pass
        if (c + 1 < NC) {
          load(c + 1);
        } else {
          cp_async_commit();
        }
        cp_async_wait<1>();
        __syncthreads();  // chunk c landed for every thread
        const float* hb = hst + (c & 1) * 16 * kBK;
        const float* db = dst + (size_t)(c & 1) * kBK * VC;
#pragma unroll 8
        for (int kk = 0; kk < kBK; ++kk) {
          float hv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) hv[i] = hb[(sq + i) * kBK + kk];
#pragma unroll
          for (int q = 0; q < kVC / 64; ++q) {
            const int v = vl + 64 * q;
            if (v < VC) {
              const float d = db[kk * VC + v];
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[i][q] = fmaf(hv[i], d, acc[i][q]);
            }
          }
        }
        __syncthreads();  // chunk c's buffer is free
      }
#pragma unroll
      for (int q = 0; q < kVC / 64; ++q) {
        const int v = vl + 64 * q, col = vc * VC + v;
        if (v < VC && col < V) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (!WV || m0 + sq + i < r1) lg[(sq + i) * Vp + col] = acc[i][q] + a.dbias[col];
        }
      }
    }
    __syncthreads();
    for (int s = warp; s < 16; s += kWarps) {
      const int b = m0 + s;
      if (b >= r1) continue;  // warp-uniform
      const int p = __ldcg(a.pos + b);
      finish_slot<WV>(a, lg + (size_t)s * Vp, j, b, fed_token(a, b, p), p);
    }
    __syncthreads();  // lg is rewritten by the next 16 slots
  }
}

// the work area of phase A (the bf16 h ring; the f32 h stage) and phase B
// (the bf16 warps' partial sums; the f32 ring of h and head rows), which
// the logits of 16 slots join up to kSmemV
__host__ __device__ inline size_t unit_work_bytes(int V, int use_bf16) {
  const size_t lg = unit_small(V) ? (size_t)16 * vp_of(V) : 0;
  if (use_bf16) {
    const size_t ring = (size_t)kUnitStages * kUnitSlots * kRowK * 2;
    const size_t b = ((size_t)kWarps * 16 * 8 * kHeadNT + lg) * 4;
    return ring > b ? ring : b;
  }
  const size_t pa = (size_t)kKT * kHS * 4;
  const size_t b = ((size_t)2 * 16 * kBK + (size_t)2 * kBK * f32_vc(V) + lg) * 4;
  return pa > b ? pa : b;
}

__host__ __device__ inline Geom unit_geom(int U, int V, int use_bf16) {
  Geom g;
  const size_t w = use_bf16 ? (size_t)24 * kp_of(U) * 2 : (size_t)U * 24 * 4;
  g.proj_off = (int)align16(w);
  // the block's slice of the table (V x 24 f32) up to kSmemV; past it the
  // updates read the table's rows in device memory
  g.work_off = (int)align16(g.proj_off + (unit_small(V) ? (size_t)V * 24 * 4 : 0));
  g.tok_off = (int)align16(g.work_off + unit_work_bytes(V, use_bf16));
  return g;
}

__host__ __device__ inline size_t unit_smem(int U, int V, int use_bf16) {
  return (size_t)unit_geom(U, V, use_bf16).tok_off + (use_bf16 ? 0 : (size_t)2 * kST * 4);
}

// At bf16 kUnitSplit blocks share each unit group (two blocks on a
// multiprocessor take in h nearly twice as fast as one); at f32 one block
// owns it
template <bool BF, bool WV>
__global__ void __launch_bounds__(kThreads, BF ? kUnitSplit : 1) unit_loop_kernel(Args a, Geom g) {
  constexpr int SP = BF ? kUnitSplit : 1;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int U = a.U, G = 3 * U, V = a.V, Kp = kp_of(U);
  const int wmode = a.wmode;
  constexpr int nc = 24;
  float* proj_s = reinterpret_cast<float*>(smem_raw + g.proj_off);  // (V, nc) [v][3 ul + gate]
  unsigned char* work = smem_raw + g.work_off;
  const int tid = threadIdx.x;
  const int unit0 = blockIdx.x / SP * 8, sp = blockIdx.x % SP;

  // ---- the block's plane columns and table entries into shared memory
  if constexpr (BF) {
    bf16* u_bf = reinterpret_cast<bf16*>(smem_raw);  // (nc, Kp) swizzled
    const bf16* src = static_cast<const bf16*>(a.wl) + (size_t)(blockIdx.x / SP) * nc * Kp;
    for (int q = tid; q < nc * (Kp / 8); q += kThreads) {
      const int r = q / (Kp / 8), c = q % (Kp / 8);
      cp_async16(u_bf + swz(r, c, Kp), src + (size_t)r * Kp + 8 * c, 16);
    }
    cp_async_commit();
    const bf16* pt = static_cast<const bf16*>(a.proj);
    for (int i = tid; i < (WV ? 0 : V * nc); i += kThreads) {
      const int v = i / nc, c = i % nc, unit = unit0 + c / 3;
      proj_s[i] = unit < U ? __bfloat162float(pt[(size_t)v * G + (c % 3) * U + unit]) : 0.f;
    }
    cp_async_wait<0>();
  } else {
    float* u_s = reinterpret_cast<float*>(smem_raw);  // (U, 24) [k][3 ul + gate]
    for (int i = tid; i < U * 24; i += kThreads) {
      const int k = i / 24, c = i % 24, unit = unit0 + c / 3;
      u_s[i] = unit < U ? wdec(a.uc, a.us, k, (c % 3) * U + unit, G, wmode) : 0.f;
    }
    const float* pt = static_cast<const float*>(a.proj);
    for (int i = tid; i < (WV ? 0 : V * 24); i += kThreads) {
      const int v = i / 24, c = i % 24, unit = unit0 + c / 3;
      proj_s[i] = unit < U ? pt[(size_t)v * G + (c % 3) * U + unit] : 0.f;
    }
  }
  __syncthreads();

  for (int j = 0; j < a.steps; ++j) {
    const float* hc = (j & 1) ? a.h1 : a.h0;
    float* hn = (j & 1) ? a.h0 : a.h1;
    if constexpr (BF) {
      const bf16* hbc = static_cast<const bf16*>((j & 1) ? a.hb1 : a.hb0);
      bf16* hbn = static_cast<bf16*>((j & 1) ? a.hb0 : a.hb1);
      phase_a_bf16<WV>(a, reinterpret_cast<const bf16*>(smem_raw), proj_s,
                   reinterpret_cast<bf16*>(work), hc, hn, hbc, hbn, unit0, sp);
      grid.sync();
      phase_b_bf16<WV>(a, reinterpret_cast<float*>(work), hbn, j);
    } else {
      int* tok_s = reinterpret_cast<int*>(smem_raw + g.tok_off);
      phase_a_f32<WV>(a, reinterpret_cast<const float*>(smem_raw), proj_s,
                  reinterpret_cast<float*>(work), tok_s, tok_s + kST, hc, hn, unit0);
      grid.sync();
      phase_b_f32<WV>(a, reinterpret_cast<float*>(work), hn, j);
    }
    grid.sync();
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// dynamic shared memory of the loop kernel the Args' plan launches
size_t plan_smem(const Args& a) {
  if (a.decomp == 1) return slot_smem(a.stages, a.U);
  return unit_smem(a.U, a.V, a.bf16);
}

template <int NST, bool WV>
cudaError_t launch_slot(const Args& a, size_t smem, cudaStream_t stream) {
  auto k = slot_loop_kernel<NST, WV>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  slot_loop_kernel<NST, WV><<<(a.B + kSlotS - 1) / kSlotS, kSlotThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool BF, bool WV>
cudaError_t launch_unit(const Args& a, size_t smem, int sms, cudaStream_t stream) {
  constexpr int SP = BF ? kUnitSplit : 1;
  auto k = unit_loop_kernel<BF, WV>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int grid = SP * a.U / 8;
  // every block must be resident at once, or a grid sync never returns
  if (per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  Args ka = a;
  Geom g = unit_geom(a.U, a.V, a.bf16);
  void* kargs[] = {&ka, &g};
  err = cudaLaunchCooperativeKernel((void*)k, grid, kThreads, kargs, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int launch(const Args& a, void* stream_p) {
  if (a.B <= 0 || a.steps <= 0) return 0;
  const bool slot = a.decomp == 1;
  // whole 32-row blocks of K: U % 32 == 0 (the wrapper pads U to it); the
  // logits scratch wherever they leave shared memory
  const bool need_lg = slot ? !slot_lg_in_ring(a.V) : !unit_small(a.V);
  if (a.V <= 0 || a.U <= 0 || a.U % 32 || a.E <= 0 || (need_lg && a.lg == nullptr) ||
      (a.bf16 && (a.hb0 == nullptr || a.hb1 == nullptr || a.wl == nullptr)) ||
      a.proj == nullptr || a.dl == nullptr || a.wmode < 0 || a.wmode > 2 ||
      a.wc == nullptr || a.uc == nullptr || a.dc == nullptr ||
      (a.wmode != 2 && (a.ws == nullptr || a.us == nullptr || a.ds == nullptr)) ||
      a.decomp < 0 || a.decomp > 1 || (slot && !a.bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_p;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = plan_smem(a);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;

  Args ka = a;
  void* kargs[] = {&ka};
  err = cudaLaunchKernel((void*)setup_kernel, 4 * sms, kThreads, kargs, 0, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const bool wv = !unit_small(a.V);
  if (slot) {
    switch (a.stages * 2 + wv) {
      case 6: err = launch_slot<3, false>(a, smem, stream); break;
      case 7: err = launch_slot<3, true>(a, smem, stream); break;
      case 8: err = launch_slot<4, false>(a, smem, stream); break;
      case 9: err = launch_slot<4, true>(a, smem, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (a.stages != 0) {
    return (int)cudaErrorInvalidValue;
  } else if (a.bf16) {
    err = wv ? launch_unit<true, true>(a, smem, sms, stream)
             : launch_unit<true, false>(a, smem, sms, stream);
  } else {
    err = wv ? launch_unit<false, true>(a, smem, sms, stream)
             : launch_unit<false, false>(a, smem, sms, stream);
  }
  return (int)err;
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

// bytes of dynamic shared memory the loop kernel of this plan takes: the
// wrapper holds its own reckoning (decode_plan) against it
extern "C" int gxt_plan_smem(const Args* a) { return (int)plan_smem(*a); }

extern "C" const char* gxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
