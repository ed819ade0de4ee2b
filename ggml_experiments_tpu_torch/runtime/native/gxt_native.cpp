// gxt_native: the host runtime of ggml_experiments_tpu_torch.
//
// The host-side jobs around the card's kernels, in C++ with a flat C ABI
// loaded through ctypes (runtime/__init__.py builds it with g++ at first
// use):
//
//   * Q8_0 / Q4_0 / Q4_1 / Q5_0 / Q5_1 block quantize and dequantize (and
//     the q4_k decode), bit-equal to quant/qtensor.py's numpy codecs on the
//     (Kp, N) planes they return: codes (K, N) column layout, block-local
//     nibble packing, the fifth bit in its own plane;
//   * streaming indexers of the reference's two binary weight formats
//     (positional gru.bin and named weight.ggml), whose payloads the caller
//     then reads in bulk;
//   * the reference's bilinear u8 resample and the PNG scanline unfilter.
//
// The port quantizes on the device; these codecs are the module's API, not
// its quantize path. Every entry point has a numpy plain version in the
// package that the tests hold it to.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

#define GXT_OK 0
#define GXT_ERR_IO 1
#define GXT_ERR_FORMAT 2
#define GXT_ERR_ARG 3

// ---------------------------------------------------------------------------
// Block quantization (BLOCK = 32 along K)
// ---------------------------------------------------------------------------

// Quantize w[K, N] (row-major f32) into codes[Kp, N] int8 + scales[Kp/32, N]
// f32, where Kp = ceil(K/32)*32 and rows K..Kp are zero blocks. The caller
// allocates codes/scales at the padded size. As quant/qtensor.py: block b
// of column n covers rows [32b, 32b+32).
int q8_0_quantize(const float* w, int64_t k, int64_t n,
                  int8_t* codes, float* scales) {
    if (!w || !codes || !scales || k <= 0 || n <= 0) return GXT_ERR_ARG;
    const int64_t kp = (k + 31) / 32 * 32;
    const int64_t nb = kp / 32;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t b = 0; b < nb; b++) {
        for (int64_t j = 0; j < n; j++) {
            const int64_t k0 = b * 32;
            float amax = 0.0f;
            for (int64_t i = k0; i < k0 + 32; i++) {
                const float v = i < k ? w[i * n + j] : 0.0f;
                const float a = fabsf(v);
                if (a > amax) amax = a;
            }
            const float d = amax / 127.0f;
            const float inv = d > 0.0f ? 1.0f / d : 0.0f;
            scales[b * n + j] = d;
            for (int64_t i = k0; i < k0 + 32; i++) {
                const float v = i < k ? w[i * n + j] : 0.0f;
                float q = rintf(v * inv);
                if (q > 127.0f) q = 127.0f;
                if (q < -127.0f) q = -127.0f;
                codes[i * n + j] = (int8_t)q;
            }
        }
    }
    return GXT_OK;
}

// Q4_0 with ggml's signed-max trick (d = m/-8, m = value of largest |w|) and
// the kernels' block-local nibble packing: packed byte i of block b holds
// unpacked rows (32b+i, 32b+16+i) as (low, high) nibbles.
// codes is uint8[Kp/2, N]; scales f32[Kp/32, N].
int q4_0_quantize(const float* w, int64_t k, int64_t n,
                  uint8_t* codes, float* scales) {
    if (!w || !codes || !scales || k <= 0 || n <= 0) return GXT_ERR_ARG;
    const int64_t kp = (k + 31) / 32 * 32;
    const int64_t nb = kp / 32;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t b = 0; b < nb; b++) {
        for (int64_t j = 0; j < n; j++) {
            const int64_t k0 = b * 32;
            float m = 0.0f, amax = 0.0f;
            for (int64_t i = k0; i < k0 + 32; i++) {
                const float v = i < k ? w[i * n + j] : 0.0f;
                const float a = fabsf(v);
                if (a > amax) { amax = a; m = v; }
            }
            const float d = m / -8.0f;
            const float inv = d != 0.0f ? 1.0f / d : 0.0f;
            scales[b * n + j] = d;
            uint8_t q[32];
            for (int64_t i = 0; i < 32; i++) {
                const int64_t src = k0 + i;
                const float v = src < k ? w[src * n + j] : 0.0f;
                float qq = rintf(v * inv) + 8.0f;
                if (qq > 15.0f) qq = 15.0f;
                if (qq < 0.0f) qq = 0.0f;
                q[i] = (uint8_t)qq;
            }
            for (int64_t i = 0; i < 16; i++) {
                codes[(b * 16 + i) * n + j] = (uint8_t)(q[i] | (q[i + 16] << 4));
            }
        }
    }
    return GXT_OK;
}

// Q4_1 (asymmetric): m = block min, d = (max-min)/15, q = rint((v-m)/d) in
// [0,15], v ≈ q*d + m. Same nibble packing as Q4_0; extra mins f32[Kp/32, N].
int q4_1_quantize(const float* w, int64_t k, int64_t n,
                  uint8_t* codes, float* scales, float* mins) {
    if (!w || !codes || !scales || !mins || k <= 0 || n <= 0) return GXT_ERR_ARG;
    const int64_t kp = (k + 31) / 32 * 32;
    const int64_t nb = kp / 32;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t b = 0; b < nb; b++) {
        for (int64_t j = 0; j < n; j++) {
            const int64_t k0 = b * 32;
            float mn = 0.0f, mx = 0.0f;
            for (int64_t i = k0; i < k0 + 32; i++) {
                const float v = i < k ? w[i * n + j] : 0.0f;
                if (i == k0) { mn = v; mx = v; }
                if (v < mn) mn = v;
                if (v > mx) mx = v;
            }
            const float d = (mx - mn) / 15.0f;
            const float inv = d > 0.0f ? 1.0f / d : 0.0f;
            scales[b * n + j] = d;
            mins[b * n + j] = mn;
            uint8_t q[32];
            for (int64_t i = 0; i < 32; i++) {
                const int64_t src = k0 + i;
                const float v = src < k ? w[src * n + j] : 0.0f;
                float qq = rintf((v - mn) * inv);
                if (qq > 15.0f) qq = 15.0f;
                if (qq < 0.0f) qq = 0.0f;
                q[i] = (uint8_t)qq;
            }
            for (int64_t i = 0; i < 16; i++) {
                codes[(b * 16 + i) * n + j] = (uint8_t)(q[i] | (q[i + 16] << 4));
            }
        }
    }
    return GXT_OK;
}

// Shared 5-bit emit: pack low nibbles block-locally like Q4, and the 5th bit
// into a bit-plane uint8[Kp/8, N] where block-local row t -> byte t%4, bit
// t/4 (quant/qtensor.py _pack_hibits). Rows past K of the last block are
// zeros, so Q5_0 writes q = 16 there: a 1 in the fifth-bit plane, as the
// numpy codec does.
static void emit_q5(const uint8_t* q, int64_t b, int64_t j, int64_t n,
                    uint8_t* codes, uint8_t* hibits) {
    uint8_t lo[32], hb[4] = {0, 0, 0, 0};
    for (int64_t t = 0; t < 32; t++) {
        lo[t] = q[t] & 0xF;
        hb[t % 4] |= (uint8_t)((q[t] >> 4) << (t / 4));
    }
    for (int64_t i = 0; i < 16; i++) {
        codes[(b * 16 + i) * n + j] = (uint8_t)(lo[i] | (lo[i + 16] << 4));
    }
    for (int64_t r = 0; r < 4; r++) hibits[(b * 4 + r) * n + j] = hb[r];
}

// Q5_0: ggml's signed-max trick at 5 bits (d = m/-16, q = rint(v/d)+16).
int q5_0_quantize(const float* w, int64_t k, int64_t n,
                  uint8_t* codes, uint8_t* hibits, float* scales) {
    if (!w || !codes || !hibits || !scales || k <= 0 || n <= 0) return GXT_ERR_ARG;
    const int64_t kp = (k + 31) / 32 * 32;
    const int64_t nb = kp / 32;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t b = 0; b < nb; b++) {
        for (int64_t j = 0; j < n; j++) {
            const int64_t k0 = b * 32;
            float m = 0.0f, amax = 0.0f;
            for (int64_t i = k0; i < k0 + 32; i++) {
                const float v = i < k ? w[i * n + j] : 0.0f;
                const float a = fabsf(v);
                if (a > amax) { amax = a; m = v; }
            }
            const float d = m / -16.0f;
            const float inv = d != 0.0f ? 1.0f / d : 0.0f;
            scales[b * n + j] = d;
            uint8_t q[32];
            for (int64_t i = 0; i < 32; i++) {
                const int64_t src = k0 + i;
                const float v = src < k ? w[src * n + j] : 0.0f;
                float qq = rintf(v * inv) + 16.0f;
                if (qq > 31.0f) qq = 31.0f;
                if (qq < 0.0f) qq = 0.0f;
                q[i] = (uint8_t)qq;
            }
            emit_q5(q, b, j, n, codes, hibits);
        }
    }
    return GXT_OK;
}

// Q5_1: asymmetric 5-bit (m = min, d = (max-min)/31, v ≈ q*d + m).
int q5_1_quantize(const float* w, int64_t k, int64_t n,
                  uint8_t* codes, uint8_t* hibits, float* scales, float* mins) {
    if (!w || !codes || !hibits || !scales || !mins || k <= 0 || n <= 0) return GXT_ERR_ARG;
    const int64_t kp = (k + 31) / 32 * 32;
    const int64_t nb = kp / 32;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t b = 0; b < nb; b++) {
        for (int64_t j = 0; j < n; j++) {
            const int64_t k0 = b * 32;
            float mn = 0.0f, mx = 0.0f;
            for (int64_t i = k0; i < k0 + 32; i++) {
                const float v = i < k ? w[i * n + j] : 0.0f;
                if (i == k0) { mn = v; mx = v; }
                if (v < mn) mn = v;
                if (v > mx) mx = v;
            }
            const float d = (mx - mn) / 31.0f;
            const float inv = d > 0.0f ? 1.0f / d : 0.0f;
            scales[b * n + j] = d;
            mins[b * n + j] = mn;
            uint8_t q[32];
            for (int64_t i = 0; i < 32; i++) {
                const int64_t src = k0 + i;
                const float v = src < k ? w[src * n + j] : 0.0f;
                float qq = rintf((v - mn) * inv);
                if (qq > 31.0f) qq = 31.0f;
                if (qq < 0.0f) qq = 0.0f;
                q[i] = (uint8_t)qq;
            }
            emit_q5(q, b, j, n, codes, hibits);
        }
    }
    return GXT_OK;
}

int q8_0_dequantize(const int8_t* codes, const float* scales,
                    int64_t kp, int64_t n, float* out) {
    if (!codes || !scales || !out || kp <= 0 || n <= 0 || kp % 32) return GXT_ERR_ARG;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < kp; i++) {
        const float* srow = scales + (i / 32) * n;
        const int8_t* crow = codes + i * n;
        float* orow = out + i * n;
        for (int64_t j = 0; j < n; j++) orow[j] = (float)crow[j] * srow[j];
    }
    return GXT_OK;
}

int q4_0_dequantize(const uint8_t* codes, const float* scales,
                    int64_t kp, int64_t n, float* out) {
    if (!codes || !scales || !out || kp <= 0 || n <= 0 || kp % 32) return GXT_ERR_ARG;
    const int64_t nb = kp / 32;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nb; b++) {
        const float* srow = scales + b * n;
        for (int64_t i = 0; i < 16; i++) {
            const uint8_t* crow = codes + (b * 16 + i) * n;
            float* lo = out + (b * 32 + i) * n;
            float* hi = out + (b * 32 + 16 + i) * n;
            for (int64_t j = 0; j < n; j++) {
                lo[j] = (float)((int)(crow[j] & 0xF) - 8) * srow[j];
                hi[j] = (float)((int)(crow[j] >> 4) - 8) * srow[j];
            }
        }
    }
    return GXT_OK;
}

int q4_1_dequantize(const uint8_t* codes, const float* scales, const float* mins,
                    int64_t kp, int64_t n, float* out) {
    if (!codes || !scales || !mins || !out || kp <= 0 || n <= 0 || kp % 32) return GXT_ERR_ARG;
    const int64_t nb = kp / 32;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nb; b++) {
        const float* srow = scales + b * n;
        const float* mrow = mins + b * n;
        for (int64_t i = 0; i < 16; i++) {
            const uint8_t* crow = codes + (b * 16 + i) * n;
            float* lo = out + (b * 32 + i) * n;
            float* hi = out + (b * 32 + 16 + i) * n;
            for (int64_t j = 0; j < n; j++) {
                lo[j] = (float)(crow[j] & 0xF) * srow[j] + mrow[j];
                hi[j] = (float)(crow[j] >> 4) * srow[j] + mrow[j];
            }
        }
    }
    return GXT_OK;
}

// Shared q5 decode of block-local row t (0..31) for one column.
static inline int q5_value(const uint8_t* codes, const uint8_t* hibits,
                           int64_t b, int64_t t, int64_t j, int64_t n) {
    const uint8_t byte = codes[(b * 16 + (t % 16)) * n + j];
    const int lo = (t < 16) ? (byte & 0xF) : (byte >> 4);
    const int hb = (hibits[(b * 4 + (t % 4)) * n + j] >> (t / 4)) & 1;
    return lo | (hb << 4);
}

int q5_0_dequantize(const uint8_t* codes, const uint8_t* hibits, const float* scales,
                    int64_t kp, int64_t n, float* out) {
    if (!codes || !hibits || !scales || !out || kp <= 0 || n <= 0 || kp % 32) return GXT_ERR_ARG;
    const int64_t nb = kp / 32;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nb; b++) {
        const float* srow = scales + b * n;
        for (int64_t t = 0; t < 32; t++) {
            float* orow = out + (b * 32 + t) * n;
            for (int64_t j = 0; j < n; j++) {
                orow[j] = (float)(q5_value(codes, hibits, b, t, j, n) - 16) * srow[j];
            }
        }
    }
    return GXT_OK;
}

int q5_1_dequantize(const uint8_t* codes, const uint8_t* hibits,
                    const float* scales, const float* mins,
                    int64_t kp, int64_t n, float* out) {
    if (!codes || !hibits || !scales || !mins || !out || kp <= 0 || n <= 0 || kp % 32)
        return GXT_ERR_ARG;
    const int64_t nb = kp / 32;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nb; b++) {
        const float* srow = scales + b * n;
        const float* mrow = mins + b * n;
        for (int64_t t = 0; t < 32; t++) {
            float* orow = out + (b * 32 + t) * n;
            for (int64_t j = 0; j < n; j++) {
                orow[j] = (float)q5_value(codes, hibits, b, t, j, n) * srow[j] + mrow[j];
            }
        }
    }
    return GXT_OK;
}

// ---------------------------------------------------------------------------
// Reference binary formats (streaming index — data is then bulk-read by the
// caller straight into numpy buffers; no per-element marshalling)
// ---------------------------------------------------------------------------

// Scan a named weight.ggml file. For each
// record, appends into caller-provided arrays (cap entries):
//   name_buf     : concatenated names, NUL-separated (cap_names bytes)
//   n_dims[i], dims[i*4..], data_offset[i] (byte offset of f32 payload)
// Returns number of tensors, or -errcode.
int64_t ggml_named_index(const char* path,
                         char* name_buf, int64_t cap_names,
                         int32_t* n_dims, int32_t* dims, int64_t* data_offset,
                         int64_t cap_entries) {
    FILE* f = fopen(path, "rb");
    if (!f) return -GXT_ERR_IO;
    fseeko(f, 0, SEEK_END);
    const int64_t fsize = (int64_t)ftello(f);
    fseeko(f, 0, SEEK_SET);
    int64_t count = 0, name_used = 0;
    for (;;) {
        const int64_t rec_start = (int64_t)ftello(f);
        int32_t name_len;
        size_t r = fread(&name_len, sizeof(int32_t), 1, f);
        if (r != 1) {
            // clean EOF only if the record boundary IS the file end; a
            // partial trailing header is truncation, not EOF (the python
            // reader errors here too — parity)
            if (rec_start != fsize) { fclose(f); return -GXT_ERR_FORMAT; }
            break;
        }
        if (name_len <= 0 || name_len >= 4096 || count >= cap_entries ||
            name_used + name_len + 1 > cap_names) { fclose(f); return -GXT_ERR_FORMAT; }
        if (fread(name_buf + name_used, 1, (size_t)name_len, f) != (size_t)name_len) {
            fclose(f); return -GXT_ERR_FORMAT;
        }
        name_used += name_len;
        name_buf[name_used++] = '\0';
        int32_t nd;
        if (fread(&nd, sizeof(int32_t), 1, f) != 1 || nd <= 0 || nd > 4) {
            fclose(f); return -GXT_ERR_FORMAT;
        }
        n_dims[count] = nd;
        int64_t numel = 1;
        for (int i = 0; i < 4; i++) dims[count * 4 + i] = 1;
        for (int i = 0; i < nd; i++) {
            int32_t d;
            if (fread(&d, sizeof(int32_t), 1, f) != 1 || d <= 0) {
                fclose(f); return -GXT_ERR_FORMAT;
            }
            // overflow-safe: no payload can exceed the file, so cap the
            // running product BEFORE multiplying (numel*d could wrap int64
            // on hostile dims, which is UB and would skip the bound check)
            if (numel > (fsize / (int64_t)sizeof(float)) / d) {
                fclose(f); return -GXT_ERR_FORMAT;
            }
            dims[count * 4 + i] = d;
            numel *= d;
        }
        data_offset[count] = (int64_t)ftello(f);
        // fseek past EOF succeeds on regular files — bound-check the
        // payload against the real file size instead
        if (data_offset[count] + numel * (int64_t)sizeof(float) > fsize ||
            fseeko(f, numel * (int64_t)sizeof(float), SEEK_CUR) != 0) {
            fclose(f); return -GXT_ERR_FORMAT;
        }
        count++;
    }
    fclose(f);
    return count;
}

// Scan a positional gru.bin file:
// per tensor int32 n_dims, reversed dims, f32 payload. Same output contract
// as ggml_named_index minus names.
int64_t gru_bin_index(const char* path,
                      int32_t* n_dims, int32_t* dims, int64_t* data_offset,
                      int64_t cap_entries) {
    FILE* f = fopen(path, "rb");
    if (!f) return -GXT_ERR_IO;
    fseeko(f, 0, SEEK_END);
    const int64_t fsize = (int64_t)ftello(f);
    fseeko(f, 0, SEEK_SET);
    int64_t count = 0;
    for (;;) {
        const int64_t rec_start = (int64_t)ftello(f);
        int32_t nd;
        size_t r = fread(&nd, sizeof(int32_t), 1, f);
        if (r != 1) {
            if (rec_start != fsize) { fclose(f); return -GXT_ERR_FORMAT; }
            break;
        }
        if (nd <= 0 || nd > 4 || count >= cap_entries) { fclose(f); return -GXT_ERR_FORMAT; }
        n_dims[count] = nd;
        int64_t numel = 1;
        for (int i = 0; i < 4; i++) dims[count * 4 + i] = 1;
        for (int i = 0; i < nd; i++) {
            int32_t d;
            if (fread(&d, sizeof(int32_t), 1, f) != 1 || d <= 0) {
                fclose(f); return -GXT_ERR_FORMAT;
            }
            if (numel > (fsize / (int64_t)sizeof(float)) / d) {
                fclose(f); return -GXT_ERR_FORMAT;  // overflow-safe cap (see above)
            }
            // file stores dims reversed; emit numpy (row-major) order
            dims[count * 4 + (nd - 1 - i)] = d;
            numel *= d;
        }
        data_offset[count] = (int64_t)ftello(f);
        if (data_offset[count] + numel * (int64_t)sizeof(float) > fsize ||
            fseeko(f, numel * (int64_t)sizeof(float), SEEK_CUR) != 0) {
            fclose(f); return -GXT_ERR_FORMAT;
        }
        count++;
    }
    fclose(f);
    return count;
}

// ---------------------------------------------------------------------------
// Image preprocessing (the reference's bilinear resample)
// ---------------------------------------------------------------------------

// Reference-exact bilinear resample of a u8 HWC image: sample at
// (x+0.5)*scale-0.5 with edge clamp, round back to u8: utils/image.py's
// numpy version, up to exact .5 ties of the f32 arithmetic.
int bilinear_resize_u8(const uint8_t* img, int64_t h, int64_t w, int64_t c,
                       int64_t out_h, int64_t out_w, float scale, uint8_t* out) {
    if (!img || !out || h <= 0 || w <= 0 || c <= 0) return GXT_ERR_ARG;
#pragma omp parallel for schedule(static)
    for (int64_t y = 0; y < out_h; y++) {
        const float sy = (y + 0.5f) * scale - 0.5f;
        int64_t y0 = (int64_t)floorf(sy);
        if (y0 < 0) y0 = 0;
        if (y0 > h - 1) y0 = h - 1;  // defensive: the reference's C++ would read OOB
        int64_t y1 = y0 + 1 < h ? y0 + 1 : h - 1;
        const float dy = sy - (float)y0;  // may be negative at the top edge: the
                                          // reference extrapolates there
        for (int64_t x = 0; x < out_w; x++) {
            const float sx = (x + 0.5f) * scale - 0.5f;
            int64_t x0 = (int64_t)floorf(sx);
            if (x0 < 0) x0 = 0;
            if (x0 > w - 1) x0 = w - 1;
            int64_t x1 = x0 + 1 < w ? x0 + 1 : w - 1;
            const float dx = sx - (float)x0;
            for (int64_t ch = 0; ch < c; ch++) {
                const float v00 = img[(y0 * w + x0) * c + ch];
                const float v01 = img[(y0 * w + x1) * c + ch];
                const float v10 = img[(y1 * w + x0) * c + ch];
                const float v11 = img[(y1 * w + x1) * c + ch];
                const float v0 = v00 * (1.0f - dx) + v01 * dx;
                const float v1 = v10 * (1.0f - dx) + v11 * dx;
                float v = roundf(v0 * (1.0f - dy) + v1 * dy);
                if (v < 0.0f) v = 0.0f;
                if (v > 255.0f) v = 255.0f;
                out[(y * out_w + x) * c + ch] = (uint8_t)v;
            }
        }
    }
    return GXT_OK;
}

// ---------------------------------------------------------------------------
// PNG scanline unfilter (the hot loop of utils/image_codecs.decode_png:
// Sub/Avg/Paeth carry a per-pixel dependency that is slow in Python)
// ---------------------------------------------------------------------------

// raw: h rows of `stride` filtered bytes (filter bytes already stripped),
// filters: h filter-type bytes, out: h*stride reconstructed bytes.
int png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int64_t bpp,
                 const uint8_t* filters, uint8_t* out) {
    if (!raw || !filters || !out || h <= 0 || stride <= 0 || bpp <= 0)
        return GXT_ERR_ARG;
    for (int64_t y = 0; y < h; y++) {
        const uint8_t* r = raw + y * stride;
        const uint8_t* up = y ? out + (y - 1) * stride : nullptr;
        uint8_t* o = out + y * stride;
        switch (filters[y]) {
            case 0:  // None
                memcpy(o, r, (size_t)stride);
                break;
            case 1:  // Sub
                for (int64_t x = 0; x < stride; x++)
                    o[x] = (uint8_t)(r[x] + (x >= bpp ? o[x - bpp] : 0));
                break;
            case 2:  // Up
                if (up)
                    for (int64_t x = 0; x < stride; x++) o[x] = (uint8_t)(r[x] + up[x]);
                else
                    memcpy(o, r, (size_t)stride);
                break;
            case 3:  // Average
                for (int64_t x = 0; x < stride; x++) {
                    const int a = x >= bpp ? o[x - bpp] : 0;
                    const int b = up ? up[x] : 0;
                    o[x] = (uint8_t)(r[x] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int64_t x = 0; x < stride; x++) {
                    const int a = x >= bpp ? o[x - bpp] : 0;
                    const int b = up ? up[x] : 0;
                    const int c = (up && x >= bpp) ? up[x - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = p > a ? p - a : a - p;
                    const int pb = p > b ? p - b : b - p;
                    const int pc = p > c ? p - c : c - p;
                    const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    o[x] = (uint8_t)(r[x] + pred);
                }
                break;
            default:
                return GXT_ERR_FORMAT;
        }
    }
    return GXT_OK;
}

// q4_k: super-block k-quant (quant/kquant.py). Sub-block scale/min CODES are
// uint8 (Kp/32, N) planes; supers is f32 (2*ns, N) stacked halves (d rows,
// then m rows); block b decodes against super s = min(b/8, ns-1):
//   out[32b+t, j] = q * (supers[s,j]*sc[b,j]) - (supers[ns+s,j]*mc[b,j])
// Quantization itself stays in numpy (the weighted grid search + GPTQ live
// host-side, quant/kquant.py + quant/gptq.py); the native side provides the
// hot decode, matching the python dequantizer.
int q4_k_dequantize(const uint8_t* codes, const uint8_t* sc, const uint8_t* mc,
                    const float* supers, int64_t kp, int64_t n, int64_t ns,
                    float* out) {
    if (!codes || !sc || !mc || !supers || !out || kp <= 0 || n <= 0 ||
        ns <= 0 || kp % 32) return GXT_ERR_ARG;
    const int64_t nb = kp / 32;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nb; b++) {
        const int64_t s = (b / 8 < ns) ? b / 8 : ns - 1;
        const float* drow = supers + s * n;
        const float* mrow = supers + (ns + s) * n;
        const uint8_t* scrow = sc + b * n;
        const uint8_t* mcrow = mc + b * n;
        for (int64_t t = 0; t < 16; t++) {
            const uint8_t* crow = codes + (b * 16 + t) * n;
            float* lo = out + (b * 32 + t) * n;
            float* hi = out + (b * 32 + 16 + t) * n;
            for (int64_t j = 0; j < n; j++) {
                const float d = drow[j] * (float)scrow[j];
                const float m = mrow[j] * (float)mcrow[j];
                lo[j] = (float)(crow[j] & 0xF) * d - m;
                hi[j] = (float)(crow[j] >> 4) * d - m;
            }
        }
    }
    return GXT_OK;
}

int gxt_abi_version(void) { return 3; }

}  // extern "C"
