"""Dependency-free JPEG decoder (baseline + progressive) -> u8 RGB (H, W, 3).

The port's own copy of the JAX package's decoder: a DCT JFIF decoder with
nothing but numpy (the reference's image path is a ``.JPG`` loaded through
its vendored stb_image.h).

Scope (what stb_image's JPEG path covers for the reference's use):
* Baseline sequential Huffman (SOF0; SOF1 accepted — same decode path),
  interleaved or one-scan-per-component (non-interleaved).
* Progressive (SOF2): spectral selection + successive approximation, DC
  first/refinement scans (interleaved or not) and per-component AC scans
  with EOB-run coding (ITU T.81 G.2), multiple scans accumulated into one
  coefficient store and reconstructed once at EOI.
* 1-component grayscale and 3-component YCbCr, any sampling factors up to
  4x4 (covers 4:4:4 / 4:2:2 / 4:2:0).
* Restart intervals (DRI / RSTn), in every scan kind.
* Triangle-filter ("fancy") chroma upsampling like libjpeg/stb, so output
  tracks the common decoders closely, not just blockily.

Not supported (falls back to PIL via utils.image.load_image): arithmetic
coding, hierarchical/lossless SOFs, 12-bit, CMYK/4-component.

Design: the entropy decode is inherently bit-serial, so it runs as one
python/numpy pass per scan accumulating per-block coefficient arrays
(zigzag order); everything after (dequant, un-zigzag, IDCT, upsample, color
convert) is batched numpy over all blocks at once. The IDCT is the exact
separable float transform (orthonormal DCT-III as two 8x8 matmuls over the
whole block batch).
"""

from __future__ import annotations

import struct

import numpy as np

# ---------------------------------------------------------------------------
# Constant tables
# ---------------------------------------------------------------------------

ZIGZAG = np.array([
     0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)

def _idct_matrix() -> np.ndarray:
    # A[u, x] = c(u)/2 * cos((2x+1) u pi / 16); IDCT: block = A.T @ X @ A
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    a = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
    a[0] *= 1 / np.sqrt(2)
    return a

_IDCT_A = _idct_matrix()


class _Huff:
    """Canonical JPEG Huffman table (F.2.2.3 decode procedure arrays)."""

    __slots__ = ("mincode", "maxcode", "valptr", "values", "lookup", "lookbits")

    def __init__(self, bits: np.ndarray, values: np.ndarray):
        # bits[l] = #codes of length l+1 (l in 0..15)
        code = 0
        k = 0
        self.mincode = np.zeros(17, np.int64)
        self.maxcode = np.full(17, -1, np.int64)
        self.valptr = np.zeros(17, np.int64)
        self.values = values
        codes = []
        for l in range(1, 17):
            self.valptr[l] = k
            self.mincode[l] = code
            n = int(bits[l - 1])
            for _ in range(n):
                codes.append((l, code))
                code += 1
                k += 1
            self.maxcode[l] = code - 1
            code <<= 1
        # Fast path: an 8-bit lookup table (symbol, length) for codes <= 8 bits.
        self.lookbits = 8
        self.lookup = np.full((1 << 8, 2), -1, np.int16)
        for idx, (l, c) in enumerate(codes):
            if l <= 8:
                lo = c << (8 - l)
                hi = lo + (1 << (8 - l))
                self.lookup[lo:hi, 0] = self.values[idx]
                self.lookup[lo:hi, 1] = l


class _BitReader:
    """MSB-first bit reader over the entropy-coded segment.

    Performs 0xFF00 unstuffing up front and records where each restart
    marker sits, so `resync()` can jump the cursor to the next RSTn.
    """

    __slots__ = ("buf", "nbits", "pos", "restarts", "_restart_idx", "end")

    def __init__(self, data: bytes, start: int):
        out = bytearray()
        restarts = []  # bit offsets (in `out`) where an RSTn boundary begins
        i = start
        n = len(data)
        while i < n:
            b = data[i]
            if b != 0xFF:
                out.append(b)
                i += 1
                continue
            nxt = data[i + 1] if i + 1 < n else 0xD9
            if nxt == 0x00:  # stuffed FF
                out.append(0xFF)
                i += 2
            elif 0xD0 <= nxt <= 0xD7:  # restart marker
                restarts.append(len(out) * 8)
                i += 2
            else:  # any other marker terminates the scan (EOI, next SOS...)
                break
        self.buf = bytes(out)
        self.nbits = len(out) * 8
        self.pos = 0
        self.restarts = restarts
        self._restart_idx = 0  # monotone cursor: decode only moves forward
        self.end = i  # raw-data offset of the marker that ended the scan

    def _bit(self) -> int:
        p = self.pos
        if p >= self.nbits:
            return 0  # spec: pad with zeros at the end of the scan
        self.pos = p + 1
        return (self.buf[p >> 3] >> (7 - (p & 7))) & 1

    def peek8(self) -> int:
        p = self.pos
        byte = p >> 3
        chunk = self.buf[byte : byte + 2]
        v = int.from_bytes(chunk + b"\x00" * (2 - len(chunk)), "big")
        return (v >> (8 - (p & 7))) & 0xFF

    def skip(self, n: int) -> None:
        self.pos += n

    def receive(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self._bit()
        return v

    def resync(self) -> None:
        """Advance to the next restart boundary after the current position."""
        i = self._restart_idx
        restarts = self.restarts
        while i < len(restarts) and restarts[i] < self.pos:
            i += 1
        if i < len(restarts):
            self.pos = restarts[i]
            self._restart_idx = i + 1
        else:
            self._restart_idx = i
            self.pos = self.nbits

    def decode(self, h: _Huff) -> int:
        # fast 8-bit table probe
        sym, l = h.lookup[self.peek8()]
        if l > 0:
            self.pos += int(l)
            return int(sym)
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self._bit()
            if code <= h.maxcode[length]:
                return int(h.values[h.valptr[length] + code - h.mincode[length]])
        raise ValueError("JPEG: corrupt Huffman data")


def _extend(v: int, t: int) -> int:
    # F.2.2.1 sign extension of a t-bit magnitude
    return v - (1 << t) + 1 if t and v < (1 << (t - 1)) else v


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class _Component:
    __slots__ = ("cid", "h", "v", "tq", "td", "ta", "blocks", "bw", "bh", "pred")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.pred = 0


def decode_jpeg(data: bytes) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise ValueError("JPEG: bad SOI")
    qt: dict[int, np.ndarray] = {}
    dc_tables: dict[int, _Huff] = {}
    ac_tables: dict[int, _Huff] = {}
    comps: list[_Component] = []
    width = height = None
    hmax = vmax = mcux = mcuy = 0
    restart_interval = 0
    progressive = False
    seen_scan = False
    pos = 2
    n = len(data)

    while pos + 4 <= n:
        if data[pos] != 0xFF:
            raise ValueError("JPEG: expected marker")
        while pos + 1 < n and data[pos + 1] == 0xFF:
            pos += 1  # fill bytes before a marker are legal (B.1.1.2)
        marker = data[pos + 1]
        if marker == 0xD9:  # EOI
            break
        seglen = struct.unpack(">H", data[pos + 2 : pos + 4])[0]
        seg = data[pos + 4 : pos + 2 + seglen]
        pos += 2 + seglen

        if marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                i += 1
                if pq:  # 16-bit table
                    tbl = np.frombuffer(seg[i : i + 128], ">u2").astype(np.int32)
                    i += 128
                else:
                    tbl = np.frombuffer(seg[i : i + 64], np.uint8).astype(np.int32)
                    i += 64
                qt[tq] = tbl
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = np.frombuffer(seg[i + 1 : i + 17], np.uint8)
                nv = int(bits.sum())
                vals = np.frombuffer(seg[i + 17 : i + 17 + nv], np.uint8).astype(np.int32)
                (dc_tables if tc == 0 else ac_tables)[th] = _Huff(bits, vals)
                i += 17 + nv
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1 baseline, SOF2 progressive
            progressive = marker == 0xC2
            prec, height, width, nc = seg[0], *struct.unpack(">HH", seg[1:5]), seg[5]
            if prec != 8:
                raise ValueError("JPEG: only 8-bit precision supported")
            if nc not in (1, 3):
                raise ValueError(f"JPEG: {nc}-component images not supported")
            comps = []
            for c in range(nc):
                cid, hv, tq_ = seg[6 + 3 * c : 9 + 3 * c]
                comps.append(_Component(cid, hv >> 4, hv & 15, tq_))
            # coefficient store, shared by every scan (MCU-padded dims)
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            for c in comps:
                c.bw = mcux * c.h  # blocks per row (padded to whole MCUs)
                c.bh = mcuy * c.v
                c.blocks = np.zeros((c.bh * c.bw, 64), np.int32)
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise ValueError("JPEG: non-baseline SOF not supported natively")
        elif marker == 0xDD:  # DRI
            restart_interval = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xDA:  # SOS
            ns = seg[0]
            if not comps:
                raise ValueError("JPEG: SOS before SOF (corrupt stream)")
            order = []
            for s in range(ns):
                cs, tdta = seg[1 + 2 * s : 3 + 2 * s]
                comp = next(c for c in comps if c.cid == cs)
                comp.td, comp.ta = tdta >> 4, tdta & 15
                order.append(comp)
            # spectral selection + successive approximation (baseline scans
            # carry 0/63/0/0 here; force it in case of sloppy encoders)
            if progressive:
                ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
                ah, al = seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
            else:
                ss, se, ah, al = 0, 63, 0, 0
            br = _BitReader(data, pos)
            _decode_scan(
                br, order, dc_tables, ac_tables, mcux, mcuy,
                restart_interval, progressive, ss, se, ah, al,
                hmax, vmax, width, height,
            )
            pos = br.end
            seen_scan = True
        # else: APPn / COM / DNL / anything else — skipped

    if not seen_scan:
        raise ValueError("JPEG: no scan found")
    return _finish(comps, qt, width, height, hmax, vmax)


def _decode_scan(br, order, dc_tables, ac_tables, mcux, mcuy,
                 restart_interval, progressive, ss, se, ah, al,
                 hmax, vmax, width, height) -> None:
    """Decode one entropy-coded scan into the components' coefficient store.

    Handles all four progressive scan kinds (DC/AC x first/refinement,
    T.81 G.2) plus full baseline blocks; single-component scans iterate the
    component's own block raster (non-interleaved, A.2.2), multi-component
    scans iterate MCUs (A.2.3).
    """
    for c in order:
        c.pred = 0
    state = {"eobrun": 0}

    def baseline_block(c, blk):
        dc_t, ac_t = dc_tables[c.td], ac_tables[c.ta]
        t = br.decode(dc_t)
        diff = _extend(br.receive(t), t) if t else 0
        c.pred += diff
        blk[0] = c.pred
        k = 1
        while k < 64:
            rs = br.decode(ac_t)
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r != 15:
                    break  # EOB
                k += 16
                continue
            k += r
            if k > 63:
                raise ValueError("JPEG: AC index overflow")
            blk[k] = _extend(br.receive(s), s)
            k += 1

    def decode_block(c, blk):
        if not progressive:
            baseline_block(c, blk)
        elif ss == 0:  # DC scan (se must be 0)
            if ah == 0:
                t = br.decode(dc_tables[c.td])
                diff = _extend(br.receive(t), t) if t else 0
                c.pred += diff
                blk[0] = c.pred << al
            elif br.receive(1):  # refinement: one bit per block
                blk[0] |= 1 << al
        elif ah == 0:
            state["eobrun"] = _ac_first(
                br, blk, ss, se, al, ac_tables[c.ta], state["eobrun"])
        else:
            state["eobrun"] = _ac_refine(
                br, blk, ss, se, al, ac_tables[c.ta], state["eobrun"])

    def restart():
        br.resync()
        for c in order:
            c.pred = 0
        state["eobrun"] = 0

    if len(order) == 1:
        # Non-interleaved: raster over this component's true block dims
        # (A.2.2) — NOT the MCU-padded store dims. Restart counts blocks.
        c = order[0]
        cw = -(-width * c.h // hmax)   # true component sample dims
        cv = -(-height * c.v // vmax)
        nbw = -(-cw // 8)
        nbh = -(-cv // 8)
        count = 0
        for by in range(nbh):
            for bx in range(nbw):
                if restart_interval and count and count % restart_interval == 0:
                    restart()
                count += 1
                decode_block(c, c.blocks[by * c.bw + bx])
    else:
        if progressive and ss != 0:
            raise ValueError("JPEG: interleaved AC scan is illegal (G.2)")
        mcu_index = 0
        for my in range(mcuy):
            for mx in range(mcux):
                if restart_interval and mcu_index and mcu_index % restart_interval == 0:
                    restart()
                mcu_index += 1
                for c in order:
                    for by in range(c.v):
                        for bx in range(c.h):
                            decode_block(
                                c,
                                c.blocks[(my * c.v + by) * c.bw + mx * c.h + bx],
                            )


def _ac_first(br, blk, ss, se, al, ac_t, eobrun) -> int:
    """First AC scan for one block (G.2.2): coefficients arrive shifted left
    by ``al``; an EOBn symbol starts a run of ``eobrun`` all-done blocks."""
    if eobrun > 0:
        return eobrun - 1
    k = ss
    while k <= se:
        rs = br.decode(ac_t)
        r, s = rs >> 4, rs & 15
        if s == 0:
            if r < 15:  # EOBn: run length 2^r + extra bits
                run = (1 << r) + (br.receive(r) if r else 0)
                return run - 1  # this block is the run's first
            k += 16  # ZRL
            continue
        k += r
        if k > se:
            raise ValueError("JPEG: AC index overflow")
        blk[k] = _extend(br.receive(s), s) << al
        k += 1
    return 0


def _ac_refine(br, blk, ss, se, al, ac_t, eobrun) -> int:
    """AC refinement scan for one block (G.2.3): already-nonzero coefficients
    receive a correction bit whenever the decode pointer crosses them; newly
    nonzero coefficients arrive as +-1 << al."""
    p1 = 1 << al
    m1 = -1 << al

    def correct(k):
        # correction bit for a history-nonzero coefficient at zigzag k
        if br.receive(1) and not (blk[k] & p1):
            blk[k] += p1 if blk[k] > 0 else m1

    k = ss
    if eobrun == 0:
        while k <= se:
            rs = br.decode(ac_t)
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r < 15:  # EOBn — correct the rest of this block below
                    eobrun = (1 << r) + (br.receive(r) if r else 0)
                    break
                val = 0  # ZRL: skip 16 zero-history coefficients
            elif s == 1:
                val = p1 if br.receive(1) else m1
            else:
                raise ValueError("JPEG: bad AC refinement magnitude")
            while k <= se:
                if blk[k] != 0:
                    correct(k)
                else:
                    if r == 0:
                        if val:
                            blk[k] = val
                        k += 1
                        break
                    r -= 1
                k += 1
    if eobrun > 0:
        while k <= se:
            if blk[k] != 0:
                correct(k)
            k += 1
        eobrun -= 1
    return eobrun


def _finish(comps, qt, width, height, hmax, vmax) -> np.ndarray:
    # Batched dequant + un-zigzag + IDCT per component.
    planes = []
    for c in comps:
        coeff = c.blocks * qt[c.tq][None, :]
        dezz = np.zeros_like(coeff)
        dezz[:, ZIGZAG] = coeff
        m = dezz.reshape(-1, 8, 8).astype(np.float64)
        pix = np.einsum("ux,nuv,vy->nxy", _IDCT_A, m, _IDCT_A, optimize=True)
        pix = np.clip(np.round(pix) + 128, 0, 255).astype(np.uint8)
        plane = (
            pix.reshape(c.bh, c.bw, 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(c.bh * 8, c.bw * 8)
        )
        ch = -(-width * c.h // hmax)   # this component's true sample dims
        cv = -(-height * c.v // vmax)
        planes.append(plane[:cv, :ch])

    if len(comps) == 1:
        return np.repeat(planes[0][:height, :width, None], 3, axis=-1)

    y = planes[0][:height, :width].astype(np.float32)
    cb = _upsample(planes[1], comps[1], hmax, vmax, width, height)
    cr = _upsample(planes[2], comps[2], hmax, vmax, width, height)
    cb -= 128.0
    cr -= 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def _upsample(plane: np.ndarray, c: _Component, hmax: int, vmax: int,
              width: int, height: int) -> np.ndarray:
    """Triangle-filter upsampling (libjpeg/stb 'fancy'), per axis.

    For a 2x axis: out[2i] = (3*in[i] + in[i-1] + 2) / 4,
    out[2i+1] = (3*in[i] + in[i+1] + 2) / 4, edges clamped. Other integer
    ratios fall back to nearest (rare in practice).
    """
    fh, fv = hmax // c.h, vmax // c.v

    def up2(a, axis):
        near = np.take(a, np.clip(np.arange(a.shape[axis]) - 1, 0, None), axis=axis)
        far = np.take(
            a, np.clip(np.arange(a.shape[axis]) + 1, None, a.shape[axis] - 1),
            axis=axis,
        )
        lo = (3.0 * a + near) / 4.0
        hi = (3.0 * a + far) / 4.0
        return np.stack([lo, hi], axis=axis + 1).reshape(
            *a.shape[:axis], a.shape[axis] * 2, *a.shape[axis + 1 :]
        )

    out = plane.astype(np.float32)
    f = fv
    while f > 1:
        out = up2(out, 0) if f == 2 else np.repeat(out, f, axis=0)
        f = 1 if f != 2 else f // 2
    f = fh
    while f > 1:
        out = up2(out, 1) if f == 2 else np.repeat(out, f, axis=1)
        f = 1 if f != 2 else f // 2
    return out[:height, :width]
