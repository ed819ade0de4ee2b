"""Dependency-free image decoding: PNG / JPEG / PPM / BMP / TGA / GIF -> u8
RGB HWC, numpy and the standard library only. The port's own copy of the JAX
package's decoders (the reference vendors stb_image for the same purpose).

Supported:
* PNG — 8-bit gray / gray+alpha / RGB / RGBA / palette, all five scanline
  filters, non-interlaced (interlaced falls back to PIL).
* JPEG — baseline and progressive DCT (utils/jpeg.py).
* PPM — binary P6 (maxval <= 255) and ascii P3.
* BMP — uncompressed 24/32-bit bottom-up or top-down.
* TGA — type 2/10 (true-color, raw + RLE), 24/32-bit, both row origins.
* GIF — 87a/89a, LZW, global/local palettes, interlace, first frame,
  transparency composited over the background color.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def decode(data: bytes) -> np.ndarray:
    """Sniff + decode an in-memory image file to u8 RGB (H, W, 3)."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode_png(data)
    if data[:2] in (b"P6", b"P3"):
        return decode_ppm(data)
    if data[:2] == b"BM":
        return decode_bmp(data)
    if data[:2] == b"\xff\xd8":
        from ggml_experiments_tpu_torch.utils.jpeg import decode_jpeg

        return decode_jpeg(data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return decode_gif(data)
    if _looks_like_tga(data):  # TGA has no magic: permissive header sniff, last
        return decode_tga(data)
    raise ValueError(
        "unrecognized image format (PNG/JPEG/PPM/BMP/GIF/TGA supported natively)"
    )


def _looks_like_tga(data: bytes) -> bool:
    if len(data) < 18:
        return False
    cmap_type, img_type = data[1], data[2]
    bpp = data[16]
    return (cmap_type == 0 and img_type in (2, 3, 10, 11)
            and bpp in (8, 24, 32))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_png(data: bytes) -> np.ndarray:
    pos = 8
    width = height = None
    bit_depth = color_type = interlace = None
    palette = None
    idat = []
    while pos + 8 <= len(data):
        (length,), ctype = struct.unpack(">I", data[pos : pos + 4]), data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length  # length + type + data + crc
        if ctype == b"IHDR":
            width, height, bit_depth, color_type, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if width is None:
        raise ValueError("PNG: missing IHDR")
    if bit_depth != 8:
        raise ValueError(f"PNG: only 8-bit supported natively (got {bit_depth})")
    if interlace:
        raise ValueError("PNG: interlaced images not supported natively")
    nch = _PNG_CHANNELS.get(color_type)
    if nch is None:
        raise ValueError(f"PNG: unknown color type {color_type}")

    raw = zlib.decompress(b"".join(idat))
    stride = width * nch
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG: truncated pixel data")
    rows = np.frombuffer(raw[: height * (stride + 1)], np.uint8).reshape(height, stride + 1)
    filters = rows[:, 0]
    recon = _png_unfilter(rows[:, 1:].astype(np.int32), filters, nch)

    img = recon.reshape(height, width, nch)
    if color_type == 3:  # palette
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        return palette[img[..., 0]]
    if nch == 1:  # gray
        return np.repeat(img, 3, axis=-1)
    if nch == 2:  # gray + alpha
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _png_unfilter(rows: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Reverse the five PNG scanline filters. rows: (H, W*bpp) int32."""
    h, stride = rows.shape
    out = np.zeros((h, stride), np.int32)
    zero = np.zeros(stride, np.int32)
    for y in range(h):
        raw = rows[y]
        up = out[y - 1] if y else zero
        f = int(filters[y])
        if f == 0:  # None
            out[y] = raw
        elif f == 2:  # Up
            out[y] = (raw + up) & 0xFF
        elif f == 1:  # Sub: recon[x] = raw[x] + recon[x-bpp]  (per-channel cumsum)
            r = raw.reshape(-1, bpp)
            out[y] = np.mod(np.cumsum(r, axis=0, dtype=np.int64), 256).reshape(stride)
        elif f == 3:  # Average
            row = out[y]
            for x in range(stride):
                left = row[x - bpp] if x >= bpp else 0
                row[x] = (raw[x] + ((left + up[x]) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            row = out[y]
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                b = up[x]
                c = up[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[x] = (raw[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: bad filter byte {f}")
    return out.astype(np.uint8)


# ---------------------------------------------------------------------------
# PPM (P6 binary / P3 ascii)
# ---------------------------------------------------------------------------

def decode_ppm(data: bytes) -> np.ndarray:
    tokens = []
    pos = 0
    while len(tokens) < 4:
        # skip whitespace and comments
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        tokens.append(data[start:pos])
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval > 255:
        raise ValueError("PPM: 16-bit maxval not supported")
    if magic == b"P6":
        pos += 1  # single whitespace after maxval
        px = np.frombuffer(data[pos : pos + w * h * 3], np.uint8)
    elif magic == b"P3":
        px = np.array(data[pos:].split(), np.int64).astype(np.uint8)[: w * h * 3]
    else:
        raise ValueError(f"PPM: unknown magic {magic!r}")
    if px.size < w * h * 3:
        raise ValueError("PPM: truncated pixel data")
    return px.reshape(h, w, 3)


# ---------------------------------------------------------------------------
# BMP (uncompressed 24/32-bit)
# ---------------------------------------------------------------------------

def decode_bmp(data: bytes) -> np.ndarray:
    if data[:2] != b"BM":
        raise ValueError("BMP: bad magic")
    pixel_offset = struct.unpack("<I", data[10:14])[0]
    header_size = struct.unpack("<I", data[14:18])[0]
    if header_size < 40:
        raise ValueError("BMP: ancient header not supported")
    w, h = struct.unpack("<ii", data[18:26])
    planes, bpp = struct.unpack("<HH", data[26:30])
    compression = struct.unpack("<I", data[30:34])[0]
    if compression not in (0, 3) or bpp not in (24, 32):
        raise ValueError(f"BMP: only uncompressed 24/32-bit supported (bpp={bpp})")
    flip = h > 0
    h = abs(h)
    nbytes = bpp // 8
    stride = (w * nbytes + 3) & ~3
    px = np.frombuffer(data[pixel_offset : pixel_offset + stride * h], np.uint8)
    px = px.reshape(h, stride)[:, : w * nbytes].reshape(h, w, nbytes)
    rgb = px[..., 2::-1]  # BGR(A) -> RGB
    return np.ascontiguousarray(rgb[::-1] if flip else rgb)


# ---------------------------------------------------------------------------
# TGA (stb_image supports it; the reference's loader accepts .tga inputs)
# ---------------------------------------------------------------------------


def decode_tga(data: bytes) -> np.ndarray:
    """Truevision TGA: image types 2 (raw true-color) and 10 (RLE), 24/32-bit
    BGR(A) pixels, top- or bottom-origin. Grayscale (3/11) also handled."""
    if len(data) < 18:
        raise ValueError("TGA: truncated header")
    (id_len, cmap_type, img_type, _cm_first, _cm_len, _cm_bits,
     _x0, _y0, w, h, bpp, desc) = struct.unpack("<BBBHHBHHHHBB", data[:18])
    if cmap_type != 0:
        raise ValueError("TGA: color-mapped images unsupported")
    if img_type not in (2, 3, 10, 11):
        raise ValueError(f"TGA: unsupported image type {img_type}")
    if img_type in (2, 10) and bpp not in (24, 32):
        raise ValueError(f"TGA: unsupported depth {bpp} for true-color")
    if img_type in (3, 11) and bpp != 8:
        raise ValueError(f"TGA: unsupported depth {bpp} for grayscale")
    if w == 0 or h == 0:
        raise ValueError("TGA: zero dimension")
    nb = bpp // 8
    pos = 18 + id_len
    n_px = w * h
    if img_type in (2, 3):  # raw
        need = n_px * nb
        if len(data) < pos + need:
            raise ValueError("TGA: truncated pixel data")
        px = np.frombuffer(data[pos : pos + need], np.uint8).reshape(n_px, nb)
    else:  # RLE
        out = np.empty((n_px, nb), np.uint8)
        filled = 0
        while filled < n_px:
            if pos >= len(data):
                raise ValueError("TGA: truncated RLE stream")
            hdr = data[pos]
            pos += 1
            count = (hdr & 0x7F) + 1
            count = min(count, n_px - filled)
            if hdr & 0x80:  # run packet: one pixel repeated
                if pos + nb > len(data):
                    raise ValueError("TGA: truncated RLE run")
                out[filled : filled + count] = np.frombuffer(
                    data[pos : pos + nb], np.uint8)
                pos += nb
            else:           # literal packet
                need = count * nb
                if pos + need > len(data):
                    raise ValueError("TGA: truncated RLE literals")
                out[filled : filled + count] = np.frombuffer(
                    data[pos : pos + need], np.uint8).reshape(count, nb)
                pos += need
            filled += count
        px = out
    px = px.reshape(h, w, nb)
    if nb == 1:
        rgb = np.repeat(px, 3, axis=2)
    else:
        rgb = px[..., 2::-1]  # BGR(A) -> RGB
    if not (desc & 0x20):     # bit 5 clear: bottom-left origin
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)


# ---------------------------------------------------------------------------
# GIF (stb_image supports it; first frame, like stb's non-animated path)
# ---------------------------------------------------------------------------


def _gif_lzw(data: bytes, min_code: int, n_pixels: int) -> np.ndarray:
    """GIF-variant LZW decode to ``n_pixels`` palette indices."""
    clear = 1 << min_code
    end = clear + 1
    # bit reader over the concatenated sub-block payload
    bits = 0
    nbits = 0
    pos = 0
    out = np.empty(n_pixels, np.uint8)
    filled = 0

    def reset_table():
        return {i: bytes([i]) for i in range(clear)}, clear + 2, min_code + 1

    table, next_code, code_size = reset_table()
    prev = None
    while filled < n_pixels:
        while nbits < code_size:
            if pos >= len(data):
                raise ValueError("GIF: truncated LZW stream")
            bits |= data[pos] << nbits
            nbits += 8
            pos += 1
        code = bits & ((1 << code_size) - 1)
        bits >>= code_size
        nbits -= code_size
        if code == clear:
            table, next_code, code_size = reset_table()
            prev = None
            continue
        if code == end:
            break
        if prev is None:
            entry = table[code]
        elif code in table:
            entry = table[code]
            table[next_code] = prev + entry[:1]
            next_code += 1
        elif code == next_code:
            entry = prev + prev[:1]
            table[next_code] = entry
            next_code += 1
        else:
            raise ValueError("GIF: corrupt LZW code")
        if next_code == (1 << code_size) and code_size < 12:
            code_size += 1
        take = min(len(entry), n_pixels - filled)
        out[filled : filled + take] = np.frombuffer(entry[:take], np.uint8)
        filled += take
        prev = entry
    if filled < n_pixels:
        raise ValueError("GIF: LZW stream ended early")
    return out


def decode_gif(data: bytes) -> np.ndarray:
    """GIF87a/89a first frame to u8 RGB. Transparent pixels composite over
    the logical-screen background color (stb_image's behavior for frame 0).
    Truncations raise a clean ValueError at whatever byte they bite."""
    try:
        return _decode_gif(data)
    except (struct.error, IndexError) as ex:
        raise ValueError(f"GIF: truncated or corrupt stream ({ex})") from ex


def _decode_gif(data: bytes) -> np.ndarray:
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("GIF: bad signature")
    sw, sh, flags, bg_idx, _ar = struct.unpack("<HHBBB", data[6:13])
    pos = 13
    gct = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gct = np.frombuffer(data[pos : pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
    transparent = None
    while pos < len(data):
        block = data[pos]
        pos += 1
        if block == 0x21:  # extension
            label = data[pos]
            pos += 1
            if label == 0xF9:  # graphic control: transparency index
                size = data[pos]
                gce = data[pos + 1 : pos + 1 + size]
                if size >= 4 and (gce[0] & 1):
                    transparent = gce[3]
                pos += 1 + size
            while data[pos] != 0:  # skip (remaining) sub-blocks
                pos += 1 + data[pos]
            pos += 1
        elif block == 0x2C:  # image descriptor: the first frame
            ix, iy, iw, ih, iflags = struct.unpack("<HHHHB", data[pos : pos + 9])
            pos += 9
            pal = gct
            if iflags & 0x80:  # local color table
                n = 2 << (iflags & 7)
                pal = np.frombuffer(data[pos : pos + 3 * n], np.uint8).reshape(n, 3)
                pos += 3 * n
            if pal is None:
                raise ValueError("GIF: no color table")
            min_code = data[pos]
            pos += 1
            payload = bytearray()
            while data[pos] != 0:
                n = data[pos]
                payload += data[pos + 1 : pos + 1 + n]
                pos += 1 + n
            pos += 1
            idx = _gif_lzw(bytes(payload), min_code, iw * ih).reshape(ih, iw)
            if iflags & 0x40:  # interlaced: reorder the 4 passes
                de = np.empty_like(idx)
                rows = np.concatenate([
                    np.arange(0, ih, 8), np.arange(4, ih, 8),
                    np.arange(2, ih, 4), np.arange(1, ih, 2)])
                de[rows] = idx
                idx = de
            frame = pal[np.minimum(idx, len(pal) - 1)]
            if transparent is not None and transparent < len(pal) and gct is not None:
                bg = gct[min(bg_idx, len(gct) - 1)]
                frame = np.where((idx == transparent)[..., None], bg, frame)
            # paste onto the logical screen (frames may be offset subrects)
            canvas = np.zeros((sh, sw, 3), np.uint8)
            if gct is not None:
                canvas[:] = gct[min(bg_idx, len(gct) - 1)]
            canvas[iy : iy + ih, ix : ix + iw] = frame
            return np.ascontiguousarray(canvas)
        elif block == 0x3B:  # trailer before any image
            break
        else:
            raise ValueError(f"GIF: unexpected block 0x{block:02x}")
    raise ValueError("GIF: no image data")
