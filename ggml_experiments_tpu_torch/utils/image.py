"""Image loading and preprocessing for MobileViT, numpy (the resample in
the native runtime where it is available).

The reference's semantics: align-corners=False bilinear sampling of u8
values, each sample rounded back to u8, the long side scaled to ``size`` (the
rest of the canvas stays zero), then x/255. Also the deterministic synthetic
image the reference uses as its golden-test input.
"""

from __future__ import annotations

import io

import numpy as np


def synthetic_test_image(size: int = 256) -> np.ndarray:
    """The reference's golden-test input: ((y*size*3 + x*3 + c) % 256)/255,
    shape (size, size, 3) float32."""
    idx = np.arange(size * size * 3, dtype=np.int64).reshape(size, size, 3)
    return ((idx % 256) / 255.0).astype(np.float32)


def bilinear_resize_u8(img: np.ndarray, out_h: int, out_w: int, scale: float) -> np.ndarray:
    """Bilinear resample of a u8 HWC image, sampling at ``(x + 0.5)*scale -
    0.5`` with edge clamping and rounding half away from zero; only the
    top-left (out_h, out_w) region is produced. The native runtime's
    resample where it is available, else :func:`bilinear_resize_u8_py`."""
    from ggml_experiments_tpu_torch import runtime

    out = runtime.bilinear_resize_u8(img, out_h, out_w, scale)
    return bilinear_resize_u8_py(img, out_h, out_w, scale) if out is None else out


def bilinear_resize_u8_py(img: np.ndarray, out_h: int, out_w: int,
                          scale: float) -> np.ndarray:
    """The numpy resample, the plain version of the native one."""
    h, w, _ = img.shape
    ys = np.arange(out_h, dtype=np.float32)
    xs = np.arange(out_w, dtype=np.float32)
    sy = (ys + 0.5) * scale - 0.5
    sx = (xs + 0.5) * scale - 0.5
    y0 = np.clip(np.floor(sy).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(sx).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    dy = (sy - y0).astype(np.float32)[:, None, None]
    dx = (sx - x0).astype(np.float32)[None, :, None]
    f = img.astype(np.float32)
    v00 = f[y0][:, x0]
    v01 = f[y0][:, x1]
    v10 = f[y1][:, x0]
    v11 = f[y1][:, x1]
    v0 = v00 * (1 - dx) + v01 * dx
    v1 = v10 * (1 - dx) + v11 * dx
    v = v0 * (1 - dy) + v1 * dy
    return np.clip(np.floor(v + 0.5), 0, 255).astype(np.uint8)


def _resized(img_u8: np.ndarray, size: int):
    h, w, _ = img_u8.shape
    scale = max(h, w) / float(size)
    out_h = int(h / scale + 0.5)
    out_w = int(w / scale + 0.5)
    return bilinear_resize_u8(img_u8, out_h, out_w, scale), out_h, out_w


def preprocess(img_u8: np.ndarray, size: int = 256, mean: tuple = (0.0, 0.0, 0.0),
               std: tuple = (255.0, 255.0, 255.0)) -> np.ndarray:
    """u8 HWC image -> (size, size, 3) float32: the long side scaled to
    ``size``, each channel (v - mean)/std, resized rows at their natural
    canvas positions (the reference wraps portrait rows diagonally; this
    does not)."""
    resized, out_h, out_w = _resized(img_u8, size)
    canvas = np.zeros((size, size, 3), np.float32)
    canvas[:out_h, :out_w] = (resized.astype(np.float32) - np.asarray(mean)) / np.asarray(std)
    return canvas


def preprocess_canvas_u8(img_u8: np.ndarray, size: int = 256) -> np.ndarray:
    """The resize-and-paste half of :func:`preprocess`, kept u8, for the
    vision engine's u8 transport (the device applies x/255)."""
    resized, out_h, out_w = _resized(img_u8, size)
    canvas = np.zeros((size, size, 3), np.uint8)
    canvas[:out_h, :out_w] = resized
    return canvas


def load_image(path: str) -> np.ndarray:
    """Decode an image file to u8 RGB HWC: the numpy decoders first
    (``utils.image_codecs``), PIL for anything they do not take."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        from ggml_experiments_tpu_torch.utils import image_codecs

        return image_codecs.decode(data)
    except Exception:
        # an unknown format, a corrupt zlib stream, a truncated header: PIL
        # may still read what the numpy decoders cannot
        pass
    try:
        from PIL import Image
    except ImportError as ex:
        raise ValueError(f"{path}: not decodable without PIL") from ex
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def load_and_preprocess(path: str, size: int = 256) -> np.ndarray:
    return preprocess(load_image(path), size=size)
