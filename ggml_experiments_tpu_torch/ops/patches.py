"""MobileViT patch unfold/fold: feature map <-> transformer token sequences.

Exact permutations. Ordering contract (the reference's and HF MobileViT's):
  patch_area index  p = ph_idx * PW + pw_idx
  num_patches index n = nh_idx * n_patch_w + nw_idx
"""

from __future__ import annotations

import torch


def unfold(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, patch_area, num_patches, C); H, W divisible by the patch."""
    b, h, w, c = x.shape
    ps = patch_size
    if h % ps or w % ps:
        raise ValueError(f"H={h}, W={w} not divisible by patch_size={ps}")
    nh, nw = h // ps, w // ps
    x = x.reshape(b, nh, ps, nw, ps, c).permute(0, 2, 4, 1, 3, 5)  # (B, ph, pw, nh, nw, C)
    return x.reshape(b, ps * ps, nh * nw, c)


def fold(x: torch.Tensor, patch_size: int, height: int, width: int) -> torch.Tensor:
    """(B, patch_area, num_patches, C) -> (B, H, W, C), the inverse of :func:`unfold`."""
    b, pa, np_, c = x.shape
    ps = patch_size
    nh, nw = height // ps, width // ps
    if pa != ps * ps or np_ != nh * nw:
        raise ValueError(f"bad fold shapes: {tuple(x.shape)} for patch={ps}, "
                         f"H={height}, W={width}")
    x = x.reshape(b, ps, ps, nh, nw, c).permute(0, 3, 1, 4, 2, 5)  # (B, nh, ph, nw, pw, C)
    return x.reshape(b, height, width, c)
