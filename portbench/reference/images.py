"""The eval's two views of an image, in float32 (the reference's torchvision
transforms as the port computes them, so that both see the same pixels at
the same draws): the clean view (``Resize(1.15 s)`` + ``CenterCrop(s)``;
the benchmark's images are stored at ``1.15 s``, so it is a crop), and the
augmented view (``RandomResizedCrop`` as a bilinear warp with the flips
folded in, ``ImageJitter`` brightness / contrast / color), both with
ImageNet normalization.  Nine uniforms an image: crop box (4), jitter (3),
flips (2)."""

from __future__ import annotations

import math

import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LUMA = (0.299, 0.587, 0.114)
F32_EPS = float(torch.finfo(torch.float32).eps)


def _chan(vals, x):
    return torch.tensor(vals, dtype=x.dtype, device=x.device).reshape(3, 1, 1)


def normalize(x):
    return (x - _chan(MEAN, x)) / _chan(STD, x)


def clean_view(images_u8: torch.Tensor, size: int) -> torch.Tensor:
    """``[..., 3, B, B]`` uint8 at ``B = int(1.15 size)`` -> ``[..., 3, size, size]``."""
    big = int(size * 1.15)
    if images_u8.shape[-1] != big or images_u8.shape[-2] != big:
        raise ValueError(f"images are {tuple(images_u8.shape[-2:])}, the clean view expects {big}")
    off = (big - size) // 2
    x = images_u8.float() / 255.0
    return normalize(x[..., off : off + size, off : off + size])


def _weights(in_size: int, out_size: int, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Triangle-kernel resampling weights ``[M, in, out]`` for ``in = (out +
    0.5 - shift) / scale - 0.5`` (no antialiasing), rows outside the image 0."""
    dev = scale.device
    inv = 1.0 / scale
    pos = (torch.arange(out_size, dtype=torch.float32, device=dev)[None] + 0.5) * inv[:, None] - shift[:, None] * inv[:, None] - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - (pos[:, None, :] - src[None, :, None]).abs(), min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * F32_EPS, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (pos >= -0.5) & (pos <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def augmented_view(images_u8: torch.Tensor, u: torch.Tensor, aug: dict, size: int) -> torch.Tensor:
    """``[M, 3, H, W]`` uint8 and nine uniforms an image ``u [M, 9]`` ->
    ``[M, 3, size, size]``."""
    x = images_u8.float() / 255.0
    m, h, w = x.shape[0], x.shape[-2], x.shape[-1]
    u = u.to(x.device)
    area = h * w
    target = (aug["scale_min"] + (aug["scale_max"] - aug["scale_min"]) * u[:, 0]) * area
    lo, hi = math.log(aug["ratio_min"]), math.log(aug["ratio_max"])
    ratio = torch.exp(lo + (hi - lo) * u[:, 1])
    cw = torch.clamp(torch.sqrt(target * ratio), 8.0, float(w))
    ch = torch.clamp(torch.sqrt(target / ratio), 8.0, float(h))
    top, left = u[:, 2] * (h - ch), u[:, 3] * (w - cw)
    sy, sx = size / ch, size / cw
    ty, tx = -top * sy, -left * sx
    if aug["vflip"]:
        fv = u[:, 8] < 0.5
        sy, ty = torch.where(fv, -sy, sy), torch.where(fv, size + top * sy, ty)
    if aug["hflip"]:
        fh = u[:, 7] < 0.5
        sx, tx = torch.where(fh, -sx, sx), torch.where(fh, size + left * sx, tx)
    wy, wx = _weights(h, size, sy, ty), _weights(w, size, sx, tx)
    img = torch.matmul(torch.matmul(wy.transpose(1, 2)[:, None], x), wx[:, None]).clamp(0.0, 1.0)
    r = torch.tensor([aug["brightness"], aug["contrast"], aug["color"]], device=x.device) * (2.0 * u[:, 4:7] - 1.0) + 1.0
    rb, rc, rs = (r[:, k].reshape(m, 1, 1, 1) for k in range(3))
    luma = _chan(LUMA, img)
    img = torch.clamp(img * rb, 0.0, 1.0)
    mean = (img * luma).sum(dim=-3, keepdim=True).mean(dim=(-3, -2, -1), keepdim=True)
    img = torch.clamp(mean + (img - mean) * rc, 0.0, 1.0)
    gray = (img * luma).sum(dim=-3, keepdim=True)
    img = torch.clamp(gray + (img - gray) * rs, 0.0, 1.0)
    return normalize(img)
