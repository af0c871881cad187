"""On-device image augmentation (port of ``mft_tpu/ops/augment.py``).

Images are NCHW (``[..., 3, H, W]``).  The host ships uint8 base-resolution
images; the replica fan-out runs on the device:

* RandomResizedCrop as one bilinear affine warp per image, with the random
  flips folded into the warp's scale/translation (``_crop_resize``),
* ImageJitter (Brightness, Contrast, Color) at per-image factors
  (``apply_enhance``),
* Resize(1.15x) + CenterCrop for the clean view (``center_view``),
* ImageNet normalization.

The warp reproduces ``jax.image.scale_and_translate`` (triangle kernel,
weight matrices per axis, ``antialias=False`` for crops and ``True`` for
the clean-view resize), so the port and the JAX package see the same pixels
at the same draws.  Draws come from an explicit ``torch.Generator`` and are
injectable: ``_crop_resize`` and ``apply_enhance`` take them as arguments.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_LUMA = (0.299, 0.587, 0.114)  # PIL L-mode weights
_F32_EPS = float(np.finfo(np.float32).eps)


class AugmentCfg(NamedTuple):
    image_size: int = 224
    scale_min: float = 0.08
    scale_max: float = 1.0
    ratio_min: float = 3.0 / 4.0
    ratio_max: float = 4.0 / 3.0
    brightness: float = 0.4
    contrast: float = 0.4
    color: float = 0.4
    hflip: bool = True
    vflip: bool = False


def pipeline_dtype(compute_dtype: str) -> torch.dtype:
    """bf16 for a bf16 backbone (half the fan-out traffic at uint8-source
    precision), else f32."""
    return torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32


def to_float(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0,255] -> float [0,1]."""
    if images.dtype == torch.uint8:
        return images.to(dtype) / torch.tensor(255.0, dtype=dtype, device=images.device)
    return images.to(dtype)


def _chan(vals, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(vals, dtype=x.dtype, device=x.device).reshape(3, 1, 1)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of ``[..., 3, H, W]`` in [0,1]."""
    return (x - _chan(IMAGENET_MEAN, x)) / _chan(IMAGENET_STD, x)


def _weight_mat(in_size: int, out_size: int, scale: torch.Tensor, translation: torch.Tensor,
                antialias: bool) -> torch.Tensor:
    """``jax.image`` ``compute_weight_mat`` for a triangle kernel, batched
    over the leading dim of ``scale``/``translation`` ``[M]`` -> ``[M, in, out]``
    (f32)."""
    dev = scale.device
    inv = 1.0 / scale
    kernel_scale = torch.clamp(inv, min=1.0) if antialias else torch.ones_like(inv)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample_f = (out_pos[None, :] + 0.5) * inv[:, None] - translation[:, None] * inv[:, None] - 0.5  # [M, out]
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (sample_f[:, None, :] - in_pos[None, :, None]).abs() / kernel_scale[:, None, None]
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def _warp(images: torch.Tensor, size: int, sy, sx, ty, tx, antialias: bool) -> torch.Tensor:
    """``[M, C, H, W]`` -> ``[M, C, size, size]``: separable resample with
    per-image scale/translation ``[M]`` (``in = (out + 0.5 - t)/s - 0.5``)."""
    wy = _weight_mat(images.shape[-2], size, sy, ty, antialias).to(images.dtype)  # [M, H, size]
    wx = _weight_mat(images.shape[-1], size, sx, tx, antialias).to(images.dtype)  # [M, W, size]
    tmp = torch.matmul(wy.transpose(1, 2)[:, None], images)  # [M, C, size, W]
    return torch.matmul(tmp, wx[:, None])  # [M, C, size, size]


def _vec(v, m: int, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1).expand(m)


def _crop_resize(images: torch.Tensor, top, left, ch, cw, size: int, flip_h=None, flip_v=None) -> torch.Tensor:
    """Bilinear (non-antialiased) resize of per-image crop boxes to a
    ``size`` square, as one warp.  ``images [M, C, H, W]``; the box
    parameters and the boolean flips are scalars or ``[M]``.  A flip negates
    the warp's scale and moves its translation: a mirrored gather at no
    extra traffic."""
    m, dev = images.shape[0], images.device
    top, left, ch, cw = (_vec(v, m, dev) for v in (top, left, ch, cw))
    sy, sx = size / ch, size / cw
    ty, tx = -top * sy, -left * sx
    if flip_v is not None:
        fv = torch.as_tensor(flip_v, device=dev).reshape(-1).expand(m)
        sy, ty = torch.where(fv, -sy, sy), torch.where(fv, size + top * sy, ty)
    if flip_h is not None:
        fh = torch.as_tensor(flip_h, device=dev).reshape(-1).expand(m)
        sx, tx = torch.where(fh, -sx, sx), torch.where(fh, size + left * sx, tx)
    return _warp(images, size, sy, sx, ty, tx, antialias=False)


def _sample_crop(u: torch.Tensor, h: int, w: int, cfg: AugmentCfg):
    """RandomResizedCrop box from four uniforms per image ``u [M, 4]``
    (area, log-ratio, top, left); the box is clamped to the image instead of
    torchvision's rejection loop.  Returns ``(top, left, ch, cw)``, each ``[M]``."""
    area = h * w
    target = (cfg.scale_min + (cfg.scale_max - cfg.scale_min) * u[:, 0]) * area
    lo, hi = math.log(cfg.ratio_min), math.log(cfg.ratio_max)
    ratio = torch.exp(lo + (hi - lo) * u[:, 1])
    cw = torch.clamp(torch.sqrt(target * ratio), 8.0, float(w))
    ch = torch.clamp(torch.sqrt(target / ratio), 8.0, float(h))
    return u[:, 2] * (h - ch), u[:, 3] * (w - cw), ch, cw


def _factor(r, img: torch.Tensor) -> torch.Tensor:
    if isinstance(r, torch.Tensor):
        return r.to(img.device).reshape(tuple(r.shape) + (1, 1, 1))
    return r


def apply_enhance(img: torch.Tensor, r_b, r_c, r_s) -> torch.Tensor:
    """ImageJitter at explicit factors: Brightness, Contrast, Color, each a
    blend clipped to [0,1].  ``img [..., 3, H, W]``; a factor is a float or a
    tensor of the leading shape (a tensor factor promotes a bf16 image to
    f32, as the JAX package's f32 draws do)."""
    r_b, r_c, r_s = (_factor(r, img) for r in (r_b, r_c, r_s))
    img = torch.clamp(img * r_b, 0.0, 1.0)
    luma = _chan(_LUMA, img)
    gray = (img * luma).sum(dim=-3, keepdim=True)
    mean = gray.to(torch.float32).mean(dim=(-3, -2, -1), keepdim=True).to(img.dtype)
    img = torch.clamp(mean + (img - mean) * r_c, 0.0, 1.0)
    gray = (img * luma).sum(dim=-3, keepdim=True)
    return torch.clamp(gray + (img - gray) * r_s, 0.0, 1.0)


def augment_batch(gen: torch.Generator, images: torch.Tensor, cfg: AugmentCfg, dtype=torch.float32) -> torch.Tensor:
    """Independent augmented, normalized views of ``[..., 3, H0, W0]``
    (uint8 or float).  Nine uniforms per image are drawn from ``gen`` (on
    the CPU): crop box (4), jitter (3), flips (2)."""
    images = to_float(images, dtype)
    lead = images.shape[:-3]
    flat = images.reshape((-1,) + tuple(images.shape[-3:]))
    m, h, w = flat.shape[0], flat.shape[-2], flat.shape[-1]
    u = torch.rand((m, 9), generator=gen).to(images.device)
    top, left, ch, cw = _sample_crop(u[:, :4], h, w, cfg)
    flip_h = u[:, 7] < 0.5 if cfg.hflip else None
    flip_v = u[:, 8] < 0.5 if cfg.vflip else None
    img = torch.clamp(_crop_resize(flat, top, left, ch, cw, cfg.image_size, flip_h, flip_v), 0.0, 1.0)
    alphas = torch.tensor([cfg.brightness, cfg.contrast, cfg.color], device=images.device)
    r = alphas * (2.0 * u[:, 4:7] - 1.0) + 1.0
    out = normalize(apply_enhance(img, r[:, 0], r[:, 1], r[:, 2]))
    return out.reshape(lead + tuple(out.shape[1:]))


def center_view(images: torch.Tensor, size: int) -> torch.Tensor:
    """Resize to ``int(1.15*size)`` square (antialiased bilinear; skipped
    when the host already decoded at that size) then center-crop ``size``
    and normalize.  ``images [M, 3, H, W]``."""
    big = int(size * 1.15)
    m, h, w = images.shape[0], images.shape[-2], images.shape[-1]
    if h != big or w != big:
        dev = images.device
        sy = torch.full((m,), big / h, device=dev)
        sx = torch.full((m,), big / w, device=dev)
        zero = torch.zeros(m, device=dev)
        images = _warp(images, big, sy, sx, zero, zero, antialias=True)
    off = (big - size) // 2
    return normalize(images[..., off : off + size, off : off + size])


def center_batch(images: torch.Tensor, size: int, dtype=torch.float32) -> torch.Tensor:
    """Clean views of ``[..., 3, H0, W0]``."""
    images = to_float(images, dtype)
    lead = images.shape[:-3]
    out = center_view(images.reshape((-1,) + tuple(images.shape[-3:])), size)
    return out.reshape(lead + tuple(out.shape[1:]))


def make_eval_replicas(gen: torch.Generator, support_images: torch.Tensor, cfg: AugmentCfg,
                       gen_examples: int) -> torch.Tensor:
    """The eval's whole support bank as images, f32 (the faithful
    ``bn_mode='minibatch'`` eval).  ``support_images [n_way, n_support, 3,
    H0, W0]`` -> ``[gen_examples + 3, n_way, n_support, 3, S, S]``: the clean
    view three times (the reference bank duplicates ``liz_x[0]`` and its
    second no-aug replica equals the first, finetune.py:93,225-233), then
    ``gen_examples`` augmented views drawn from ``gen`` one replica after
    another."""
    support_images = to_float(support_images)
    clean = center_batch(support_images, cfg.image_size)
    augs = [augment_batch(gen, support_images, cfg) for _ in range(gen_examples)]
    return torch.stack([clean, clean, clean] + augs)
