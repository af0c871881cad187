"""The port's augmentation (mft_tpu_torch/ops/augment.py) against the JAX
package's at explicit crop / flip / jitter draws, and against the
run-the-reference pixel goldens (tests/fixtures/pixel_golden.npz).

Tolerances: f32 at atol 2e-5 (the same separable warp weights, summed in
another order); the goldens at the JAX package's own bounds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mft_tpu.ops import augment as jaug
from mft_tpu_torch.ops import augment as taug

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "pixel_golden.npz")


def chw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


def hwc(t):
    return np.moveaxis(t.detach().float().numpy(), -3, -1)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(4, 40, 36, 3).astype(np.float32)


def test_crop_resize_with_flips_matches(images):
    boxes = [(3.0, 5.5, 30.0, 20.0), (0.0, 0.0, 40.0, 36.0), (10.25, 2.0, 12.5, 33.0), (7.0, 9.0, 8.0, 8.0)]
    flips_h = [False, True, False, True]
    flips_v = [False, False, True, True]
    f = jax.jit(lambda im, t, l, h, w, fh, fv: jaug._crop_resize(im, t, l, h, w, 24, flip_h=fh, flip_v=fv))
    want = np.stack([np.asarray(f(images[i], *boxes[i], flips_h[i], flips_v[i])) for i in range(4)])
    top, left, ch, cw = (torch.tensor([b[k] for b in boxes]) for k in range(4))
    got = taug._crop_resize(chw(images), top, left, ch, cw, 24, torch.tensor(flips_h), torch.tensor(flips_v))
    np.testing.assert_allclose(hwc(got), want, atol=2e-5)


def test_apply_enhance_matches(images):
    r = np.array([[1.2, 0.8, 1.1], [0.7, 1.3, 0.95], [1.0, 1.0, 1.0], [1.35, 0.6, 1.4]], np.float32)
    f = jax.jit(jaug.apply_enhance)
    want = np.stack([np.asarray(f(images[i], *r[i])) for i in range(4)])
    rt = torch.from_numpy(r)
    got = taug.apply_enhance(chw(images), rt[:, 0], rt[:, 1], rt[:, 2])
    np.testing.assert_allclose(hwc(got), want, atol=2e-6)
    # python-float factors on one image
    one = taug.apply_enhance(chw(images[1]), 0.7, 1.3, 0.95)
    np.testing.assert_allclose(hwc(one), want[1], atol=2e-6)


@pytest.mark.parametrize("base", [46, 40])
def test_center_view_matches(base):
    """base == int(1.15*40) skips the resize (the driver default); other
    bases go through the antialiased bilinear resize."""
    im = np.random.RandomState(1).rand(2, base, base, 3).astype(np.float32)
    f = jax.jit(lambda x: jax.vmap(lambda i: jaug.center_view(i, 40))(x))
    want = np.asarray(f(im))
    got = taug.center_batch(chw(im), 40)
    # normalized: the warp's rounding is magnified by 1/std (up to 4.4x)
    np.testing.assert_allclose(hwc(got), want, rtol=2e-5, atol=2e-5)


def test_to_float_and_normalize():
    u8 = np.random.RandomState(2).randint(0, 256, (2, 5, 5, 3), dtype=np.uint8)
    want = np.asarray(jaug.normalize(jaug.to_float(jnp.asarray(u8))))
    got = taug.normalize(taug.to_float(chw(u8)))
    np.testing.assert_allclose(hwc(got), want, atol=1e-6)
    assert taug.to_float(chw(u8), torch.bfloat16).dtype == torch.bfloat16
    assert taug.pipeline_dtype("bfloat16") == torch.bfloat16 and taug.pipeline_dtype("float32") == torch.float32


def test_sample_crop_box_in_bounds():
    cfg = taug.AugmentCfg(scale_min=0.5, scale_max=0.9)
    u = torch.rand((64, 4), generator=torch.Generator().manual_seed(0))
    top, left, ch, cw = taug._sample_crop(u, 40, 36, cfg)
    assert bool(((top >= 0) & (left >= 0) & (top + ch <= 40 + 1e-4) & (left + cw <= 36 + 1e-4)).all())
    area = ch * cw / (40 * 36)
    assert float(area.max()) <= 0.9 + 1e-5 and float(area.min()) > 0.3


def test_augment_batch_shapes_and_determinism():
    u8 = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (2, 3, 3, 30, 30), dtype=np.uint8))
    cfg = taug.AugmentCfg(image_size=16, vflip=True)
    a = taug.augment_batch(torch.Generator().manual_seed(5), u8, cfg)
    b = taug.augment_batch(torch.Generator().manual_seed(5), u8, cfg)
    c = taug.augment_batch(torch.Generator().manual_seed(6), u8, cfg)
    assert a.shape == (2, 3, 3, 16, 16) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    lo = (0.0 - max(taug.IMAGENET_MEAN)) / min(taug.IMAGENET_STD)
    hi = (1.0 - min(taug.IMAGENET_MEAN)) / min(taug.IMAGENET_STD)
    assert float(a.min()) >= lo - 1e-4 and float(a.max()) <= hi + 1e-4
    # a bf16 fan-out comes out f32 after the f32-factor jitter, as in JAX
    assert taug.augment_batch(torch.Generator().manual_seed(5), u8, cfg, torch.bfloat16).dtype == torch.float32


@pytest.fixture(scope="module")
def pg():
    if not os.path.exists(FIX):
        pytest.skip("pixel fixture missing; run tools/gen_pixel_golden.py")
    return dict(np.load(FIX))


def test_clean_view_pixel_golden(pg, tmp_path):
    """Host decode at 257 + device center view == the reference's
    Scale([257,257]) -> CenterCrop(224) -> ToTensor -> Normalize."""
    from PIL import Image

    from mft_tpu_torch.data.pipeline import decode_image

    for name in ("land", "port", "sq257"):
        path = str(tmp_path / f"{name}.png")
        Image.fromarray(pg[f"src.{name}"]).save(path)
        dec = decode_image(path, 257)
        np.testing.assert_array_equal(dec, pg[f"clean.{name}.resized_u8"])
        out = taug.center_batch(chw(dec[None]), 224)[0]
        np.testing.assert_allclose(hwc(out), pg[f"clean.{name}.out"], atol=1e-5)


def test_image_jitter_pixel_golden(pg):
    """apply_enhance vs the reference's own ImageJitter at recorded draws
    (the JAX package's bounds: max <= 4.5/255, mean <= 2/255)."""
    inp = chw(pg["jitter.input_u8"].astype(np.float32) / 255.0)
    for pname, alphas in {"train": (0.4, 0.4, 0.4), "cd2": (0.2, 0.2, 0.05)}.items():
        for cname in ("mid", "lo", "hi"):
            u = pg[f"jitter.{pname}.{cname}.u"]
            r = [a * (2.0 * float(uu) - 1.0) + 1.0 for a, uu in zip(alphas, u)]
            ours = hwc(taug.apply_enhance(inp, *r))
            err = np.abs(ours - pg[f"jitter.{pname}.{cname}.out_u8"].astype(np.float32) / 255.0)
            assert err.max() <= 4.5 / 255.0 and err.mean() <= 2.0 / 255.0, f"{pname}/{cname}"
