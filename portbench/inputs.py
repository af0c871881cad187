"""What the benchmark hands to the port and to the reference alike, made
from ``--seed``: the dataset (uint8 images at the eval's decode size, a
class's images sharing a low-frequency colour field so that episodes have
structure to learn) and the weights, in the reference repo's state-dict
layout (``feature.trunk.*``, ``fc.*``, ``gnn.*``, DampNet's modules) with
the reference's initialisers: trunk convs normal with ``std = sqrt(2 /
(k * k * out))``, linear layers and 1x1 convs ``U(+-1/sqrt(fan_in))``,
BN ``scale 1, bias 0``.  The weights are drawn on the device in one call
per initialiser and model, in float32."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def make_dataset(seed: int, data: dict):
    """``(images uint8 [N, base, base, 3], labels int64 [N])``, ``per_class``
    images of each of ``classes`` classes, made on the CPU."""
    g = torch.Generator().manual_seed(seed)
    c, k, base = data["classes"], data["per_class"], data["base_size"]
    field = F.interpolate(torch.rand((c, 3, 6, 6), generator=g), size=(12, 12), mode="bilinear",
                          align_corners=False)[:, None]
    own = torch.rand((c, k, 3, 12, 12), generator=g)
    low = (0.7 * field + 0.3 * own).reshape(c * k, 3, 12, 12)
    img = F.interpolate(low, size=(base, base), mode="bilinear", align_corners=False)
    img = img + 0.08 * torch.randn(img.shape, generator=g)
    img = (img.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).permute(0, 2, 3, 1).contiguous().numpy()
    labels = np.repeat(np.arange(c, dtype=np.int64), k)
    return img, labels


def _resnet_layout(widths=(64, 128, 256, 512)) -> list:
    """``(key, shape, init)`` of a ResNet10 ``feature.trunk``."""
    out = [("feature.trunk.0.weight", (widths[0], 3, 7, 7), "conv")]
    out += _bn_layout("feature.trunk.1", widths[0], running=True)
    cin = widths[0]
    for i, c in enumerate(widths):
        pre = f"feature.trunk.{4 + i}"
        out += [(f"{pre}.C1.weight", (c, cin, 3, 3), "conv")] + _bn_layout(f"{pre}.BN1", c, True)
        out += [(f"{pre}.C2.weight", (c, c, 3, 3), "conv")] + _bn_layout(f"{pre}.BN2", c, True)
        if cin != c:
            out += [(f"{pre}.shortcut.weight", (c, cin, 1, 1), "conv")] + _bn_layout(f"{pre}.BNshortcut", c, True)
        cin = c
    return out


def _bn_layout(pre: str, c: int, running: bool = False) -> list:
    out = [(f"{pre}.weight", (c,), "ones"), (f"{pre}.bias", (c,), "zeros")]
    if running:
        out += [(f"{pre}.running_mean", (c,), "zeros"), (f"{pre}.running_var", (c,), "ones"),
                (f"{pre}.num_batches_tracked", (), "count")]
    return out


def _lin_layout(pre: str, fan_in: int, fan_out: int, conv1x1: bool = False) -> list:
    shape = (fan_out, fan_in, 1, 1) if conv1x1 else (fan_out, fan_in)
    return [(f"{pre}.weight", shape, f"uniform:{fan_in}"), (f"{pre}.bias", (fan_out,), f"uniform:{fan_in}")]


def _wcompute_layout(pre: str, cin: int, nf: int) -> list:
    out, c = [], cin
    for i, r in enumerate((2, 2, 1, 1), start=1):
        out += _lin_layout(f"{pre}.conv2d_{i}", c, nf * r, conv1x1=True) + _bn_layout(f"{pre}.bn_{i}", nf * r)
        c = nf * r
    return out + _lin_layout(f"{pre}.conv2d_last", c, 1, conv1x1=True)


def _gnnnet_layout(head: dict, n_way: int) -> list:
    proj, nf, feat = head["proj"], head["nf"], head["feat"]
    out = _lin_layout("fc.0", feat, proj) + _bn_layout("fc.1", proj)
    c = proj + n_way
    for i in range(2):
        out += _wcompute_layout(f"gnn.layer_w{i}", c, nf) + _lin_layout(f"gnn.layer_l{i}.fc", 2 * c, nf // 2)
        out += _bn_layout(f"gnn.layer_l{i}.bn", nf // 2)
        c += nf // 2
    return out + _wcompute_layout("gnn.w_comp_last", c, nf) + _lin_layout("gnn.layer_last.fc", 2 * c, n_way)


def _dampnet_layout(head: dict) -> list:
    d, k, h = head["feat"], head["ntn"], head["mlp"]
    out = []
    for w, v in (("W_R", "V_R"), ("W_R_std", "V_R_std")):
        out += [(f"{w}.weight", (k, d, d), f"uniform:{d}")] + _lin_layout(v, 2 * d, k)
    for suffix in ("", "_add"):
        out += _lin_layout(f"layer1{suffix}", 2 * k, h) + _lin_layout(f"layer2{suffix}", h, h)
        out += _lin_layout(f"layer3{suffix}", h, d)
    return out


def layout(parts, head: dict, n_way: int) -> list:
    """The state dict of a model made of ``parts`` (``resnet10``,
    ``gnnnet``, ``dampnet``)."""
    out = []
    for part in parts:
        out += {"resnet10": lambda: _resnet_layout(), "gnnnet": lambda: _gnnnet_layout(head, n_way),
                "dampnet": lambda: _dampnet_layout(head)}[part]()
    return out


def make_state_dict(entries: list, gen: torch.Generator, device) -> dict:
    """Every tensor of ``entries``: the normals in one draw, the uniforms in
    one draw, on ``device`` (with ``gen`` a generator of that device)."""
    n_normal = sum(math.prod(s) for _, s, init in entries if init == "conv")
    n_unif = sum(math.prod(s) for _, s, init in entries if init.startswith("uniform"))
    normal = torch.randn(n_normal, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device).mul_(2.0).sub_(1.0)
    sd, i, j = {}, 0, 0
    for key, shape, init in entries:
        n = math.prod(shape)
        if init == "conv":
            sd[key] = normal[i : i + n].reshape(shape).mul_(math.sqrt(2.0 / (shape[2] * shape[3] * shape[0])))
            i += n
        elif init.startswith("uniform"):
            sd[key] = unif[j : j + n].reshape(shape).mul_(1.0 / math.sqrt(int(init.split(":")[1])))
            j += n
        elif init == "count":
            sd[key] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            sd[key] = (torch.ones if init == "ones" else torch.zeros)(shape, device=device)
    return sd


def make_models(seed: int, config: dict, n_way: int, device) -> dict:
    """``{name: state dict}`` of each model the configuration names, and
    for DampNet its source prototypes (``proto_mean``, ``proto_std``: an
    initialised state, so no source sweep runs), all drawn from ``seed`` on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, parts in config["models"].items():
        out[name] = make_state_dict(layout(parts, config["head"], n_way), gen, device)
    if "dampnet" in config["models"]:
        d = config["head"]["feat"]
        out["proto_mean"] = torch.rand(d, generator=gen, device=device)
        out["proto_std"] = torch.rand(d, generator=gen, device=device).mul_(0.5).add_(0.05)
    return out
