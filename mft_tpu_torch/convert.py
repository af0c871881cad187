"""Weights into the port: from the JAX package's trees, and from / to the
reference's ``.tar`` state dicts.

* :func:`from_jax` maps JAX trees held as numpy arrays (NHWC/HWIO, linear
  ``w [in, out]``) onto the port's trees: HWIO conv weights -> OIHW, ``[F, C]``
  linear and 1x1-conv matrices -> ``[C, F]``, BN scale/bias/mean/var as they
  are; DampNet's Bilinear weights ``[out, f, f]`` as they are.  A second tree
  (the running stats, or DampNet's ``damp_state``) maps leaf by leaf, dtypes
  kept (``initialized`` bool, ``count`` int32).  :func:`to_jax` is its inverse; :func:`adam_from_jax` /
  :func:`adam_to_jax` carry the training driver's Adam state the same way.
* :func:`flat_from_jax` / :func:`flat_to_jax` carry the fused inner scan's
  flat parameter dict (``kernels/fused_inner_scan.py`` ``PKEYS``) across.  The
  port keeps the JAX module's layout there (HWIO conv weights flattened to
  ``[kh*kw*ci, co]``, BN vectors ``[1, C]``), so only the container changes.
* :func:`from_state_dict` / :func:`to_state_dict` map the reference's
  ``model.state_dict()`` key layout (``feature.trunk.*``, ``fc.*``,
  ``gnn.*``, ``classifier.*``, DampNet's ``W_R``, ``V_R``, ``W_R_std``,
  ``V_R_std``, ``layer{1,2,3}[_add]``; the mapping of
  ``mft_tpu/utils/torch_import.py``, kept here as a copy) for ResNet10 and
  the heads; :func:`heads_from_state_dict` maps a state dict without a
  backbone.  DampNet's prototypes and stores are not in a reference state
  dict (plain attributes there): ``utils/checkpoint.py`` keeps them beside it; :func:`load_tar` / :func:`save_tar` read and write the
  ``{'epoch', 'state'}`` files that the reference's train.py and
  ``mft_tpu.cli.export_ckpt`` write.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from mft_tpu_torch.models.backbone import ResNetCfg

#: DampNet's recovery modules in the reference's state dict (methods/dampnet.py:32-45,
#: dampnet_full_class.py:33-46)
DAMPNET_MODULES = ("W_R", "V_R", "W_R_std", "V_R_std", "layer1", "layer2", "layer3", "layer1_add", "layer2_add",
                   "layer3_add")


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def _map_tree(tree, leaf, key=None):
    if isinstance(tree, dict):
        return {k: _map_tree(v, leaf, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, leaf) for v in tree]
    return leaf(key, tree)


def from_jax(params_np, stats_np=None, *, device="cpu"):
    """JAX trees (numpy leaves) -> port trees of tensors on ``device``.
    Returns ``(params, stats)``; ``stats`` is None when not given."""

    def leaf(key, a):
        a = np.asarray(a)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif key == "w" and a.ndim == 2:
            a = a.T  # [in, out] -> [out, in]
        return _tensor(a, device)

    params = _map_tree(params_np, leaf)
    stats = _map_tree(stats_np, lambda k, a: _tensor(a, device)) if stats_np is not None else None
    return params, stats


def to_jax(params, stats=None):
    """Inverse of :func:`from_jax`: port trees -> numpy trees in JAX layout."""

    def leaf(key, t):
        a = t.detach().cpu().numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif key == "w" and a.ndim == 2:
            a = a.T
        return np.ascontiguousarray(a)

    out = _map_tree(params, leaf)
    return (out, _map_tree(stats, lambda k, t: t.detach().cpu().numpy())) if stats is not None else (out, None)


def adam_from_jax(opt_state_np, *, device="cpu") -> dict:
    """The JAX ``torch_adam`` state (the optax chain's tuple, whose
    ``ScaleByAdamState`` holds ``count``, ``mu`` and ``nu``; numpy leaves)
    -> the port's ``torch_adam`` state ``{"mu", "nu", "t"}``, the moments
    laid out as :func:`from_jax` lays out the parameters."""
    adam = next((s for s in opt_state_np if hasattr(s, "mu") and hasattr(s, "nu")), None)
    if adam is None:
        raise ValueError("no Adam moments (an entry with .mu and .nu) in the optimizer state")
    mu, _ = from_jax(adam.mu, device=device)
    nu, _ = from_jax(adam.nu, device=device)
    return {"mu": mu, "nu": nu, "t": int(np.asarray(adam.count))}


def adam_to_jax(state: dict) -> dict:
    """Inverse of :func:`adam_from_jax`: ``{"count", "mu", "nu"}`` with numpy
    leaves in the JAX layout (the caller rebuilds the optax state from them)."""
    return {"count": int(state["t"]), "mu": to_jax(state["mu"])[0], "nu": to_jax(state["nu"])[0]}


def flat_from_jax(flat_np: dict, *, dtype=None, device="cpu") -> dict:
    """The JAX fused inner scan's flat ``PKEYS`` dict (numpy leaves, conv
    weights in HWIO matrix form) -> the port's flat dict of tensors, same
    keys, shapes and layout; ``dtype`` optionally casts (the carry dtype)."""
    from mft_tpu_torch.kernels.fused_inner_scan import PKEYS

    if set(flat_np) != set(PKEYS):
        raise ValueError(f"expected the keys {PKEYS}, got {sorted(flat_np)}")
    out = {k: _tensor(np.asarray(flat_np[k], dtype=np.float32), device) for k in PKEYS}
    return {k: v.to(dtype) for k, v in out.items()} if dtype is not None else out


def flat_to_jax(flat: dict) -> dict:
    """Inverse of :func:`flat_from_jax`: f32 numpy leaves in the JAX layout."""
    return {k: np.ascontiguousarray(v.detach().float().cpu().numpy()) for k, v in flat.items()}


# --------------------------------------------------------------------------
# reference state dicts
# --------------------------------------------------------------------------


class _Reader:
    """Records consumed keys so a load can prove it mapped every tensor."""

    def __init__(self, sd: Dict[str, torch.Tensor], device, dtype=torch.float32):
        self.sd, self.device, self.dtype, self.consumed = sd, device, dtype, set()

    def __contains__(self, k):
        return k in self.sd

    def __getitem__(self, k) -> torch.Tensor:
        if k not in self.sd:
            raise KeyError(f"checkpoint is missing key {k!r} (have {len(self.sd)} keys, e.g. {sorted(self.sd)[:3]})")
        self.consumed.add(k)
        return torch.as_tensor(self.sd[k]).to(self.device, self.dtype)

    def unconsumed(self):
        return sorted(k for k in self.sd if k not in self.consumed and not k.endswith("num_batches_tracked"))


def _lin(r, pre):
    return {"w": r[f"{pre}.weight"], "b": r[f"{pre}.bias"]}


def _conv1x1(r, pre):
    return {"w": r[f"{pre}.weight"][:, :, 0, 0].contiguous(), "b": r[f"{pre}.bias"]}


def _bn(r, pre):
    return {"scale": r[f"{pre}.weight"], "bias": r[f"{pre}.bias"]}


def _bn_run(r, pre):
    return {"mean": r[f"{pre}.running_mean"], "var": r[f"{pre}.running_var"]}


def _wcompute(r, pre):
    p = {}
    for i in range(1, 5):
        p[f"conv{i}"] = _conv1x1(r, f"{pre}.conv2d_{i}")
        p[f"bn{i}"] = _bn(r, f"{pre}.bn_{i}")
    p["conv_last"] = _conv1x1(r, f"{pre}.conv2d_last")
    return p


def from_state_dict(sd: Dict[str, torch.Tensor], cfg: ResNetCfg, *, device="cpu", strict: bool = True,
                    dtype=torch.float32) -> Tuple[dict, dict]:
    """Reference state dict -> ``(params, stats)`` of ``dtype`` with
    ``params["feature"]`` and, when present, ``params["fc"]``/``params["gnn"]``
    (GnnNet) and ``params["classifier"]`` (baseline pretraining); a ProtoNet
    state is the feature trunk alone.  Trunk blocks start at index 4 after
    [conv1, bn1, relu, pool] (backbone.py:416-424)."""
    r = _Reader(sd, device, dtype)
    feature = {"stem_conv": r["feature.trunk.0.weight"], "stem_bn": _bn(r, "feature.trunk.1"), "stages": []}
    stats = {"stem_bn": _bn_run(r, "feature.trunk.1"), "stages": []}
    idx = 4
    for n in cfg.stage_sizes:
        sp, ss = [], []
        for _ in range(n):
            pre = f"feature.trunk.{idx}"
            blk = {"conv1": r[f"{pre}.C1.weight"], "bn1": _bn(r, f"{pre}.BN1"),
                   "conv2": r[f"{pre}.C2.weight"], "bn2": _bn(r, f"{pre}.BN2")}
            bs = {"bn1": _bn_run(r, f"{pre}.BN1"), "bn2": _bn_run(r, f"{pre}.BN2")}
            if f"{pre}.shortcut.weight" in r:
                blk["conv_sc"] = r[f"{pre}.shortcut.weight"]
                blk["bn_sc"] = _bn(r, f"{pre}.BNshortcut")
                bs["bn_sc"] = _bn_run(r, f"{pre}.BNshortcut")
            sp.append(blk)
            ss.append(bs)
            idx += 1
        feature["stages"].append(sp)
        stats["stages"].append(ss)
    params = {"feature": feature, **_heads(r)}
    _check_consumed(r, strict)
    return params, stats


def _heads(r) -> dict:
    """The heads a state dict holds: GnnNet's ``fc``/``gnn``, the baseline's
    ``classifier``, DampNet's recovery network (``W_R``, ``V_R``,
    ``W_R_std``, ``V_R_std``, ``layer{1,2,3}[_add]``; the Bilinear weight
    ``[out, in1, in2]`` as it is; every variant has these names,
    mft_tpu/utils/torch_import.py:219-230)."""
    params = {}
    if "fc.0.weight" in r:
        params["fc"] = {"linear": _lin(r, "fc.0"), "bn": _bn(r, "fc.1")}
        gnn, i = {"layers": []}, 0
        while f"gnn.layer_w{i}.conv2d_1.weight" in r:
            gnn["layers"].append({"w": _wcompute(r, f"gnn.layer_w{i}"),
                                  "l": {"fc": _lin(r, f"gnn.layer_l{i}.fc"), "bn": _bn(r, f"gnn.layer_l{i}.bn")}})
            i += 1
        gnn["w_last"] = _wcompute(r, "gnn.w_comp_last")
        gnn["l_last"] = {"fc": _lin(r, "gnn.layer_last.fc")}
        params["gnn"] = gnn
    if "classifier.weight" in r:
        params["classifier"] = _lin(r, "classifier")
    if "W_R.weight" in r:
        for name in DAMPNET_MODULES:
            params[name] = r[f"{name}.weight"] if name.startswith("W_R") else _lin(r, name)
    return params


def _check_consumed(r, strict: bool):
    left = r.unconsumed()
    if left and strict:
        raise ValueError(f"{len(left)} checkpoint tensors were not mapped (first 10: {left[:10]}); wrong --model?")


def heads_from_state_dict(sd: Dict[str, torch.Tensor], *, device="cpu", strict: bool = True,
                          dtype=torch.float32) -> dict:
    """The heads of a state dict without a backbone (``fc.*``, ``gnn.*``,
    ``classifier.*``, DampNet's modules), as :func:`from_state_dict` maps them."""
    r = _Reader(sd, device, dtype)
    params = _heads(r)
    _check_consumed(r, strict)
    return params


def _put_lin(out, pre, p):
    out[f"{pre}.weight"] = p["w"]
    out[f"{pre}.bias"] = p["b"]


def _put_conv1x1(out, pre, p):
    out[f"{pre}.weight"] = p["w"][:, :, None, None]
    out[f"{pre}.bias"] = p["b"]


def _put_bn(out, pre, pair, run=None):
    out[f"{pre}.weight"] = pair["scale"]
    out[f"{pre}.bias"] = pair["bias"]
    if run is not None:
        out[f"{pre}.running_mean"] = run["mean"]
        out[f"{pre}.running_var"] = run["var"]
        out[f"{pre}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def to_state_dict(params: dict, stats: dict) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`from_state_dict` (CPU tensors); without
    ``params["feature"]``, the inverse of :func:`heads_from_state_dict`."""
    out: Dict[str, torch.Tensor] = {}
    if "feature" in params:
        feat = params["feature"]
        out["feature.trunk.0.weight"] = feat["stem_conv"]
        _put_bn(out, "feature.trunk.1", feat["stem_bn"], stats["stem_bn"])
        idx = 4
        for sp, ss in zip(feat["stages"], stats["stages"]):
            for blk, bs in zip(sp, ss):
                pre = f"feature.trunk.{idx}"
                out[f"{pre}.C1.weight"] = blk["conv1"]
                _put_bn(out, f"{pre}.BN1", blk["bn1"], bs["bn1"])
                out[f"{pre}.C2.weight"] = blk["conv2"]
                _put_bn(out, f"{pre}.BN2", blk["bn2"], bs["bn2"])
                if "conv_sc" in blk:
                    out[f"{pre}.shortcut.weight"] = blk["conv_sc"]
                    _put_bn(out, f"{pre}.BNshortcut", blk["bn_sc"], bs["bn_sc"])
                idx += 1
    if "fc" in params:
        _put_lin(out, "fc.0", params["fc"]["linear"])
        _put_bn(out, "fc.1", params["fc"]["bn"])
        gnn = params["gnn"]
        names = [(f"gnn.layer_w{i}", f"gnn.layer_l{i}", layer["w"], layer["l"]) for i, layer in enumerate(gnn["layers"])]
        names.append(("gnn.w_comp_last", "gnn.layer_last", gnn["w_last"], gnn["l_last"]))
        for wpre, lpre, w, l in names:
            for j in range(1, 5):
                _put_conv1x1(out, f"{wpre}.conv2d_{j}", w[f"conv{j}"])
                _put_bn(out, f"{wpre}.bn_{j}", w[f"bn{j}"])
            _put_conv1x1(out, f"{wpre}.conv2d_last", w["conv_last"])
            _put_lin(out, f"{lpre}.fc", l["fc"])
            if "bn" in l:
                _put_bn(out, f"{lpre}.bn", l["bn"])
    if "classifier" in params:
        _put_lin(out, "classifier", params["classifier"])
    if "W_R" in params:
        for name in DAMPNET_MODULES:
            if name.startswith("W_R"):
                out[f"{name}.weight"] = params[name]
            else:
                _put_lin(out, name, params[name])
    return {k: v.detach().cpu().contiguous() for k, v in out.items()}


def save_tar(path: str, epoch: int, sd: Dict[str, torch.Tensor]) -> None:
    """Write a reference-format ``{'epoch', 'state'}`` file."""
    torch.save({"epoch": int(epoch), "state": sd}, path)


def load_tar(path: str) -> Tuple[int, Dict[str, torch.Tensor]]:
    """Read a reference ``<epoch>.tar`` -> ``(epoch, state dict)``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or "state" not in blob:
        raise ValueError(f"{path} is not a reference checkpoint (expected {{'epoch', 'state'}})")
    return int(blob.get("epoch", 0)), blob["state"]
