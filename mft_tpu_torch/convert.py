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
  ``mft_tpu/utils/torch_import.py``, kept here as a copy) for the
  ``SimpleBlock`` backbones (ResNet10_FW's noise strengths and the stem-less
  ResNet_fin included) and the heads; :func:`heads_from_state_dict` maps a state dict without a
  backbone.  DampNet's prototypes and stores are not in a reference state
  dict (plain attributes there): ``utils/checkpoint.py`` keeps them beside it; :func:`load_tar` / :func:`save_tar` read and write the
  ``{'epoch', 'state'}`` files that the reference's train.py and
  ``mft_tpu.cli.export_ckpt`` write.
* The raw flax state dicts of a JAX ``.ckpt`` file (``utils/flax_msgpack.py``
  reads them): :func:`adam_from_state_dict` / :func:`adam_to_state_dict`
  carry the optimizer state (``torch_adam``'s chain and ``freeze_masked``'s
  ``multi_transform``) in that form, :func:`sorted_state_dict` lays a tree out
  as the JAX package's ``save_checkpoint`` writes it, and
  :func:`damp_state_from_jax` / :func:`damp_state_to_jax` carry DampNet's
  state by name.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from mft_tpu_torch.models.backbone import ResNetCfg
from mft_tpu_torch.utils.flax_msgpack import listify

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


def _drop_masked(tree):
    """A moment tree of a masked optax state without its frozen entries:
    optax keeps an empty ``MaskedNode`` tuple where a leaf is frozen, which
    a flax state dict (a ``.ckpt`` file) holds as the empty map ``{}``."""
    if isinstance(tree, dict):
        return {k: _drop_masked(v) for k, v in tree.items() if not (isinstance(v, (tuple, dict)) and len(v) == 0)}
    if isinstance(tree, list):
        return [_drop_masked(v) for v in tree]
    return tree


def adam_from_jax(opt_state_np, *, device="cpu") -> dict:
    """The JAX ``torch_adam`` state (the optax chain's tuple, whose
    ``ScaleByAdamState`` holds ``count``, ``mu`` and ``nu``; numpy leaves)
    -> the port's ``torch_adam`` state ``{"mu", "nu", "t"}``, the moments
    laid out as :func:`from_jax` lays out the parameters.  The state of
    ``freeze_masked(torch_adam)`` (an ``optax.multi_transform`` whose
    ``'train'`` group holds the chain) maps to the port's
    ``freeze_masked`` state: the moments without the frozen entries."""
    if hasattr(opt_state_np, "inner_states"):
        opt_state_np = opt_state_np.inner_states["train"].inner_state
    adam = next((s for s in opt_state_np if hasattr(s, "mu") and hasattr(s, "nu")), None)
    if adam is None:
        raise ValueError("no Adam moments (an entry with .mu and .nu) in the optimizer state")
    mu, _ = from_jax(_drop_masked(adam.mu), device=device)
    nu, _ = from_jax(_drop_masked(adam.nu), device=device)
    return {"mu": mu, "nu": nu, "t": int(np.asarray(adam.count))}


def adam_to_jax(state: dict) -> dict:
    """Inverse of :func:`adam_from_jax`: ``{"count", "mu", "nu"}`` with numpy
    leaves in the JAX layout (the caller rebuilds the optax state from them)."""
    return {"count": int(state["t"]), "mu": to_jax(state["mu"])[0], "nu": to_jax(state["nu"])[0]}


# --------------------------------------------------------------------------
# raw flax state dicts (what a JAX ``.ckpt`` file holds)
# --------------------------------------------------------------------------


def adam_from_state_dict(opt_sd: dict, *, device="cpu") -> dict:
    """The raw flax state dict of the JAX driver's optimizer (a ``.ckpt``
    file's ``opt_state``) -> the port's ``{"mu", "nu", "t"}``, equal to
    :func:`adam_from_jax` of the same state.  ``torch_adam``'s chain is
    ``{"0": {"count", "mu", "nu"}, "1": {}}``; ``freeze_masked`` wraps it as
    ``{"inner_states": {"freeze": {"inner_state": {}}, "train":
    {"inner_state": <the chain>}}}`` with each frozen moment ``{}``."""
    if "inner_states" in opt_sd:
        opt_sd = opt_sd["inner_states"]["train"]["inner_state"]
    adam = next((opt_sd[k] for k in sorted(opt_sd, key=int) if {"count", "mu", "nu"} <= set(opt_sd[k])), None)
    if adam is None:
        raise ValueError(f"no Adam moments (an entry with count, mu and nu) in the optimizer state {sorted(opt_sd)}")
    mu, _ = from_jax(_drop_masked(listify(adam["mu"])), device=device)
    nu, _ = from_jax(_drop_masked(listify(adam["nu"])), device=device)
    return {"mu": mu, "nu": nu, "t": int(np.asarray(adam["count"]))}


def _keyed(tree, pre=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _keyed(sub, pre + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _keyed(sub, pre + (i,)).items()}
    return {pre: tree}


def _state_dict_like(params, flat: dict, pre=()):
    """``params``' structure as a flax state dict (lists -> ``{"0": ...}``)
    with the leaves of ``flat`` (keyed by path); a leaf ``flat`` lacks is
    ``{}``, optax's ``MaskedNode``."""
    if isinstance(params, dict):
        return {k: _state_dict_like(v, flat, pre + (k,)) for k, v in sorted(params.items())}
    if isinstance(params, (list, tuple)):
        return {str(i): _state_dict_like(v, flat, pre + (i,)) for i, v in enumerate(params)}
    return flat.get(pre, {})


def sorted_state_dict(tree) -> dict:
    """``tree`` as the flax state dict that the JAX package's
    ``save_checkpoint`` writes: lists -> ``{"0": ...}``, dict keys sorted (as
    ``jax.tree.map`` sorts them)."""
    return _state_dict_like(tree, _keyed(tree))


def adam_to_state_dict(state: dict, params: dict) -> dict:
    """Inverse of :func:`adam_from_state_dict`: the port's Adam state over
    ``params`` (numpy leaves in the JAX layout, dict keys sorted as
    ``jax.tree.map`` sorts them).  Where ``params`` has leaves the moments
    lack (``freeze_masked``'s frozen ones), the ``freeze_masked`` layout."""
    mu, nu = (_keyed(to_jax(state[k])[0]) for k in ("mu", "nu"))
    chain = {"0": {"count": np.asarray(int(state["t"]), np.int32), "mu": _state_dict_like(params, mu),
                   "nu": _state_dict_like(params, nu)}, "1": {}}
    if set(mu) == set(_keyed(params)):
        return chain
    return {"inner_states": {"freeze": {"inner_state": {}}, "train": {"inner_state": chain}}}


def damp_state_from_jax(state_np: dict, *, device="cpu") -> dict:
    """A JAX DampNet state (numpy leaves) -> the port's, by name, dtypes kept
    (``initialized`` bool, ``count`` int32)."""
    return {k: _tensor(v, device) for k, v in state_np.items()}


def damp_state_to_jax(state: dict) -> dict:
    """Inverse of :func:`damp_state_from_jax`."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


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
    [conv1, bn1, relu, pool] (backbone.py:416-424), or at 0 without a stem
    (ResNet_fin, :487-494).  A ResNet10_FW block's noise strengths are the
    ``(1, C, 1, 1)`` ``BN2.gamma/beta`` and ``BNshortcut.gamma/beta``
    (FeatureWiseTransformation2d_fw, :324-325) -> ``fwt_*`` of shape
    ``(C,)``.  The bottleneck block has no state-dict mapping, as in JAX."""
    r = _Reader(sd, device, dtype)
    feature, stats, idx = {"stages": []}, {"stages": []}, 0
    if cfg.stem:
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
            if cfg.block == "fwt":
                for name, key in _FWT_KEYS:
                    if name.endswith("2") or "conv_sc" in blk:
                        blk[name] = r[f"{pre}.{key}"].reshape(-1)
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


#: the FWT leaves and their reference state-dict keys (after ``feature.trunk.<i>.``)
_FWT_KEYS = (("fwt_gamma2", "BN2.gamma"), ("fwt_beta2", "BN2.beta"), ("fwt_gamma_sc", "BNshortcut.gamma"),
             ("fwt_beta_sc", "BNshortcut.beta"))


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
        feat, idx = params["feature"], 0
        if "stem_conv" in feat:
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
                for name, key in _FWT_KEYS:
                    if name in blk:
                        out[f"{pre}.{key}"] = blk[name].reshape(1, -1, 1, 1)
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
