"""The networks of the eval, read straight from the reference repo's state
dict layout (``feature.trunk.*``, ``fc.*``, ``gnn.*``, DampNet's ``W_R`` ...):
the ResNet10 trunk and final block with batch-statistics BN, the GnnNet
head (reference ``methods/gnn.py``: ``Wcompute``, ``Gconv``, ``GNN_nl``)
and DampNet's recovery network (``methods/dampnet_full_class.py``).

Every product (convolution, linear, bilinear, the graph's edge MLP) takes
its operands through :class:`Precision`: float32 for the reference, and
for the control each operand rounded to float8 e4m3 with a per-tensor
scale (the step below the bfloat16 the configurations state; the
adaptation's carried parameters are rounded by it too,
``episode.adapt``); the gradient passes the rounding unchanged."""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


class Precision:
    """``"float32"`` or ``"float8"`` products."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
        q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (q - t).detach()


def bn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Batch-statistics BN over every dim but 1 (channels), the biased
    variance, per contiguous group of rows."""
    shape = x.shape
    g = x.reshape((groups, shape[0] // groups) + tuple(shape[1:]))
    dims = (1,) + tuple(range(3, g.dim()))
    mean = g.mean(dim=dims, keepdim=True)
    var = (g - mean).square().mean(dim=dims, keepdim=True)
    view = (1, 1, -1) + (1,) * (g.dim() - 3)
    y = (g - mean) / torch.sqrt(var + BN_EPS) * scale.reshape(view) + bias.reshape(view)
    return y.reshape(shape)


def bn_last(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Batch-statistics BN over every dim but the last."""
    flat = x.reshape(-1, x.shape[-1])
    mean = flat.mean(dim=0)
    var = (flat - mean).square().mean(dim=0)
    return (x - mean) / torch.sqrt(var + BN_EPS) * scale + bias


class ResNet10:
    """The backbone of a state dict: ``feature.trunk.0`` the stem conv,
    ``.1`` its BN, then four ``SimpleBlock``s at ``.4`` to ``.7``."""

    BLOCKS = (4, 5, 6, 7)

    def __init__(self, sd: dict, prec: Precision):
        self.sd, self.prec = sd, prec

    def block_params(self, i: int) -> dict:
        pre = f"feature.trunk.{i}."
        return {k[len(pre):]: v for k, v in self.sd.items()
                if k.startswith(pre) and not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}

    def conv(self, x, w, stride, pad):
        return F.conv2d(self.prec(x), self.prec(w), stride=stride, padding=pad)

    def block(self, p: dict, x, stride: int, groups: int = 1):
        out = torch.relu(bn(self.conv(x, p["C1.weight"], stride, 1), p["BN1.weight"], p["BN1.bias"], groups))
        out = bn(self.conv(out, p["C2.weight"], 1, 1), p["BN2.weight"], p["BN2.bias"], groups)
        if "shortcut.weight" in p:
            short = bn(self.conv(x, p["shortcut.weight"], stride, 0), p["BNshortcut.weight"], p["BNshortcut.bias"],
                       groups)
        else:
            short = x
        return torch.relu(out + short)

    def trunk(self, x, groups: int = 1):
        """Stem and every block but the last -> ``[N, 256, h, h]``; batch
        statistics per contiguous group of ``N / groups`` images."""
        sd = self.sd
        x = bn(self.conv(x, sd["feature.trunk.0.weight"], 2, 3), sd["feature.trunk.1.weight"],
               sd["feature.trunk.1.bias"], groups)
        x = F.max_pool2d(torch.relu(x), 3, 2, 1)
        for k, i in enumerate(self.BLOCKS[:-1]):
            x = self.block(self.block_params(i), x, 1 if k == 0 else 2, groups)
        return x

    def final(self, p: dict, fmap, groups: int = 1):
        """The final block ``p`` (adapted or not) and the global pool -> ``[N, 512]``."""
        return self.block(p, fmap, 2, groups).mean(dim=(2, 3))


def linear(prec: Precision, x, w, b=None):
    y = torch.matmul(prec(x), prec(w).t())
    return y if b is None else y + b


class GnnNetHead:
    """``fc`` (Linear 512 -> 128, BN1d) and ``gnn`` (two ``Wcompute`` +
    ``Gconv`` layers with dense concatenation, then the last pair)."""

    def __init__(self, sd: dict, prec: Precision):
        self.sd, self.prec = sd, prec
        self.n_layers = sum(1 for k in sd if k.startswith("gnn.layer_w") and k.endswith("conv2d_1.weight"))

    def _lin(self, x, pre):
        return linear(self.prec, x, self.sd[f"{pre}.weight"].reshape(self.sd[f"{pre}.weight"].shape[0], -1),
                      self.sd[f"{pre}.bias"])

    def wcompute(self, pre: str, x):
        """``x [B, N, F]`` -> ``[B, N, N, 2]``: the identity and the
        row-softmax of the learned adjacency, self-edges masked."""
        h = (x[:, :, None, :] - x[:, None, :, :]).abs()
        for i in range(1, 5):
            h = self._lin(h, f"{pre}.conv2d_{i}")
            h = F.leaky_relu(bn_last(h, self.sd[f"{pre}.bn_{i}.weight"], self.sd[f"{pre}.bn_{i}.bias"]), 0.01)
        w = self._lin(h, f"{pre}.conv2d_last")[..., 0]
        eye = torch.eye(x.shape[1], device=x.device, dtype=w.dtype)
        w = torch.softmax(w - eye * 1e8, dim=2)
        return torch.stack([eye.expand_as(w), w], dim=-1)

    def gconv(self, pre: str, ops, x, with_bn: bool):
        b, n, f = x.shape
        prod = torch.einsum("bijk,bjf->bikf", ops, x).reshape(b, n, -1)
        h = self._lin(prod, f"{pre}.fc")
        if with_bn:
            h = bn_last(h, self.sd[f"{pre}.bn.weight"], self.sd[f"{pre}.bn.bias"])
        return h

    def scores(self, feats, n_way: int, n_support: int, n_query: int):
        """Episode features ``[n_way, s+q, 512]`` (support first) -> logits
        ``[n_way * n_query, n_way]``, class-major.  Query graph ``t`` holds,
        for each class, its supports then that class's ``t``-th query."""
        z = linear(self.prec, feats.reshape(-1, feats.shape[-1]), self.sd["fc.0.weight"], self.sd["fc.0.bias"])
        z = bn_last(z, self.sd["fc.1.weight"], self.sd["fc.1.bias"]).reshape(n_way, n_support + n_query, -1)
        zs, zq = z[:, :n_support], z[:, n_support:]
        nodes = torch.cat([zs[None].expand(n_query, -1, -1, -1), zq.transpose(0, 1)[:, :, None]], dim=2)
        nodes = nodes.reshape(n_query, n_way * (n_support + 1), -1)
        eye = torch.eye(n_way, device=feats.device)
        labels = torch.cat([eye[:, None].expand(-1, n_support, -1), torch.zeros(n_way, 1, n_way, device=feats.device)],
                           dim=1).reshape(-1, n_way)
        x = torch.cat([nodes, labels[None].expand(n_query, -1, -1)], dim=2)
        for i in range(self.n_layers):
            ops = self.wcompute(f"gnn.layer_w{i}", x)
            x = torch.cat([x, F.leaky_relu(self.gconv(f"gnn.layer_l{i}", ops, x, True), 0.01)], dim=2)
        out = self.gconv("gnn.layer_last", self.wcompute("gnn.w_comp_last", x), x, False)
        out = out.reshape(n_query, n_way, n_support + 1, n_way)[:, :, -1]
        return out.transpose(0, 1).reshape(n_way * n_query, n_way)


class DampNetRecovery:
    """The domain-shift recovery of ``dampnet_full_class``: the episode's
    support mean and the std over its per-class support means, each
    compared with the source prototype by an NTN (``Bilinear(proto, x) +
    Linear([proto; x])``), ``tanh``, two 3-layer MLPs -> ``(mult, add)``;
    ``recovered = feats * mult + add``."""

    def __init__(self, sd: dict, prec: Precision):
        self.sd, self.prec = sd, prec

    def _ntn(self, w, v, proto, x):
        bil = torch.einsum("i,kij,j->k", self.prec(proto), self.prec(w), self.prec(x))
        return bil + linear(self.prec, torch.cat([proto, x]), self.sd[f"{v}.weight"], self.sd[f"{v}.bias"])

    def _mlp(self, h, suffix):
        for i in (1, 2):
            h = torch.relu(linear(self.prec, h, self.sd[f"layer{i}{suffix}.weight"], self.sd[f"layer{i}{suffix}.bias"]))
        return linear(self.prec, h, self.sd[f"layer3{suffix}.weight"], self.sd[f"layer3{suffix}.bias"])

    def recover(self, feats, n_support: int, proto_mean, proto_std):
        support = feats[:, :n_support]
        x_mean = support.mean(dim=(0, 1))
        x_std = support.mean(dim=1).std(dim=0, correction=1)
        h = torch.tanh(torch.cat([self._ntn(self.sd["W_R.weight"], "V_R", proto_mean, x_mean),
                                  self._ntn(self.sd["W_R_std.weight"], "V_R_std", proto_std, x_std)]))
        return feats * self._mlp(h, "") + self._mlp(h, "_add")
