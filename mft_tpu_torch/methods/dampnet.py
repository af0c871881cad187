"""DampNet: the GNN meta-learner with a domain-shift recovery network (port
of ``mft_tpu/methods/dampnet.py``; reference methods/dampnet.py,
dampnet_full.py, dampnet_full_class.py).

* Per statistic (mean, std) a "neural tensor network" compares the source
  prototype with the episode's statistic, ``NTN(a, b) = Bilinear(a, b) +
  Linear([a; b])`` (dampnet_full_class.py:33-37); two 3-layer MLPs map
  ``tanh([NTN_mean; NTN_std])`` to per-feature corrections, ``recovered =
  x * mult + add`` (:179-198); the fc projector and the GNN then score.
* Source prototypes (``proto_mean``, ``proto_std``) are explicit state, set
  from a bank of source features (``get_all_feat``, :90-95).
* Training alternates by call parity: corrupt the features with a random
  diagonal + t-distributed matrix and train the recovery net with
  ``fc[0]`` frozen, or recover the clean features (:145-261), an explicit
  ``mode`` here.  The "_class" statistic is the std over the per-class
  support means (:111-116); "_full" takes it over all support features.
* The prototype variant (``--method dampnet``, reference methods/dampnet.py):
  NTN width 500, MLPs 1000->900->800->feat, a rolling ``store_len``-episode
  store whose statistics drive the training-time recovery, mean-centered and
  L2-normalized projections before the GNN, fixed corruption constants with
  an unscaled bias, no head freezing, and the plain/odd-corrupt/even-recover
  schedule from call count 150 (:24-26,54,95-166).

The corruption is split in two: :func:`draw_corruption` draws from a
``torch.Generator`` (on the CPU), :func:`apply_corruption` is a pure function
of those draws, so a test can feed it draws made elsewhere.  Its scatters
write only the selected lanes, and a duplicate index is written once with
the same value (the reference's buffered numpy ``+=``).

The GNN of every variant takes the plain edge op: ``DampNetCfg.gnn_cfg``
does not pass ``use_pallas``, as in the JAX package.

Episode lanes: the eval's scoring (:func:`dampnet_scores` outside the
'corrupt' mode, :func:`recovered_projection`) also takes ``[E, n_way, slots,
feat]``, ``E`` episodes in one call: the statistics and the recovery network
per lane, the lanes' graphs in one GNN pass with per-lane BN statistics
(``jax.vmap`` of the one-episode functions in the JAX package).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mft_tpu_torch.core.episode import EpisodeSpec, query_labels
from mft_tpu_torch.methods.baseline import ce_loss
from mft_tpu_torch.methods.gnnnet import GnnNetCfg, gnn_scores, init_head
from mft_tpu_torch.ops.convpool import linear
from mft_tpu_torch.ops.initializers import torch_linear
from mft_tpu_torch.ops.norm import batch_norm

#: the reference's call_count at construction (dampnet.py:54, dampnet_full_class.py:56)
CALL_COUNT0 = 150


class DampNetCfg(NamedTuple):
    feat_dim: int = 512
    n_way: int = 5
    n_support: int = 5
    gnn_dim: int = 128
    gnn_nf: int = 96
    ntn_dim: int = 300  # 500 in the prototype variant
    mlp_hidden: int = 500
    #: second MLP hidden width; None = mlp_hidden (the prototype's is 800)
    mlp_hidden2: Optional[int] = None
    stat: str = "class"  # 'class' (dampnet_full_class) | 'support' (dampnet_full, prototype)
    variant: str = "full"  # 'full' (dampnet_full[_class]) | 'prototype' (dampnet)
    store_len: int = 20  # rolling store length (dampnet.py:24)

    @property
    def h2(self) -> int:
        return self.mlp_hidden if self.mlp_hidden2 is None else self.mlp_hidden2

    @property
    def gnn_cfg(self) -> GnnNetCfg:
        return GnnNetCfg(self.feat_dim, self.n_way, self.n_support, self.gnn_dim, self.gnn_nf)


def prototype_cfg(feat_dim: int = 512, n_way: int = 5, n_support: int = 5) -> DampNetCfg:
    """The ``--method dampnet`` prototype variant (reference methods/dampnet.py:
    NTN width 500 (:32-36), MLPs 1000->900->800->feat (:40-45), support-stat
    std, rolling 20-episode store)."""
    return DampNetCfg(feat_dim=feat_dim, n_way=n_way, n_support=n_support, ntn_dim=500, mlp_hidden=900,
                      mlp_hidden2=800, stat="support", variant="prototype")


def method_cfg(method: str, feat_dim: int, n_way: int, n_support: int) -> DampNetCfg:
    """The configuration of ``--method dampnet|dampnet_full|dampnet_full_class``."""
    if method == "dampnet":
        return prototype_cfg(feat_dim, n_way, n_support)
    if method not in ("dampnet_full", "dampnet_full_class"):
        raise ValueError(f"not a DampNet method: {method!r}")
    return DampNetCfg(feat_dim=feat_dim, n_way=n_way, n_support=n_support,
                      stat="class" if method == "dampnet_full_class" else "support")


def bilinear(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out_k = a^T W_k b`` (``torch.nn.Bilinear`` without bias), summed in
    at least f32; ``b [..., f]`` (episode lanes) -> ``[..., k]``."""
    acc = torch.promote_types(a.dtype, torch.float32)
    return torch.einsum("i,kij,...j->...k", a.to(acc), w.to(acc), b.to(acc)).to(a.dtype)


def fresh_state(cfg: DampNetCfg, *, dtype=torch.float32, device="cpu") -> dict:
    """The state of a new model: zero prototypes, ``initialized`` False; the
    prototype variant adds its zeroed rolling stores and ``count`` = 150."""
    f = cfg.feat_dim
    state = {
        "proto_mean": torch.zeros(f, dtype=dtype, device=device),
        "proto_std": torch.zeros(f, dtype=dtype, device=device),
        "initialized": torch.zeros((), dtype=torch.bool, device=device),
    }
    if cfg.variant == "prototype":
        state["store_mean"] = torch.zeros(cfg.store_len, f, dtype=dtype, device=device)
        state["store_std"] = torch.zeros(cfg.store_len, cfg.n_way * cfg.n_support, f, dtype=dtype, device=device)
        state["count"] = torch.full((), CALL_COUNT0, dtype=torch.int32, device=device)
    return state


def init_dampnet(gen: torch.Generator, cfg: DampNetCfg, *, dtype=torch.float32, device="cpu"):
    """``(params, state)``: fc + GNN, then the recovery network, drawn from
    ``gen`` with torch's default initializers (``Bilinear``: U(-1/sqrt(f),
    1/sqrt(f)) over ``[out, f, f]``)."""
    f, n, h, h2 = cfg.feat_dim, cfg.ntn_dim, cfg.mlp_hidden, cfg.h2
    kw = dict(dtype=dtype, device=device)

    def bil():
        w = (torch.rand((n, f, f), generator=gen) * 2.0 - 1.0) / math.sqrt(f)
        return w.to(**kw)

    params = init_head(gen, cfg.gnn_cfg, **kw)
    params["W_R"] = bil()
    params["V_R"] = torch_linear(gen, 2 * f, n, **kw)
    params["W_R_std"] = bil()
    params["V_R_std"] = torch_linear(gen, 2 * f, n, **kw)
    for suffix in ("", "_add"):
        params[f"layer1{suffix}"] = torch_linear(gen, 2 * n, h, **kw)
        params[f"layer2{suffix}"] = torch_linear(gen, h, h2, **kw)
        params[f"layer3{suffix}"] = torch_linear(gen, h2, f, **kw)
    return params, fresh_state(cfg, **kw)


def update_prototypes(state: dict, all_feats: torch.Tensor) -> dict:
    """``get_all_feat``: prototypes = mean and unbiased std over a
    ``[N, feat]`` source bank (dampnet_full_class.py:90-95)."""
    return {**state, "proto_mean": all_feats.mean(dim=0), "proto_std": all_feats.std(dim=0, correction=1),
            "initialized": torch.ones((), dtype=torch.bool, device=all_feats.device)}


def episode_stats(feats_episode: torch.Tensor, cfg: DampNetCfg):
    """``(x_mean, x_std)`` of the support features ``[..., n_way, s+q, f]``
    (``[..., f]`` each): 'class' takes the std over the per-class support
    means, 'support' over every support feature (both unbiased)."""
    support = feats_episode[..., : cfg.n_support, :]
    x_mean = support.mean(dim=(-3, -2))
    if cfg.stat == "class":
        return x_mean, support.mean(dim=-2).std(dim=-2, correction=1)
    flat = support.reshape(tuple(support.shape[:-3]) + (-1, support.shape[-1]))
    return x_mean, flat.std(dim=-2, correction=1)


def _mlp(params: dict, h: torch.Tensor, suffix: str) -> torch.Tensor:
    h = torch.relu(linear(h, params[f"layer1{suffix}"]))
    h = torch.relu(linear(h, params[f"layer2{suffix}"]))
    return linear(h, params[f"layer3{suffix}"])


def recovery(params: dict, state: dict, x_mean: torch.Tensor, x_std: torch.Tensor):
    """``(mult, add)``: the NTN comparisons of the episode's statistics with
    the source prototypes, through the two MLPs (dampnet_full_class.py:179-198).
    ``x_mean``, ``x_std`` ``[..., f]`` (a leading lane axis) -> ``[..., f]``."""
    pm, ps = state["proto_mean"], state["proto_std"]
    cat = lambda proto, x: torch.cat([proto.expand_as(x), x], dim=-1)
    ntn_m = bilinear(params["W_R"], pm, x_mean) + linear(cat(pm, x_mean), params["V_R"])
    ntn_s = bilinear(params["W_R_std"], ps, x_std) + linear(cat(ps, x_std), params["V_R_std"])
    h = torch.tanh(torch.cat([ntn_m, ntn_s], dim=-1))
    return _mlp(params, h, ""), _mlp(params, h, "_add")


def znorm_projection(z: torch.Tensor, n_support: int) -> torch.Tensor:
    """The prototype variant's projection (dampnet.py:125-129): subtract the
    mean of every support projection, then L2-normalize each node.
    ``z [n_way, slots, proj]``."""
    z = z - z[:, :n_support].mean(dim=(0, 1), keepdim=True)
    return z / torch.linalg.vector_norm(z, dim=2, keepdim=True)


def store_prototypes(state: dict):
    """Training-time prototypes of the prototype variant (dampnet.py:147-148,
    211-212): the mean of the stored episode means, and the unbiased std
    over every stored support feature."""
    f = state["store_mean"].shape[-1]
    return state["store_mean"].mean(dim=0), state["store_std"].reshape(-1, f).std(dim=0, correction=1)


def update_prototype_store(state: dict, banks: torch.Tensor) -> dict:
    """Rotate an episode batch of clean support banks ``[E, n_way*n_support,
    feat]`` into the rolling store at ``count % store_len`` and advance
    ``count`` by E (dampnet.py:133-136).  Keep E <= store_len: with more,
    two episodes of one batch would write one slot."""
    e, slots = banks.shape[0], state["store_mean"].shape[0]
    idx = (int(state["count"]) + torch.arange(e)) % slots
    idx = idx.to(banks.device)
    store_mean, store_std = state["store_mean"].clone(), state["store_std"].clone()
    store_mean[idx] = banks.mean(dim=1).to(store_mean.dtype)
    store_std[idx] = banks.to(store_std.dtype)
    return {**state, "store_mean": store_mean, "store_std": store_std, "count": state["count"] + e}


def training_mode(step_index: int, prototypes_initialized: bool) -> str:
    """The full family's call-parity schedule (dampnet_full_class.py:56,
    140-143: call_count starts at 150, one a training episode)."""
    if not prototypes_initialized:
        return "plain"
    return "corrupt" if (CALL_COUNT0 + step_index) % 2 == 1 else "recover"


def prototype_training_mode(count: int, e_batch: int = 1) -> str:
    """The prototype variant's schedule (dampnet.py:54,95-138): the first
    call (count 150) scores plainly, then corrupt and recover alternate per
    STEP: with an episode batch of E the count advances by E a step, so the
    parity of the raw count would never flip for an even E."""
    if count == CALL_COUNT0:
        return "plain"
    step = (count - CALL_COUNT0 + e_batch - 1) // max(e_batch, 1)
    return "corrupt" if step % 2 == 1 else "recover"


# --------------------------------------------------------------------------
# the corruption (dampnet_full_class.py:146-174, dampnet.py:140-166)
# --------------------------------------------------------------------------


def student_t5(gen: torch.Generator, shape) -> torch.Tensor:
    """Student-t with 5 degrees of freedom from ``gen`` (f32, on the CPU):
    ``Z / sqrt(sum_{i=1..5} Z_i^2 / 5)``, exact for an integer number of
    degrees of freedom (``torch.distributions.StudentT`` takes no generator)."""
    z = torch.randn(shape, generator=gen)
    chi2 = torch.randn((5,) + tuple(shape), generator=gen).square().sum(dim=0)
    return z / torch.sqrt(chi2 / 5.0)


def draw_corruption(gen: torch.Generator, feat_dim: int, *, prototype: bool) -> dict:
    """Every random draw of one corruption, on the CPU: ``perc``,
    ``perc_zeros`` and ``m_fac`` (pinned to 0.6 / 0.3 / 1.5 in the prototype
    variant), ``order`` (the permutation that places the diagonal's zeros),
    ``sign_perm`` (the permutation that places the bias's +1 / -1 offsets),
    ``ri`` and ``ri2`` (the selected lanes' row and column indices; only the
    first ``floor(perc * f)`` are used), ``rand_col`` (a column among the
    selected ones), ``t_sample [f, f]`` and ``t_bias [f]`` (t(5) draws,
    unscaled)."""
    f = feat_dim
    u = lambda lo, hi: float(torch.rand((), generator=gen) * (hi - lo) + lo)
    if prototype:
        perc, perc_zeros, m_fac = 0.6, 0.3, 1.5
    else:
        perc, perc_zeros, m_fac = u(0.1, 0.9), u(0.1, 0.9), u(1.5, 5.0)
    order = torch.randperm(f, generator=gen)
    ri = torch.randint(0, f, (f,), generator=gen)
    ri2 = torch.randint(0, f, (f,), generator=gen)
    rand_col = int(ri2[int(torch.randint(0, max(_floor32(perc, f), 1), (), generator=gen))])
    return {"perc": perc, "perc_zeros": perc_zeros, "m_fac": m_fac, "order": order, "ri": ri, "ri2": ri2,
            "rand_col": rand_col, "t_sample": student_t5(gen, (f, f)), "sign_perm": torch.randperm(f, generator=gen),
            "t_bias": student_t5(gen, (f,))}


def _floor32(p: float, f: int) -> int:
    """``floor(p * f)`` in f32, as the JAX package computes the counts."""
    return int(torch.floor(torch.tensor(p, dtype=torch.float32) * torch.tensor(float(f), dtype=torch.float32)))


def corruption_terms(draws: dict, feat_dim: int, *, dtype=torch.float32, device="cpu"):
    """``(matrix [f, f], bias [f], m_fac)`` of one corruption: the 0/1
    diagonal with ``floor(f * perc_zeros)`` zeros, plus ``m_fac * t`` at the
    selected ``(ri, ri2)`` entries; the bias ``-m_fac * t_sample[:, rand_col]
    + t_bias +- 1`` at the selected columns ``ri2``, zero elsewhere."""
    f = feat_dim
    d = {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in draws.items()}
    m_fac = d["m_fac"]
    diag = (d["order"] >= _floor32(d["perc_zeros"], f)).to(dtype)
    matrix = torch.diag(diag)
    n_sel = _floor32(d["perc"], f)
    ri, ri2 = d["ri"][:n_sel], d["ri2"][:n_sel]
    t_sample = m_fac * d["t_sample"].to(dtype)
    signs = torch.where(d["sign_perm"] < f - f // 2, 1.0, -1.0).to(dtype)
    t_bias = -t_sample[:, d["rand_col"]] + (d["t_bias"].to(dtype) + signs)
    # only the selected lanes write; a duplicate (row, column) or column
    # carries one value, so writing it once is the reference's buffered +=
    matrix = matrix.index_put((ri, ri2), matrix[ri, ri2] + t_sample[ri, ri2])
    bias = torch.zeros(f, dtype=dtype, device=device).index_put((ri2,), t_bias[ri2])
    return matrix, bias, m_fac


def apply_corruption(x: torch.Tensor, draws: dict, *, scale_bias: bool) -> torch.Tensor:
    """The corrupted features ``x @ matrix + bias`` of ``x [N, f]`` (no
    gradient): the full family scales the bias by ``m_fac``
    (dampnet_full_class.py:174), the prototype variant adds it unscaled
    (dampnet.py:166)."""
    matrix, bias, m_fac = corruption_terms(draws, x.shape[-1], dtype=x.dtype, device=x.device)
    return (x.detach() @ matrix + (m_fac * bias if scale_bias else bias)).detach()


def sample_corruption(gen: torch.Generator, x: torch.Tensor, *, prototype: bool) -> torch.Tensor:
    """One random corruption of ``x [N, f]`` drawn from ``gen``."""
    return apply_corruption(x, draw_corruption(gen, x.shape[-1], prototype=prototype), scale_bias=not prototype)


# --------------------------------------------------------------------------
# scores
# --------------------------------------------------------------------------


def _fc_gnn_scores(params: dict, z_episode: torch.Tensor, cfg: DampNetCfg, n_query: int, freeze_head: bool):
    head = {"fc": params["fc"], "gnn": params["gnn"]}
    if freeze_head:
        # the reference's corrupt step pins fc[0] alone
        # (dampnet_full.py:187-189, dampnet_full_class.py:199-201); gnn.eval()
        # is a no-op for its stat-free BNs
        lin = {k: v.detach() for k, v in params["fc"]["linear"].items()}
        head = {"fc": {**params["fc"], "linear": lin}, "gnn": params["gnn"]}
    zt = (lambda z: znorm_projection(z, cfg.n_support)) if cfg.variant == "prototype" else None
    return gnn_scores(head, z_episode, cfg.gnn_cfg, n_query, z_transform=zt)


def dampnet_scores(params: dict, state: dict, feats_episode: torch.Tensor, cfg: DampNetCfg, n_query: int, *,
                   mode: str, gen: Optional[torch.Generator] = None, unsup_stats=None,
                   corrupt_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scores ``[n_way * n_query, n_way]`` of an episode of backbone features
    ``[n_way, s+q, feat]``, or ``[E, n_way * n_query, n_way]`` of ``E`` lanes
    ``[E, n_way, s+q, feat]`` in one call (each lane's statistics and
    recovery its own; every mode but 'corrupt').  ``mode``:

    * 'plain': no recovery (before the prototypes exist, :125-144);
    * 'corrupt': a training odd step: corrupt the features (``corrupt_x
      [n_way*slots, feat]`` if given, else a draw from ``gen``), recover them
      from the corrupted support's statistics, score with ``fc[0]`` frozen
      (the prototype variant freezes nothing) (:145-218);
    * 'recover': a training even step: recover the clean features (:219-261);
    * 'domain_shift': the eval's recovery against the source prototypes (:262-352);
    * 'unsup': recovery from external statistics ``unsup_stats=(mean, std)``
      (set_forward_unsup, :355-402).

    The prototype variant's training modes compare with the rolling store's
    prototypes (dampnet.py:147-148,211-212), not the fixed ones."""
    n_way, slots, f = feats_episode.shape[-3:]
    lead = tuple(feats_episode.shape[:-3])
    flat = feats_episode.reshape(lead + (n_way * slots, f))
    if mode == "plain":
        return _fc_gnn_scores(params, feats_episode, cfg, n_query, freeze_head=False)
    if mode not in ("corrupt", "recover", "domain_shift", "unsup"):
        raise ValueError(f"unknown DampNet mode {mode!r}")
    proto = cfg.variant == "prototype"
    src = state
    if proto and mode in ("corrupt", "recover"):
        pm, ps = store_prototypes(state)
        src = {**state, "proto_mean": pm, "proto_std": ps}
    if mode == "corrupt":
        if lead:
            raise ValueError("mode='corrupt' scores one episode, not a lane batch")
        if corrupt_x is None:
            if gen is None:
                raise ValueError("mode='corrupt' needs a generator or corrupt_x")
            corrupt = sample_corruption(gen, flat, prototype=proto)
        else:
            corrupt = corrupt_x.detach().to(flat.dtype)
        c_mean, c_std = episode_stats(corrupt.reshape(n_way, slots, f), cfg._replace(stat="support"))
        mult, add = recovery(params, src, c_mean.detach(), c_std.detach())
        recovered = corrupt * mult + add
        return _fc_gnn_scores(params, recovered.reshape(n_way, slots, f), cfg, n_query, freeze_head=not proto)
    if mode == "unsup":
        x_mean, x_std = unsup_stats
    else:
        x_mean, x_std = (t.detach() for t in episode_stats(feats_episode, cfg))
    mult, add = recovery(params, src, x_mean, x_std)
    recovered = flat * mult.unsqueeze(-2) + add.unsqueeze(-2)
    return _fc_gnn_scores(params, recovered.reshape(feats_episode.shape), cfg, n_query, freeze_head=False)


def dampnet_loss(scores: torch.Tensor, n_way: int, n_query: int) -> torch.Tensor:
    """Mean CE of the class-major scores against ``repeat(range(n_way), n_query)``."""
    return ce_loss(scores, query_labels(EpisodeSpec(n_way, 0, n_query), scores.device))


def recovered_projection(params: dict, state: dict, feats_episode: torch.Tensor, cfg: DampNetCfg) -> torch.Tensor:
    """Recovered features through the fc projector ``[n_way, slots,
    gnn_dim]``: what the eval-time linear probe of
    ``set_forward_adaptation_full`` trains on (dampnet_full_class.py:471-548).
    ``[E, n_way, slots, feat]`` -> ``[E, n_way, slots, gnn_dim]``: each
    lane's recovery and BN statistics its own."""
    n_way, slots, f = feats_episode.shape[-3:]
    lead = tuple(feats_episode.shape[:-3])
    mult, add = recovery(params, state, *episode_stats(feats_episode, cfg))
    rec = feats_episode.reshape(lead + (n_way * slots, f)) * mult.unsqueeze(-2) + add.unsqueeze(-2)
    h = linear(rec.reshape(-1, f), params["fc"]["linear"])
    h, _ = batch_norm(h, params["fc"]["bn"], None, use_batch_stats=True, groups=math.prod(lead))
    return h.reshape(lead + (n_way, slots, cfg.gnn_dim))
