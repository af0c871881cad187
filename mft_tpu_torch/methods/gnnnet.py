"""GnnNet head (port of ``mft_tpu/methods/gnnnet.py``; reference
methods/gnnnet.py and the compressed 50-shot methods/gnnnet_copy.py).

Projector ``Linear(feat_dim -> 128) + BN1d`` (batch statistics), then one
graph per query of ``n_way * (n_support + 1)`` nodes: every class's support
embeddings plus that query, with one-hot support labels and a zero label
row for the query slot; all ``n_query`` graphs go through the GNN together.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mft_tpu_torch.core.episode import EpisodeSpec, query_labels, support_onehot_with_query_slot
from mft_tpu_torch.methods.baseline import ce_loss
from mft_tpu_torch.models.gnn import GNNCfg, apply_gnn, init_gnn
from mft_tpu_torch.ops.convpool import linear
from mft_tpu_torch.ops.initializers import bn_params, torch_linear
from mft_tpu_torch.ops.norm import batch_norm


class GnnNetCfg(NamedTuple):
    feat_dim: int = 512
    n_way: int = 5
    n_support: int = 5
    proj_dim: int = 128
    gnn_nf: int = 96
    support_compress: int = 1  # 2 = the 50-shot gnnnet_copy variant
    use_pallas: bool = False  # the CUDA edge kernel (kernels/edge_mlp.py)

    @property
    def eff_support(self) -> int:
        if self.support_compress == 1:
            return self.n_support
        return round(self.n_support / self.support_compress)

    @property
    def gnn_cfg(self) -> GNNCfg:
        return GNNCfg(self.proj_dim + self.n_way, self.gnn_nf, self.n_way)

    @property
    def graph_spec(self) -> EpisodeSpec:
        return EpisodeSpec(self.n_way, self.eff_support, 1)


def init_head(gen: torch.Generator, cfg: GnnNetCfg, **kw) -> dict:
    """fc projector + GNN parameters (the backbone belongs to the caller)."""
    return {
        "fc": {"linear": torch_linear(gen, cfg.feat_dim, cfg.proj_dim, **kw), "bn": bn_params(cfg.proj_dim, **kw)},
        "gnn": init_gnn(gen, cfg.gnn_cfg, **kw),
    }


def project(head: dict, z_flat: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Linear + batch-stats BN over all episode rows (gnnnet.py:30,53);
    ``groups``: that many episodes' rows, each with its own statistics."""
    h = linear(z_flat, head["fc"]["linear"])
    return batch_norm(h, head["fc"]["bn"], None, use_batch_stats=True, groups=groups)[0]


def gnn_scores(head: dict, z_episode: torch.Tensor, cfg: GnnNetCfg, n_query: int, z_transform=None) -> torch.Tensor:
    """z_episode ``[n_way, n_support + n_query, feat]`` (support first) ->
    scores ``[n_way * n_query, n_way]`` (class-major); ``[E, n_way, s+q,
    feat]`` (E episode lanes) -> ``[E, n_way * n_query, n_way]``, the lanes'
    ``E * n_query`` graphs in one GNN pass (one edge-kernel call per
    ``Wcompute``) with per-episode BN statistics.  ``z_transform``: an
    optional hook on each episode's projected ``[n_way, slots, proj]``
    tensor before the graph build (the DampNet prototype variant
    mean-centers and L2-normalizes there, reference methods/dampnet.py:125-129)."""
    lanes = z_episode.dim() == 4
    z_e = z_episode if lanes else z_episode[None]
    e, n_way, slots, _ = z_e.shape
    if n_way != cfg.n_way or slots != cfg.n_support + n_query:
        raise ValueError(f"episode features {tuple(z_episode.shape)} do not match {cfg} with n_query={n_query}")
    z = project(head, z_e.reshape(e * n_way * slots, -1), groups=e).reshape(e, n_way, slots, cfg.proj_dim)
    if z_transform is not None:
        z = torch.stack([z_transform(zl) for zl in z])
    zs = z[:, :, : cfg.n_support]
    if cfg.support_compress > 1:
        zs = zs.reshape(e, n_way, cfg.support_compress, cfg.eff_support, cfg.proj_dim).mean(dim=2)
    zq = z[:, :, cfg.n_support :]  # [E, n_way, n_query, proj]
    s1 = cfg.eff_support + 1
    labels = support_onehot_with_query_slot(cfg.graph_spec, z.dtype, z.device)  # [n_way*s1, n_way]
    # per query q: class k's supports then q itself -> [E, n_query, n_way, s1, proj]
    nodes = torch.cat(
        [zs[:, None].expand(-1, n_query, -1, -1, -1), zq.transpose(1, 2)[:, :, :, None, :]], dim=3
    ).reshape(e * n_query, n_way * s1, cfg.proj_dim)
    graphs = torch.cat([nodes, labels[None].expand(e * n_query, -1, -1)], dim=2)
    out = apply_gnn(head["gnn"], graphs, cfg.use_pallas, bn_groups=e)  # [E*n_query, N, n_way]
    out = out.reshape(e, n_query, n_way, s1, n_way)[:, :, :, -1]
    out = out.transpose(1, 2).reshape(e, n_way * n_query, n_way)
    return out if lanes else out[0]


def gnnnet_loss(scores: torch.Tensor, n_way: int, n_query: int) -> torch.Tensor:
    """Mean CE of the class-major scores against ``repeat(range(n_way), n_query)``."""
    return ce_loss(scores, query_labels(EpisodeSpec(n_way, 0, n_query), scores.device))
