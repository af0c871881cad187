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


def project(head: dict, z_flat: torch.Tensor) -> torch.Tensor:
    """Linear + batch-stats BN over all episode rows (gnnnet.py:30,53)."""
    h = linear(z_flat, head["fc"]["linear"])
    return batch_norm(h, head["fc"]["bn"], None, use_batch_stats=True)[0]


def gnn_scores(head: dict, z_episode: torch.Tensor, cfg: GnnNetCfg, n_query: int) -> torch.Tensor:
    """z_episode ``[n_way, n_support + n_query, feat]`` (support first) ->
    scores ``[n_way * n_query, n_way]`` (class-major)."""
    n_way, slots, _ = z_episode.shape
    if n_way != cfg.n_way or slots != cfg.n_support + n_query:
        raise ValueError(f"episode features {tuple(z_episode.shape)} do not match {cfg} with n_query={n_query}")
    z = project(head, z_episode.reshape(n_way * slots, -1)).reshape(n_way, slots, cfg.proj_dim)
    zs = z[:, : cfg.n_support]
    if cfg.support_compress > 1:
        zs = zs.reshape(n_way, cfg.support_compress, cfg.eff_support, cfg.proj_dim).mean(dim=1)
    zq = z[:, cfg.n_support :]  # [n_way, n_query, proj]
    s1 = cfg.eff_support + 1
    labels = support_onehot_with_query_slot(cfg.graph_spec, z.dtype, z.device)  # [n_way*s1, n_way]
    # per query q: class k's supports then q itself -> [n_query, n_way, s1, proj]
    nodes = torch.cat(
        [zs[None].expand(n_query, -1, -1, -1), zq.transpose(0, 1)[:, :, None, :]], dim=2
    ).reshape(n_query, n_way * s1, cfg.proj_dim)
    graphs = torch.cat([nodes, labels[None].expand(n_query, -1, -1)], dim=2)
    out = apply_gnn(head["gnn"], graphs, cfg.use_pallas)  # [n_query, N, n_way]
    out = out.reshape(n_query, n_way, s1, n_way)[:, :, -1]
    return out.transpose(0, 1).reshape(n_way * n_query, n_way)


def gnnnet_loss(scores: torch.Tensor, n_way: int, n_query: int) -> torch.Tensor:
    """Mean CE of the class-major scores against ``repeat(range(n_way), n_query)``."""
    return ce_loss(scores, query_labels(EpisodeSpec(n_way, 0, n_query), scores.device))
