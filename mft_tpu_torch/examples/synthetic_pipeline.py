"""The whole training -> eval chain of the port on synthetic data, no dataset
needed (counterpart of ``examples/synthetic_pipeline.py``):

1. supervised baseline pretraining (``cli.train --method baseline``),
   600 steps of 64 images;
2. episodic GnnNet meta-training (``cli.train --method gnnnet``) from copies
   of stage 1's backbone and running stats, ``--steps`` steps of 8
   episodes;
3. the meta fine-tune (``cli.train --fine_tune``: FO-MAML, 15 inner epochs
   of batch 4 on the last block) on stage 2's Adam state, 40 steps of 8
   episodes;
4. the ``--method all`` ensemble eval (17 augmented support replicas, 5 + 20
   inner epochs) on 8 batches of 4 episodes of held-out synthetic classes.

ResNet10 at full width, bf16, 64 px, 5-way 5-shot.  Each stage is a
function of its step count, a ``torch.Generator``, a device and the
previous stage's trees, and returns its trees and its loss history; where
explicit augment draws (``ops/augment.augment_draws``) and inner schedules
are given they take the generator's place, so a test can hold a stage
against the JAX package; ``step_hook(i)``, where given, runs after step (or
batch) ``i`` is enqueued.  With ``--use_pallas`` the GnnNet head runs the
CUDA edge kernel (3 launches per episode in stages 2 and 3, per lane batch
in stage 4); with ``--inner_scan fused`` the GNN member adapts through the
fused scan (one call per lane batch).

Run: ``python -m mft_tpu_torch.examples.synthetic_pipeline --use_pallas
--inner_scan fused`` (on the card; ``--device cpu`` on the CPU).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils import _pytree as pytree

from mft_tpu_torch import kernels, resolve_device
from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.data import manifests, registry
from mft_tpu_torch.data.pipeline import BatchStream, EpisodeStream
from mft_tpu_torch.methods import gnnnet as gn
from mft_tpu_torch.methods.baseline import init_classifier
from mft_tpu_torch.models import backbone as bb
from mft_tpu_torch.ops.augment import augment_draws, augment_with_draws
from mft_tpu_torch.train import eval_engine as ee
from mft_tpu_torch.train import optimizers as opt
from mft_tpu_torch.train import steps as st

#: host decode size of the synthetic images, and classes of each manifest
BASE, N_CLASSES, PER_CLASS = 96, 12, 40
#: training episodes (5-way 5-shot, 8 queries) and eval episodes (15 queries)
TRAIN_SPEC, EVAL_SPEC = EpisodeSpec(5, 5, 8), EpisodeSpec(5, 5, 15)
#: episodes a meta-training and fine-tune step; episodes a held-out lane batch
EPISODES, EVAL_LANES = 8, 4
#: the eval's augmented support replicas and the seed of its episode generators
GEN_EXAMPLES, EVAL_SEED = 17, 300
#: the stages, in run order; :func:`main` runs each inside the profiler range ``pipeline:<stage>``
STAGES = ("baseline", "episodic", "fine_tune", "eval")


class Stage(NamedTuple):
    params: dict
    stats: dict
    opt_state: dict
    #: each step's loss, in run order
    losses: list
    #: each step's top-1 on its batch (stage 1 only)
    top1: Optional[list]
    #: host seconds of the stage, up to its last loss on the host
    seconds: float


class Eval(NamedTuple):
    #: each batch's scores ``[lanes, n_way * n_query, n_way]`` on the CPU
    scores: list
    accs: list
    mean: float
    ci95: float
    seconds: float


def _images(batch: np.ndarray, device) -> torch.Tensor:
    """uint8 ``[..., H, W, 3]`` on the host -> ``[..., 3, H, W]`` on ``device``."""
    t = torch.from_numpy(batch).to(device)
    return t.permute(*range(t.dim() - 3), -1, -3, -2)


def _augment(gen, images: torch.Tensor, aug_cfg, draws):
    """Augmented views, f32 (the JAX script augments in f32 before the bf16
    backbone), at ``draws`` or nine uniforms per image from ``gen``."""
    m = images.numel() // images.shape[-3:].numel()
    return augment_with_draws(images, augment_draws(gen, m) if draws is None else draws, aug_cfg)


def _floats(ts) -> list:
    return torch.stack(ts).cpu().tolist() if ts else []


def _copy(tree):
    return pytree.tree_map(torch.clone, tree)


def pretrain_baseline(manifest, params, stats, *, steps: int, gen, device, bcfg, aug_cfg, batch_size: int = 64,
                      base_size: int = BASE, seed: int = 5, draws=None, step_hook=None) -> Stage:
    """Stage 1: ``steps`` Adam(1e-3) steps of ``baseline_train_step`` on
    augmented minibatches of ``BatchStream(manifest, batch_size, steps,
    seed=seed)``; ``params = {"feature", "classifier"}``.  ``draws``: each
    step's augment draws ``[batch_size, 9]`` in place of ``gen``'s."""
    tx = opt.torch_adam(1e-3)
    opt_state = tx.init(params)
    losses, top1 = [], []
    t0 = time.perf_counter()
    for i, (bx, by) in enumerate(BatchStream(manifest, batch_size, steps, base_size=base_size, seed=seed)):
        x = _augment(gen, _images(bx, device), aug_cfg, None if draws is None else draws[i])
        y = torch.from_numpy(np.asarray(by, np.int64)).to(device)
        params, stats, opt_state, m = st.baseline_train_step(params, stats, opt_state, x, y, bcfg=bcfg, tx=tx)
        losses.append(m["loss"])
        top1.append(m["top1"])
        if i % 150 == 0:
            print(f"  step {i}: loss {float(m['loss']):.3f} top1 {float(m['top1']):.2f}")
        if step_hook:
            step_hook(i)
    losses, top1 = _floats(losses), _floats(top1)  # waits for the device
    return Stage(params, stats, opt_state, losses, top1, time.perf_counter() - t0)


def _episodes(manifest, spec, n: int, base_size: int, seed: int, device) -> torch.Tensor:
    eps = np.stack([im for im, _ in EpisodeStream(manifest, spec, n, base_size=base_size, seed=seed)])
    return _images(eps, device)


def meta_train(manifest, params, stats, *, steps: int, gen, device, bcfg, gcfg, aug_cfg, spec=TRAIN_SPEC,
               episodes: int = EPISODES, base_size: int = BASE, seed: int = 1000, draws=None,
               step_hook=None) -> Stage:
    """Stage 2: ``steps`` Adam(1e-3) steps of ``episodic_train_step``
    (GnnNet) on ``episodes`` augmented episodes a step, step ``i``'s from
    ``EpisodeStream(manifest, spec, episodes, seed=seed + i)``;
    ``params = {"feature", "fc", "gnn"}``.  ``draws``: each step's augment
    draws ``[episodes * spec.total, 9]``."""
    tx = opt.torch_adam(1e-3)
    opt_state = tx.init(params)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        x = _augment(gen, _episodes(manifest, spec, episodes, base_size, seed + i, device), aug_cfg,
                     None if draws is None else draws[i])
        params, stats, opt_state, m = st.episodic_train_step(params, stats, opt_state, x, method="gnnnet", bcfg=bcfg,
                                                             gcfg=gcfg, spec=spec, tx=tx)
        losses.append(m["loss"])
        if i % 25 == 0:
            print(f"  step {i} ({i * episodes} episodes): loss {float(m['loss']):.3f} "
                  f"({time.perf_counter() - t0:.0f}s)")
        if step_hook:
            step_hook(i)
    losses = _floats(losses)
    return Stage(params, stats, opt_state, losses, None, time.perf_counter() - t0)


def meta_finetune(manifest, params, stats, opt_state, *, steps: int, gen, device, bcfg, gcfg, aug_cfg,
                  spec=TRAIN_SPEC, mcfg=st.MetaFinetuneCfg(epochs=15, batch_size=4), episodes: int = EPISODES,
                  base_size: int = BASE, seed: int = 5000, draws=None, schedules=None, step_hook=None) -> Stage:
    """Stage 3: ``steps`` steps of ``meta_finetune_train_step`` (FO-MAML)
    continuing ``opt_state``, step ``i``'s episodes from
    ``EpisodeStream(manifest, spec, episodes, seed=seed + i)``.  ``gen``
    draws each step's augment parameters, then each episode's inner
    schedule; ``draws`` and ``schedules`` (each step's ``(idx, w)``, shared by
    its episodes) take its place."""
    tx = opt.torch_adam(1e-3)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        x = _augment(gen, _episodes(manifest, spec, episodes, base_size, seed + i, device), aug_cfg,
                     None if draws is None else draws[i])
        params, stats, opt_state, m = st.meta_finetune_train_step(
            params, stats, opt_state, x, gen, method="gnnnet", bcfg=bcfg, gcfg=gcfg, spec=spec, mcfg=mcfg, tx=tx,
            schedule=None if schedules is None else schedules[i])
        losses.append(m["loss"])
        if i % 20 == 0:
            print(f"  step {i}: loss {float(m['loss']):.3f}")
        if step_hook:
            step_hook(i)
    losses = _floats(losses)
    return Stage(params, stats, opt_state, losses, None, time.perf_counter() - t0)


def heldout_eval(manifest, models, *, batches: int, lanes: int, gen, device, bcfg, gcfg, tcfg, aug_cfg,
                 gen_examples: int = GEN_EXAMPLES, spec=EVAL_SPEC, base_size: int = BASE, seed: int = 70,
                 schedules=None, heads=None, step_hook=None) -> Eval:
    """Stage 4: the ``--method all`` program (``make_eval_program``) on
    ``batches`` lane batches of ``lanes`` episodes, batch ``b``'s from
    ``EpisodeStream(manifest, spec, lanes, seed=seed + b)``, each episode's
    generator seeded from ``gen``.  ``models = {"baseline": (params, stats),
    "gnn": (params, stats, head)}``.  ``schedules`` (each batch's lane-stacked
    ``(linear, gnn)`` inner schedules) and ``heads`` (each batch's
    lane-stacked classifier init) take the generators' place; they need
    ``gen_examples=0``, which draws no augment parameters."""
    if schedules is not None and gen_examples:
        raise ValueError("explicit schedules replace every draw only with gen_examples=0")
    program = ee.make_eval_program(method="all", bcfg=bcfg, gcfg=gcfg, spec=spec, tcfg=tcfg, aug_cfg=aug_cfg,
                                   gen_examples=gen_examples)
    models = pytree.tree_map(lambda t: t.to(device), models)
    scores, accs = [], []
    t0 = time.perf_counter()
    for b in range(batches):
        base = _episodes(manifest, spec, lanes, base_size, seed + b, device)
        if schedules is None:
            seeds = torch.randint(0, 2**62, (lanes,), generator=gen).tolist()
            s, a = program(models, base, [torch.Generator().manual_seed(k) for k in seeds])
        else:
            s, a = program(models, base, [None] * lanes, inner_schedule=schedules[b], head0=heads[b])
        scores.append(s.cpu())
        accs += a
        if step_hook:
            step_hook(b)
    mean, ci = ee.mean_ci95(np.asarray(accs))
    return Eval(scores, accs, mean, ci, time.perf_counter() - t0)


def run_heldout(models, *, device, image_size: int = 64, use_pallas: bool = False, inner_scan: str = "eager",
                batches: int = 8, lanes: int = EVAL_LANES, gen_examples: int = GEN_EXAMPLES, step_hook=None) -> Eval:
    """Stage 4 as :func:`main` runs it, on the held-out tints (the synthetic
    manifest of seed 99) with the same episodes and draws at every call, so
    two inner loops compare on one set of trained trees."""
    return heldout_eval(
        manifests.synthetic(n_classes=N_CLASSES, per_class=PER_CLASS, base_size=BASE, seed=99), models,
        batches=batches, lanes=lanes, gen=torch.Generator().manual_seed(EVAL_SEED), device=device, bcfg=model_cfg(),
        gcfg=head_cfg(use_pallas), tcfg=ee.TransferCfg(fine_tune_epochs=5, linear_epochs=20, inner_scan=inner_scan),
        aug_cfg=registry.get("synthetic").eval_aug._replace(image_size=image_size), gen_examples=gen_examples,
        step_hook=step_hook)


def model_cfg():
    return bb.resnet10()._replace(compute_dtype="bfloat16")


def head_cfg(use_pallas: bool):
    return gn.GnnNetCfg(feat_dim=512, n_way=5, n_support=5, use_pallas=use_pallas)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="mft_tpu_torch: the synthetic full pipeline")
    ap.add_argument("--steps", type=int, default=188, help="episodic meta-training steps of 8 episodes")
    ap.add_argument("--image_size", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="torch device; 'cuda' raises when no card is present")
    ap.add_argument("--use_pallas", action="store_true", help="the CUDA edge kernel in the GNN head")
    ap.add_argument("--inner_scan", default="eager", choices=["eager", "fused"],
                    help="the eval's GNN member inner loop: one eager step per minibatch, or the fused CUDA scan")
    ap.add_argument("--baseline_steps", type=int, default=600, help="baseline pretraining steps of 64 images")
    ap.add_argument("--finetune_steps", type=int, default=40, help="FO-MAML fine-tune steps")
    ap.add_argument("--eval_batches", type=int, default=8, help="held-out lane batches of 4 episodes")
    return ap.parse_args(argv)


def main(argv=None, step_hook=None) -> dict:
    """Runs the four stages and returns what a caller reads without parsing
    text: each stage's ``losses`` (and stage 1's ``top1``), the held-out
    ``accs``, ``acc`` and ``ci95``, the ``seconds`` and kernel ``launches``
    of each stage, the device's ``peak_bytes`` (None off CUDA) and the
    trained ``models`` (stage 4's input).  ``step_hook(stage, i)`` runs after
    each step or batch ``i`` of each stage is enqueued (a profiler window)."""
    a = parse_args(argv)
    device = resolve_device(a.device)
    cuda = device.type == "cuda"
    if cuda:
        # f32 means f32 (the edge kernel's inputs, the heads): no TF32 in cuDNN or cuBLAS
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
    man = manifests.synthetic(n_classes=N_CLASSES, per_class=PER_CLASS, base_size=BASE, seed=3)
    bcfg, gcfg = model_cfg(), head_cfg(a.use_pallas)
    acfg = registry.get("synthetic").train_aug._replace(image_size=a.image_size)
    gen = torch.Generator().manual_seed(1)  # every stage's augment draws and inner schedules, in run order
    launches, seconds = {}, {}

    def counted(name, fn):
        before = kernels.launch_counts()
        hook = None if step_hook is None else (lambda i: step_hook(name, i))
        with record_function(f"pipeline:{name}"):
            res = fn(hook)
        launches[name] = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        seconds[name] = res.seconds
        return res

    print("[1/4] baseline pretraining")
    g0 = torch.Generator().manual_seed(0)
    feature, stats = bb.init_backbone(g0, bcfg, device=device)
    params = {"feature": feature, "classifier": init_classifier(g0, bcfg.feat_dim, N_CLASSES, device=device)}
    s1 = counted("baseline", lambda hook: pretrain_baseline(man, params, stats, steps=a.baseline_steps, gen=gen,
                                                            device=device, bcfg=bcfg, aug_cfg=acfg, step_hook=hook))

    print("[2/4] episodic GnnNet meta-training")
    head = gn.init_head(torch.Generator().manual_seed(2), gcfg, device=device)
    params = {"feature": _copy(s1.params["feature"]), **head}
    s2 = counted("episodic", lambda hook: meta_train(man, params, _copy(s1.stats), steps=a.steps, gen=gen,
                                                     device=device, bcfg=bcfg, gcfg=gcfg, aug_cfg=acfg,
                                                     episodes=EPISODES, step_hook=hook))

    print("[3/4] meta fine-tuning (FO-MAML)")
    s3 = counted("fine_tune", lambda hook: meta_finetune(man, s2.params, s2.stats, s2.opt_state,
                                                         steps=a.finetune_steps, gen=gen, device=device, bcfg=bcfg,
                                                         gcfg=gcfg, aug_cfg=acfg, episodes=EPISODES, step_hook=hook))

    print("[4/4] method=all ensemble eval on held-out classes")
    models = {"baseline": (s1.params["feature"], s1.stats),
              "gnn": (s3.params["feature"], s3.stats, {"fc": s3.params["fc"], "gnn": s3.params["gnn"]})}
    ev = counted("eval", lambda hook: run_heldout(models, device=device, image_size=a.image_size,
                                                  use_pallas=a.use_pallas, inner_scan=a.inner_scan,
                                                  batches=a.eval_batches, lanes=EVAL_LANES, gen_examples=GEN_EXAMPLES,
                                                  step_hook=hook))
    print("%d Test Acc = %4.2f%% +- %4.2f%%" % (len(ev.accs), ev.mean, ev.ci95))
    return dict(losses={"baseline": s1.losses, "episodic": s2.losses, "fine_tune": s3.losses}, top1=s1.top1,
                accs=ev.accs, acc=ev.mean, ci95=ev.ci95, seconds=seconds, launches=launches,
                peak_bytes=torch.cuda.max_memory_allocated(device) if cuda else None, models=models)


if __name__ == "__main__":
    main(sys.argv[1:])
