"""The port's multi-process dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip`` and ``dryrun_multihost``).

``python -m mft_tpu_torch.parallel.dryrun --world N [--device cuda|cpu] [--full]``
spawns ``N`` ranks (``torch.multiprocessing``, spawn context, a process
group on ``tcp://127.0.0.1:<free port>``: ``nccl`` with one card a rank,
``gloo`` on the CPU).  Every rank starts from its own seeded trees and takes
rank 0's (:func:`pdist.broadcast_tree`), feeds only its own slice of the
episodes, and runs:

* one data-parallel FO-MAML step (GnnNet, ``bn_mode='episode'``); ``--full``
  adds the episodic GnnNet and ProtoNet steps, the baseline step with its BN
  statistics over every rank's rows, and DampNet's plain, corrupt and
  recover steps (the prototype variant, its rolling store refreshed from
  the banks gathered from every rank);
* one ``--method all --use_pallas --inner_scan fused`` lane batch of the
  eval (``cli/finetune.py`` ``evaluate`` over the group), which issues no
  collective (each lane batch runs with ``torch.distributed``'s collectives
  made to raise); ``--full`` adds the live DampNet eval.

Rank 0 also runs the one-process reference in its own process, on its own
device: each step over the whole batch with ``group=None`` and the eval's
batches on one device.  The run asserts: each step's loss, gradients,
updates and running stats within phase 4's rules of the reference (loss
1e-4 relative; each gradient tensor within 1e-3 of its largest value plus
1e-5 of the tree's; 99.9 % of update elements within 1e-2 lr; stats within
1e-4), the planted faults (FAULTS) outside them, every rank's trees bit-equal
(:func:`pdist.tree_checksum`), the eval's scores equal to the reference's,
and on a card the kernels' launches exact: the edge kernel 3 times a local
GnnNet episode, the scan once a rank's lane batch.  Widths are narrow
(8, 16, 32, 64) at 32 px on the CPU, ResNet10's at 224 px on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import os
import socket
import sys
import tempfile
import time
import traceback
from typing import NamedTuple, Optional
from unittest import mock

import numpy as np
import torch
from torch.utils import _pytree as pytree

from mft_tpu_torch.parallel import distributed as pdist

SEED = 0
LR = 1e-3
#: the rules for a training step against a reference step (readings_apart,
#: rule_bounds), here and in chip_smoke.py's phase 4, whose notes say how each
#: was set: the loss within LOSS_RTOL relative; each gradient tensor within
#: GRAD_TOL of its largest value plus GRAD_TREE_FLOOR of the tree's largest;
#: the running stats within STATS_TOL of each tensor's largest value; a share
#: UPDATE_SHARE of the update elements within 1e-2 LR
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
GRAD_TREE_FLOOR = 1e-5
STATS_TOL = 1e-4
UPDATE_SHARE = 0.999
#: where the two steps run in f32 on different devices (or the same card
#: with other algorithms), each gradient tensor's allowance also gains
#: F32_FACTOR times the reference's own f32 error against the same step in
#: f64 (its ``floor``): two f32 steps part by their own errors
F32_FACTOR = 4.0
#: and the update rule's share of elements grows to UPDATE_FACTOR times the
#: share by which the f32 step's updates part from the f64 step's
#: (``update_floor``), where that is the larger
UPDATE_FACTOR = 3.0
#: the planted faults, each on its step (the run's first step; the baseline
#: step, under --full), which the rules must catch: the gradients summed
#: over the ranks and not divided by the world; and the BN over the ranks
#: with its backward left on each rank (its forward still summed), which only
#: the gradients show
FAULTS = {"unscaled": "the gradients summed over the ranks, not divided by the world",
          "bn_backward_local": "the BN over the ranks with a rank-local backward (forward sums still synced)"}
#: the steps of the default run and of --full, in run order
DEFAULT_STEPS = ("fine_tune",)
FULL_STEPS = ("episodic", "protonet", "fine_tune", "baseline", "dampnet_plain", "dampnet_corrupt", "dampnet_recover")
#: steps whose forward runs the GnnNet head (3 edge-kernel launches a local episode with use_pallas)
GNN_STEPS = ("episodic", "fine_tune")


class Sizes(NamedTuple):
    widths: Optional[tuple]  # None: ResNet10's own
    image_size: int
    n_query: int
    inner_epochs: int  # the FO-MAML step's
    baseline_rows: int  # a rank's rows of the baseline minibatch
    gen_examples: int
    fine_tune_epoch: int
    eval_lanes: int  # a rank's lane batch
    eval_dtype: str


CPU = Sizes((8, 16, 32, 64), 32, 2, 1, 4, 1, 1, 2, "float32")
CUDA = Sizes(None, 224, 16, 15, 16, 17, 5, 2, "bfloat16")


# --------------------------------------------------------------------------
# spawning ranks
# --------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, world, init_method, device, target, blob, out_path):
    import torch.distributed as dist

    try:
        payload = torch.load(io.BytesIO(blob), weights_only=False)
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # the ranks share the host's cores
        dev = pdist.init_process_group(rank, world, init_method, device)
        result = target(dist.group.WORLD, dev, payload)
        torch.save(result, out_path)
        dist.destroy_process_group()
    except BaseException:
        with open(out_path + ".err", "w") as f:
            f.write(traceback.format_exc())
        sys.stderr.write(f"rank {rank} failed:\n{traceback.format_exc()}")
        os._exit(1)


class Ranks:
    """``world`` spawned ranks running ``target(group, device, payload)`` (a
    module-level function; its result is saved with ``torch.save``),
    started at construction; :meth:`join` returns the results in rank
    order.  Start ranks from one thread: the spawn context's process start
    is not safe from several at once."""

    def __init__(self, world: int, target, payload, *, device: str = "cpu"):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        init_method = f"tcp://127.0.0.1:{free_port()}"
        self.world = world
        self._tmp = tempfile.TemporaryDirectory(prefix="mft_dryrun_")
        self._outs = [os.path.join(self._tmp.name, f"rank{r}.pt") for r in range(world)]
        # the payload goes as bytes: pickled by the process start, its tensors would travel as
        # shared-memory file descriptors
        blob = io.BytesIO()
        torch.save(payload, blob)
        self._procs = [ctx.Process(target=_rank_entry, args=(r, world, init_method, device, target, blob.getvalue(),
                                                             self._outs[r]), daemon=True) for r in range(world)]
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self._stop()
            raise

    def _why(self, r: int) -> str:
        err = self._outs[r] + ".err"
        if os.path.exists(err):
            with open(err) as f:
                return f.read()
        return f"exit code {self._procs[r].exitcode}"

    def _stop(self):
        for p in self._procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        self._tmp.cleanup()

    def join(self, timeout: float = 600.0) -> list:
        """The ranks' results; a rank that fails, or ranks still running
        after ``timeout`` seconds, stop every rank and raise here."""
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in self._procs):
                failed = [r for r, p in enumerate(self._procs) if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0]} of {self.world} failed:\n{self._why(failed[0])}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks did not finish within {timeout:.0f} s")
                time.sleep(0.05)
            for r, p in enumerate(self._procs):
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} of {self.world} failed:\n{self._why(r)}")
            return [torch.load(o, weights_only=False) for o in self._outs]
        finally:
            self._stop()


def spawn(world: int, target, payload, *, device: str = "cpu", timeout: float = 600.0) -> list:
    """:class:`Ranks` started and joined: the results in rank order."""
    return Ranks(world, target, payload, device=device).join(timeout)


def planted(fault: str):
    """The context that plants ``fault`` (a key of FAULTS) in this process."""
    from mft_tpu_torch.ops import norm
    from mft_tpu_torch.train import steps

    if fault == "unscaled":
        return mock.patch.object(steps, "_share", lambda world: 1.0)
    if fault == "bn_backward_local":
        return mock.patch.object(norm._AllReduceSum, "backward", staticmethod(lambda ctx, g: (g, None)))
    raise ValueError(f"no planted fault {fault!r}")


# --------------------------------------------------------------------------
# data-parallel steps on given inputs
# --------------------------------------------------------------------------


def adam_for(params, lr: float = LR):
    """The training driver's optimizer for ``params``: ``torch_adam(lr)``,
    ResNet10_FW's noise strengths frozen (``cli/train.py``)."""
    from mft_tpu_torch.models import backbone as bb
    from mft_tpu_torch.train import optimizers as opt

    tx = opt.torch_adam(lr)
    trainable = bb.fwt_trainable_mask(params)
    return tx if all(pytree.tree_leaves(trainable)) else opt.freeze_masked(tx, trainable)


def run_step_jobs(group, dev, jobs) -> list:
    """A spawn target: ``train/steps.py`` steps on the given inputs.  Each
    job is ``{"step": name, "params", "stats", "args": the step's
    positional arguments after its Adam state, "kwargs", "local": the
    positions in ``args`` that hold the whole batch (each rank takes its
    slice), "chain": start from the last job's params, stats and Adam state
    (a DampNet job also from the store the last DampNet job refreshed),
    "refresh": after a DampNet job, its store refreshed from the banks of
    every rank ('gathered', as the driver refreshes it) or from this rank's
    alone ('local'), "fault": a key of FAULTS planted in the step}``; the
    optimizer is :func:`adam_for`'s.  Returns each job's ``(params, stats,
    opt_state, metrics)`` on the CPU."""
    from mft_tpu_torch.methods import dampnet as dn
    from mft_tpu_torch.train import steps

    rank, world = pdist.rank_world(group)
    to_dev = lambda t: pytree.tree_map(lambda v: v.to(dev) if isinstance(v, torch.Tensor) else v, t)
    out, prev, dstate = [], None, None
    for job in jobs:
        params, stats, args = to_dev((job["params"], job["stats"], list(job["args"])))
        tx = adam_for(params)
        opt_state = tx.init(params)
        if job.get("chain"):
            params, stats, opt_state = prev[:3]
            if job["step"] == "dampnet_train_step":
                args[0] = dstate
        for i in job.get("local", ()):
            args[i] = args[i][pdist.episode_slice(rank, world, len(args[i]))]
        with planted(job["fault"]) if job.get("fault") else contextlib.nullcontext():
            res = getattr(steps, job["step"])(params, stats, opt_state, *args, **to_dev(job.get("kwargs", {})),
                                              tx=tx, group=group)
        if job.get("refresh"):
            bank = res[3]["support_bank"]
            if job.get("refresh") == "local":
                bank = bank[pdist.episode_slice(rank, world, len(bank))]
            dstate = dn.update_prototype_store(args[0], bank)
        prev = res
        out.append(pytree.tree_map(lambda v: v.detach().cpu() if isinstance(v, torch.Tensor) else v, res))
    return out


# --------------------------------------------------------------------------
# the dry run's ranks
# --------------------------------------------------------------------------


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def recording(tx, sink: dict):
    """``tx`` that keeps the gradients it is given in ``sink['grads']``."""
    from mft_tpu_torch.train import optimizers as opt

    def update(g, s, p):
        sink["grads"] = g
        return tx.update(g, s, p)

    return opt.Optimizer(tx.init, update)


def readings_apart(a: dict, b: dict, floor: Optional[dict] = None) -> dict:
    """How far step readings ``a`` part from ``b`` (each ``{"loss",
    "grads", "updates", "stats"}``, flat dicts of tensors on one device):
    the relative loss, the worst gradient tensor as a multiple of its
    allowance (GRAD_TOL of its largest value plus GRAD_TREE_FLOOR of the
    tree's, plus F32_FACTOR times its ``floor``), the gradients' relative
    L2, the share of update elements more than 1e-2 LR apart, the worst
    stats tensor as a share of its largest."""
    floor = floor or {}
    gmax = max(float(v.abs().max()) for v in b["grads"].values())
    grad_worst = max(float((a["grads"][k] - v).abs().max())
                     / (GRAD_TOL * float(v.abs().max()) + GRAD_TREE_FLOOR * gmax + F32_FACTOR * floor.get(k, 0.0))
                     for k, v in b["grads"].items())
    num = sum(float((a["grads"][k].double() - v.double()).square().sum()) for k, v in b["grads"].items())
    den = sum(float(v.double().square().sum()) for v in b["grads"].values())
    apart = sum(int(((a["updates"][k] - v).abs() > 1e-2 * LR).sum()) for k, v in b["updates"].items())
    total = sum(v.numel() for v in b["updates"].values())
    stats = max((float((a["stats"][k] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                 for k, v in b["stats"].items()), default=0.0)
    return {"loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]), "grad_worst": grad_worst,
            "grad_rel_l2": (num / den) ** 0.5, "update_disagree": apart / total, "stats": stats}


def rule_bounds(apart: dict) -> dict:
    """Phase 4's bounds on ``readings_apart``'s readings (the update share's
    widened by an ``update_floor`` the readings carry)."""
    return {"loss": LOSS_RTOL, "grad_worst": 1.0, "stats": STATS_TOL,
            "update_disagree": max(1.0 - UPDATE_SHARE, UPDATE_FACTOR * apart.get("update_floor", 0.0))}


def rules_broken(apart: dict) -> list:
    """The phase-4 rules ``apart`` breaks."""
    return [k for k, v in rule_bounds(apart).items() if not apart[k] <= v]


@contextlib.contextmanager
def no_collectives():
    """``torch.distributed``'s collectives raise inside (the eval's lane
    batches must issue none)."""
    import torch.distributed as dist

    names = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor", "all_gather_object", "reduce",
             "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "gather", "scatter",
             "barrier", "broadcast_object_list", "send", "recv")

    def refuse(name):
        def f(*a, **k):
            raise RuntimeError(f"torch.distributed.{name} called inside the eval's lane batch")
        return f

    with contextlib.ExitStack() as stack:
        for n in names:
            if hasattr(dist, n):
                stack.enter_context(mock.patch.object(dist, n, refuse(n)))
        yield


class _Model(NamedTuple):
    bcfg: object
    gcfg: object
    spec: object
    feature: dict
    stats: dict
    head: dict


def seeded_model(dev, sizes: Sizes, group):
    """Rank 0's seeded trees on every rank: each rank draws its own, then
    takes rank 0's."""
    from mft_tpu_torch.core.episode import EpisodeSpec
    from mft_tpu_torch.methods import gnnnet as gn
    from mft_tpu_torch.models import backbone as bb

    rank, _ = pdist.rank_world(group)
    bcfg = bb.resnet10()
    if sizes.widths is not None:
        bcfg = bcfg._replace(widths=sizes.widths)
    gcfg = gn.GnnNetCfg(feat_dim=bcfg.feat_dim, n_way=5, n_support=5, use_pallas=True)
    g = torch.Generator().manual_seed(SEED + rank)
    feature, stats = bb.init_backbone(g, bcfg, device=dev)
    head = gn.init_head(g, gcfg, device=dev)
    feature, stats, head = pdist.broadcast_tree((feature, stats, head), 0, group)
    return _Model(bcfg, gcfg, EpisodeSpec(5, 5, sizes.n_query), feature, stats, head)


@functools.lru_cache(maxsize=2)
def _batch(sizes: Sizes, n: int, dev):
    """The seeded batch of ``n`` episodes ``[n, 5, 5 + q, 3, S, S]`` and of
    ``n`` baseline slices of rows (images, labels of 64 classes)."""
    rs = np.random.RandomState(SEED + 1)
    s = sizes.image_size
    episodes = torch.from_numpy(rs.rand(n, 5, 5 + sizes.n_query, 3, s, s).astype(np.float32)).to(dev)
    rows = sizes.baseline_rows * n
    x = torch.from_numpy(rs.rand(rows, 3, s, s).astype(np.float32)).to(dev)
    return episodes, x, torch.from_numpy(rs.randint(0, 64, rows)).to(dev)


def _cast(tree, dtype):
    return pytree.tree_map(lambda t: t.to(dtype) if isinstance(t, torch.Tensor) and t.is_floating_point() else t,
                           tree)


def step_call(kind, m: _Model, sizes: Sizes, n: int, dev, damp, dtype=None):
    """``(fn(group, tx) -> the step's output, params)`` of a step kind over
    a seeded batch of ``n`` episodes (``n`` baseline slices of rows): with
    a group, each rank steps on its slice of the batch; without, one
    process on all of it.  ``damp``: DampNet's config, head and state.
    ``dtype``: weights, state and inputs cast (f64 runs the edge op's plain
    version)."""
    from mft_tpu_torch.methods.baseline import init_classifier
    from mft_tpu_torch.train import steps

    episodes, x, y = _batch(sizes, n, dev)
    if dtype is not None:
        m = m._replace(gcfg=m.gcfg._replace(use_pallas=False), feature=_cast(m.feature, dtype),
                       stats=_cast(m.stats, dtype), head=_cast(m.head, dtype))
        episodes, x = episodes.to(dtype), x.to(dtype)
        damp = None if damp is None else {**damp, "head": _cast(damp["head"], dtype),
                                          "state": _cast(damp["state"], dtype)}

    def mine(t, group):
        if group is None:
            return t
        return t[pdist.episode_slice(*pdist.rank_world(group), len(t))]

    if kind in ("episodic", "protonet"):
        method = "gnnnet" if kind == "episodic" else "protonet"
        params = {"feature": m.feature, **(m.head if method == "gnnnet" else {})}
        return (lambda group, tx: steps.episodic_train_step(
            params, m.stats, tx.init(params), mine(episodes, group), method=method, bcfg=m.bcfg,
            gcfg=m.gcfg if method == "gnnnet" else None, spec=m.spec, tx=tx, group=group)), params
    if kind == "fine_tune":
        params = {"feature": m.feature, **m.head}
        mcfg = steps.MetaFinetuneCfg(epochs=sizes.inner_epochs, batch_size=4)
        return (lambda group, tx: steps.meta_finetune_train_step(
            params, m.stats, tx.init(params), mine(episodes, group), torch.Generator().manual_seed(SEED + 2),
            method="gnnnet", bcfg=m.bcfg, gcfg=m.gcfg, spec=m.spec, mcfg=mcfg, tx=tx, group=group)), params
    if kind == "baseline":
        params = {"feature": m.feature,
                  "classifier": init_classifier(torch.Generator().manual_seed(SEED + 3), m.bcfg.feat_dim, 64,
                                                dtype=pytree.tree_leaves(m.feature)[0].dtype, device=dev)}
        return (lambda group, tx: steps.baseline_train_step(params, m.stats, tx.init(params), mine(x, group),
                                                            mine(y, group), bcfg=m.bcfg, tx=tx, group=group)), params
    mode = kind.split("_")[1]
    dcfg, dhead = damp["cfg"], damp["head"]
    params = {"feature": m.feature, **dhead}
    return (lambda group, tx: steps.dampnet_train_step(
        params, m.stats, tx.init(params), damp["state"], mine(episodes, group),
        torch.Generator().manual_seed(SEED + 4), mode=mode, bcfg=m.bcfg, dcfg=dcfg, spec=m.spec, tx=tx,
        group=group)), params


def step_readings(fn, params, group, dev, timings=None):
    """One step: its readings (``readings_apart``'s), its output, its
    seconds, and (``timings``: a list the all-reduce's seconds go to)."""
    from mft_tpu_torch.train import optimizers as opt
    from mft_tpu_torch.utils.checkpoint import keyed

    sink = {}
    tx = recording(opt.torch_adam(LR), sink)
    real = pdist.all_reduce_tree

    def timed(tree, group_=None):
        _sync(dev)
        t0 = time.perf_counter()
        out = real(tree, group_)
        _sync(dev)
        if timings is not None:
            timings.append(time.perf_counter() - t0)
        return out

    _sync(dev)
    t0 = time.perf_counter()
    with mock.patch.object(pdist, "all_reduce_tree", timed):
        out = fn(group, tx)
    _sync(dev)
    seconds = time.perf_counter() - t0
    new_p, new_s, _, metrics = out
    before = keyed(params)
    return ({"loss": float(metrics["loss"]), "grads": keyed(sink["grads"]),
             "updates": {k: v.detach() - before[k] for k, v in keyed(new_p).items()}, "stats": keyed(new_s)},
            out, seconds)


def _eval_args(sizes: Sizes, world: int, dev, method: str):
    from mft_tpu_torch import config as cfg_mod

    return cfg_mod.parse_finetune_args([
        "--device", str(dev), "--method", method, "--use_pallas", "--inner_scan", "fused", "--test_dataset",
        "synthetic", "--image_size", str(sizes.image_size), "--n_shot", "5", "--n_query", str(sizes.n_query),
        "--gen_examples", str(sizes.gen_examples), "--fine_tune_epoch", str(sizes.fine_tune_epoch), "--eval_batch",
        str(sizes.eval_lanes), "--iter_num", str(sizes.eval_lanes * world), "--dtype", sizes.eval_dtype,
        "--inner_param_dtype", sizes.eval_dtype])


def rank_eval(m: _Model, sizes: Sizes, group, dev, method: str, models: dict, dcfg=None) -> dict:
    """The eval over the group, and on rank 0 the one-device eval of the
    same episodes; each rank's launches and lane batches."""
    from mft_tpu_torch import config as cfg_mod
    from mft_tpu_torch import kernels
    from mft_tpu_torch.cli import finetune
    from mft_tpu_torch.data import registry

    rank, world = pdist.rank_world(group)
    a = _eval_args(sizes, world, dev, method)
    entry = registry.get("synthetic")
    manifest = registry.build_manifest(entry, cfg_mod.Paths().as_dict(), split="novel")
    bcfg = m.bcfg._replace(compute_dtype=a.dtype)
    kw = dict(aug_cfg=entry.eval_aug._replace(image_size=a.image_size), bcfg=bcfg, gcfg=m.gcfg, spec=m.spec,
              device=dev, dcfg=dcfg)
    real = finetune._run_shard

    def guarded(*args, **kwargs):
        with no_collectives():
            return real(*args, **kwargs)

    out = {}
    if rank == 0:
        ref = finetune.evaluate(a, models, manifest, mesh_devices=[dev], keep_scores=True, **kw)
        out["ref_scores"] = torch.stack(ref.scores)
    _sync(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(finetune, "_run_shard", guarded):
        res = finetune.evaluate(a, models, manifest, group=group, keep_scores=True, **kw)
    _sync(dev)
    out.update(scores=torch.stack(res.scores), accs=res.accs, launches=kernels.launch_counts(),
               seconds=time.perf_counter() - t0, lane_batches=sum(rank < len(t) for t in res.shard_seconds))
    return out


def time_all_reduce(tree, group, dev, iters: int = 10) -> tuple:
    """``(elements, ms)``: ``pdist.all_reduce_tree`` of ``tree`` alone, the
    mean of ``iters`` calls after two warm ones, started together on every
    rank (a barrier) and timed to the card's last write."""
    import torch.distributed as dist

    for _ in range(2):
        pdist.all_reduce_tree(tree, group)
    dist.barrier(group=group)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        pdist.all_reduce_tree(tree, group)
    _sync(dev)
    return sum(t.numel() for t in pytree.tree_leaves(tree)), (time.perf_counter() - t0) * 1e3 / iters


def _dryrun_rank(group, dev, plan: dict) -> dict:
    """A spawn target: the dry run on one rank (the module docstring)."""
    from mft_tpu_torch import kernels
    from mft_tpu_torch.methods import dampnet as dn

    rank, world = pdist.rank_world(group)
    sizes = plan["sizes"]
    if dev.type == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    m = seeded_model(dev, sizes, group)
    damp = damp_ref = None
    if any(k.startswith("dampnet") for k in plan["steps"]) or plan["full"]:
        dcfg = dn.prototype_cfg(m.bcfg.feat_dim, 5, 5)
        dhead, dstate = dn.init_dampnet(torch.Generator().manual_seed(SEED + 5 + rank), dcfg, device=dev)
        dhead = pdist.broadcast_tree(dhead, 0, group)
        damp = {"cfg": dcfg, "head": dhead, "state": dstate}
        damp_ref = dict(damp)
    result = {"rank": rank, "device": str(dev), "steps": {}, "faults": []}
    repeats = plan.get("repeats", 1)
    # the planted faults' steps, and rank 0's reference readings of those steps
    faults = {plan["steps"][0]: "unscaled"}
    if "baseline" in plan["steps"]:
        faults["baseline"] = "bn_backward_local"
    refs = {}
    for kind in plan["steps"]:
        row = {}
        if rank == 0:  # the one-process reference, on this rank's device
            fn, params = step_call(kind, m, sizes, world, dev, damp_ref)
            for i in range(repeats):
                ref, ref_out, row["ref_seconds"] = step_readings(fn, params, None, dev)
            row["ref_loss"] = ref["loss"]
            floor = {}
            if plan.get("floor"):  # the one-card f32 step's own error against f64, per gradient tensor
                fn64, params64 = step_call(kind, m, sizes, world, dev, damp_ref, dtype=torch.float64)
                exact = step_readings(fn64, params64, None, dev)[0]
                floor = {k: float((ref["grads"][k].double() - v).abs().max()) for k, v in exact["grads"].items()}
                # the largest floor as a share of the largest gradient; the f32 updates' share apart from f64's
                row["floor_share"] = max(floor.values()) / max(float(v.abs().max()) for v in exact["grads"].values())
                row["update_floor"] = readings_apart(ref, exact)["update_disagree"]
                del fn64, params64, exact
            if kind in faults:
                refs[kind] = (ref, floor, row.get("update_floor", 0.0))
            if kind.startswith("dampnet"):
                damp_ref["state"] = dn.update_prototype_store(damp_ref["state"], ref_out[3]["support_bank"])
        fn, params = step_call(kind, m, sizes, world, dev, damp)
        kernels.reset_launch_counts()
        timings = []
        for i in range(repeats):
            timings.clear()
            got, out, row["seconds"] = step_readings(fn, params, group, dev, timings)
            if i == 0:
                row["launches"] = kernels.launch_counts()
        row["allreduce_seconds"] = sum(timings)
        row["loss"] = got["loss"]
        row["checksum"] = pdist.tree_checksum(out[0])
        row["stats_checksum"] = pdist.tree_checksum(out[1])
        if kind.startswith("dampnet"):
            damp["state"] = dn.update_prototype_store(damp["state"], out[3]["support_bank"])
            row["store_checksum"] = pdist.tree_checksum(damp["state"])
            if rank == 0:
                row["store_apart"] = max(float((damp["state"][k] - damp_ref["state"][k]).abs().max())
                                         / float(damp_ref["state"][k].abs().max()) for k in ("store_mean", "store_std"))
        if rank == 0:
            row["apart"] = {**readings_apart(got, ref, floor), "update_floor": row.get("update_floor", 0.0)}
        result["steps"][kind] = row
        del got, out
        if rank == 0:
            del ref, ref_out
    # the planted faults (not at world 1, where nothing is summed over ranks)
    for kind, fault in faults.items() if world > 1 else ():
        fn, params = step_call(kind, m, sizes, world, dev, damp)
        with planted(fault):
            got, _, _ = step_readings(fn, params, group, dev)
        if rank == 0:
            ref, floor, update_floor = refs[kind]
            result["faults"].append({"kind": kind, "fault": FAULTS[fault],
                                     "apart": {**readings_apart(got, ref, floor), "update_floor": update_floor}})
    refs.clear()
    # the all-reduce alone, between barriers: what a step's all-reduce costs without waiting for a slower rank
    trees = {"ResNet10 + GnnNet": {"feature": m.feature, **m.head}}
    if damp is not None:
        trees["ResNet10 + DampNet prototype"] = {"feature": m.feature, **damp["head"]}
    result["allreduce_alone"] = {name: time_all_reduce(tree, group, dev) for name, tree in trees.items()}
    # the eval on the rank's lane batch
    models = {"baseline": (m.feature, m.stats), "gnn": (m.feature, m.stats, m.head)}
    result["eval"] = rank_eval(m, sizes, group, dev, "all", models)
    if plan["full"]:
        dcfg = dn.method_cfg("dampnet_full_class", m.bcfg.feat_dim, 5, 5)
        g = torch.Generator().manual_seed(SEED + 6)
        dhead, dstate = dn.init_dampnet(g, dcfg, device=dev)
        dstate = dn.update_prototypes(dstate, torch.rand(64, m.bcfg.feat_dim, generator=g).to(dev))
        result["damp_eval"] = rank_eval(m, sizes, group, dev, "dampnet_full_class",
                                    {"dampnet": (m.feature, m.stats, dhead, dstate)}, dcfg=dcfg)
    return result


# --------------------------------------------------------------------------
# the parent: spawn, then check
# --------------------------------------------------------------------------


def run(world: int, device: str = "cpu", full: bool = False, timeout: float = 900.0, repeats: int = 1) -> list:
    """The dry run's per-rank results (``_dryrun_rank``), unchecked."""
    sizes = CUDA if torch.device(device).type == "cuda" else CPU
    plan = {"sizes": sizes, "full": full, "steps": FULL_STEPS if full else DEFAULT_STEPS, "repeats": repeats,
            "floor": sizes is CUDA}
    return spawn(world, _dryrun_rank, plan, device=device, timeout=timeout)


def check(results: list, *, on_card: bool) -> list:
    """The dry run's assertions over every rank's results; returns the
    printed lines."""
    world = len(results)
    lines = []
    r0 = results[0]
    for kind, row in r0["steps"].items():
        sums = {(r["steps"][kind]["checksum"], r["steps"][kind]["stats_checksum"],
                 r["steps"][kind].get("store_checksum")) for r in results}
        assert len(sums) == 1, f"{kind}: the ranks' trees differ after the step: {sums}"
        losses = {r["steps"][kind]["loss"] for r in results}
        assert len(losses) == 1, f"{kind}: the ranks report different losses {losses}"
        broken = rules_broken(row["apart"])
        assert not broken, f"{kind}: the world-{world} step parts from the one-process step: {broken} {row['apart']}"
        if "store_apart" in row:
            assert row["store_apart"] <= STATS_TOL, f"{kind}: the rolling store parts: {row['store_apart']}"
        lines.append(f"dryrun({world}): {kind} step loss {row['loss']:.6f} (one process {row['ref_loss']:.6f}), "
                     + ", ".join(f"{k} {v:.3e}" for k, v in row["apart"].items())
                     + (f" (the one-card f32 step's largest gradient error against f64 {row['floor_share']:.3e} "
                        "of its largest gradient)" if "floor_share" in row else "")
                     + f"; trees bit-equal on {world} ranks; {row['seconds']:.4f} s a step, all-reduce "
                     f"{row['allreduce_seconds'] * 1e3:.3f} ms; one process {row['ref_seconds']:.4f} s")
        for r in results:
            launches = r["steps"][kind]["launches"]
            if on_card and kind in GNN_STEPS:
                local = 1  # one episode a rank
                assert launches["edge_abs_diff_matmul"] == 3 * local, f"{kind} rank {r['rank']}: {launches}"
    for fault in r0["faults"]:
        broken = rules_broken(fault["apart"])
        assert broken, f"the planted fault ({fault['fault']}) on the {fault['kind']} step passes the rules: " \
                       f"{fault['apart']}"
        lines.append(f"dryrun({world}): planted fault ({fault['fault']}) on the {fault['kind']} step: "
                     + ", ".join(f"{k} {v:.3e}" for k, v in fault["apart"].items()) + f": caught by {broken}")
    for name, (n, ms) in r0["allreduce_alone"].items():
        lines.append(f"dryrun({world}): all-reduce of the {name} tree alone ({n / 1e6:.3f} M f32, {n * 4 / 2**20:.1f} "
                     f"MiB, one bucket): {ms:.3f} ms a call (rank 0, the mean of 10 after a barrier)")
    for name in ("eval", "damp_eval"):
        if name not in r0:
            continue
        got, want = r0[name]["scores"], r0[name]["ref_scores"]
        assert all(torch.equal(r[name]["scores"], got) for r in results), f"{name}: the ranks gathered different scores"
        assert torch.isfinite(got).all() and got.shape == want.shape, (got.shape, want.shape)
        diff = float((got.double() - want.double()).abs().max())
        assert diff == 0.0, f"{name}: the world-{world} scores part from one device's by {diff:.3e}"
        for r in results:
            launches = r[name]["launches"]
            if on_card:
                batches = r[name]["lane_batches"]
                want_l = {"edge_abs_diff_matmul": 3 * batches if name == "eval" else 0, "fused_inner_scan": batches}
                assert launches == want_l, f"{name} rank {r['rank']}: launches {launches}, want {want_l}"
        lines.append(f"dryrun({world}): {name} of {len(got)} episodes, {len(got) // world} a rank: scores equal to one "
                     f"device's, accs {[round(a, 1) for a in r0[name]['accs']]}")
    pair = lambda c: f"{c['edge_abs_diff_matmul']}/{c['fused_inner_scan']}"
    for r in results:
        lines.append(f"dryrun({world}): rank {r['rank']} ({r['device']}) kernel launches (edge/scan): "
                     + ", ".join(f"{k} {pair(row['launches'])}" for k, row in r["steps"].items())
                     + ", " + ", ".join(f"{n} {pair(r[n]['launches'])}" for n in ("eval", "damp_eval") if n in r))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--full", action="store_true", help="every training step and the live DampNet eval")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds the ranks may take")
    a = ap.parse_args(argv)
    if a.device == "cuda" and torch.cuda.device_count() < a.world:
        raise SystemExit(f"--world {a.world} on cuda needs {a.world} cards, {torch.cuda.device_count()} visible")
    t0 = time.perf_counter()
    results = run(a.world, a.device, a.full, a.timeout)
    for line in check(results, on_card=a.device == "cuda"):
        print(line)
    print(f"dryrun({a.world}): ok in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
