"""How ``correct`` is decided.

The eval's answer passes through 500 (and 100) Adam steps whose updates are
about ``+-lr`` an element whatever the gradient's size, so two exact
computations that differ in rounding alone part there: the port in bf16 and
the reference in float32 end as far apart in their scores as the reference
in float8 does (the benchmark's calibration on the card).  So the scores
are judged from the port's own adapted state, and the adaptation, its start
and its first step are each held to the reference by themselves:

1. ``rerun_gap`` (limit 0): a sampled batch of the window (on a mesh, each
   shard's part of one global batch) is run again through the driver's
   ``_run_shard`` and lane program after the window, with its banks, adapted
   blocks and member scores recorded; its scores must equal the window's bit
   for bit, which makes the recorded state the window's.
2. ``sum_gap`` (limit 0): the window's scores are the recorded members'
   softmaxes summed.
3. ``logp_gap.<member>``: the reference embeds each sampled episode with the
   port's adapted block and scores it with the member's head (the adapted
   linear head, the GNN, DampNet's recovery); the widest gap of the log of
   the member's softmax where the reference's probability is ``LOGP_FLOOR``
   or more (the logits' gap, which a saturated softmax hides).  ``gap.*``
   and ``score_gap`` (the softmaxes' own gaps) are read beside it and not
   compared: they do not separate the float8 control from the port.
4. ``dnorm.<member>``: the whole adaptation.  The reference runs each
   sampled episode's own adaptation from its own bank (every step of the
   schedule, in float32), and each leaf of the block (and head) is compared
   by the norm of its change: the gap between the port's norm and the
   reference's, against the reference's norm of that leaf or of the median
   leaf, whichever is larger; the median leaf's gap is compared
   (``adaptation_gaps``).  Adam's sign chaos moves where a leaf goes, not
   how far: a state frozen after its first step, or Adam without its bias
   corrections, reads here.  The worst
   leaf's gap (``dnorm_worst``: the BN scales, whose late updates the bf16
   carry rounds away) and the norm of the changes' difference (``dgap``)
   are read beside it and not compared.
5. ``bank_err``: the start, the relative error of the port's trunk features
   of each member's support bank (the augmentation and the trunk; the
   linear member's clean support) to the reference's, the worst member
   taken.
6. ``step_flip``: one adaptation step by itself: the port's own adaptation
   routine run for the first step of the episode's schedule from the
   episode's start on the port's bank, against the reference's step from
   the same; the share of block (and head) elements whose update's sign
   differs.

Limits: ``limits/<cell>.json``, set from the readings of
``portbench/calibrate.py``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils import _pytree as pytree

from portbench.reference import episode as ref
from portbench.reference.nets import Precision
from portbench.reference.sampler import episode_generator, episode_items

#: the readings of every run besides the members' own (``<name>.<member>``)
NUMBERS = ("rerun_gap", "sum_gap", "score_gap", "bank_err", "step_flip")
#: the episodes of a one-card run that the check samples
CHECK_EPISODES = 4
#: a leaf whose first gradient in the reference is under this share of the
#: median leaf's moves under Adam by round-off alone
GRAD_FLOOR = 1e-3
#: the eval engine's member functions whose scores a rerun records (``<name>_member_lanes``)
MEMBER_FNS = ("linear", "gnn", "dampnet")


def sample(seed: int, n_batches: int, shards: int, lanes: int, k: int) -> tuple:
    """``(batch, [(shard, lane)...])``: one of the window's global batches
    (1 to ``n_batches``, batch 0 being warm-up), drawn from the seed, and in
    it one lane of each shard on a mesh, else ``k`` distinct lanes."""
    rng = np.random.default_rng([seed % 2**63, 15])
    b = 1 + int(rng.integers(n_batches))
    if shards > 1:
        return b, [(s, int(rng.integers(lanes))) for s in range(shards)]
    return b, [(0, int(j)) for j in sorted(rng.choice(lanes, size=min(k, lanes), replace=False))]


def episode_images(p, index: int) -> torch.Tensor:
    """Episode ``index`` of the benchmark's dataset ``[n_way, s+q, 3, B, B]``
    uint8 on the weights' device, by the reference's sampler."""
    c = p.ref_cell
    items = episode_items(p.labels, p.n_classes, c["n_way"], c["n_shot"] + c["n_query"], p.seed, index)
    return torch.from_numpy(p.images[items]).to(p.weights_dev).permute(0, 1, 4, 2, 3)


@contextlib.contextmanager
def recording(keep: list):
    """Records what the port's eval engine computes for the lanes ``keep``
    of a lane batch: each member bank (``_bank_fmap``) and each adaptation
    (``_adapt_block``: its arguments and the adapted block and head)."""
    from mft_tpu_torch.train import eval_engine as ee

    rec = {"banks": [], "adapts": [], "members": {}}
    own_bank, own_adapt = ee._bank_fmap, ee._adapt_block
    own_members = {m: getattr(ee, f"{m}_member_lanes") for m in MEMBER_FNS}
    take = lambda tree: pytree.tree_map(lambda t: t[keep].detach().clone(), tree)

    def member(name):
        def run(*a, **kw):
            out = own_members[name](*a, **kw)
            rec["members"][name] = take(out).cpu()
            return out
        return run

    def bank(*a, **kw):
        out = own_bank(*a, **kw)
        rec["banks"].append({"clean_only": kw.get("clean_only", False), "fmap": take(out)})
        return out

    def adapt(params, stats, bank_y, gens, **kw):
        block, head = own_adapt(params, stats, bank_y, gens, **kw)
        rec["adapts"].append({"args": (params, stats, bank_y), "kw": kw, "block": take(block),
                              "head": None if head is None else take(head)})
        return block, head

    ee._bank_fmap, ee._adapt_block = bank, adapt
    for m in MEMBER_FNS:
        setattr(ee, f"{m}_member_lanes", member(m))
    try:
        yield rec
    finally:
        ee._bank_fmap, ee._adapt_block = own_bank, own_adapt
        for m, fn in own_members.items():
            setattr(ee, f"{m}_member_lanes", fn)


def lane_program(p):
    """The port's lane program with the driver's settings (what
    ``evaluate`` builds)."""
    from mft_tpu_torch.cli import finetune
    from mft_tpu_torch.train import eval_engine as ee

    a = p.a
    return ee.make_eval_program(method=a.method, bcfg=p.bcfg, gcfg=p.gcfg, spec=p.spec, tcfg=finetune._transfer_cfg(a),
                                aug_cfg=p.aug_cfg, gen_examples=a.gen_examples, dcfg=p.dcfg, dampnet_eval=a.dampnet_eval)


def rerun(p, program, first: int, n: int, keep: list) -> tuple:
    """Episodes ``first .. first + n`` as one lane batch of the port on the
    first card, through the driver's own ``_run_shard`` (host images, their
    layout on the device), recording the lanes ``keep``: ``(scores [n, q,
    n_way] on the CPU, record)``."""
    from mft_tpu_torch.cli import finetune

    c = p.ref_cell
    images = np.stack([p.images[episode_items(p.labels, p.n_classes, c["n_way"], c["n_shot"] + c["n_query"], p.seed,
                                              first + j)] for j in range(n)])
    gens = [episode_generator(p.seed, first + j) for j in range(n)]
    with recording(keep) as rec, torch.no_grad():
        scores, _ = finetune._run_shard(program, p.models, images, gens, p.weights_dev)
    return scores.float().cpu(), rec


def _flip_share(delta_a: dict, delta_b: dict) -> float:
    """The share of elements whose two changes differ in sign."""
    flips = sum(int((torch.sign(delta_a[k].float()) != torch.sign(delta_b[k].float())).sum()) for k in delta_b)
    return flips / sum(t.numel() for t in delta_b.values())


def _flat_block(block: dict) -> dict:
    """The port's final-block tree as reference state-dict names."""
    names = {"conv1": "C1.weight", "conv2": "C2.weight", "conv_sc": "shortcut.weight"}
    out = {}
    for k, v in block.items():
        if k in names:
            out[names[k]] = v
        elif k.startswith("bn"):
            pre = {"bn1": "BN1", "bn2": "BN2", "bn_sc": "BNshortcut"}[k]
            out[f"{pre}.weight"], out[f"{pre}.bias"] = v["scale"], v["bias"]
    return out


def named_state(block: dict, head) -> dict:
    """A member's block (and head, as ``head.<k>``) as one dict of leaves."""
    out = dict(block)
    if head is not None:
        out.update({f"head.{k}": v for k, v in head.items()})
    return out


def port_start(rec_adapt: dict, lane: int) -> dict:
    """Where the port's adaptation of lane ``lane`` of a recorded call
    starts, in the reference's names and the port's carry dtype."""
    from mft_tpu_torch.models import backbone as bb

    params, kw = rec_adapt["args"][0], rec_adapt["kw"]
    dtype = getattr(torch, kw["tcfg"].inner_param_dtype)
    head = kw.get("head")
    return {k: v.to(dtype) for k, v in named_state(_flat_block(bb.adapt_split(params)[1]),
                                                   None if head is None else {k: v[lane] for k, v in head.items()}).items()}


def port_step(p, rec_adapt: dict, lane: int, rows: torch.Tensor) -> tuple:
    """The port's adaptation routine (``eval_engine._adapt_block``) by
    itself: lane ``lane`` of a recorded call, one step on ``rows``, from the
    same start.  Returns ``(start, after)`` block (and head) leaves in the
    reference's names."""
    from mft_tpu_torch.train import eval_engine as ee

    params, stats, bank_y = rec_adapt["args"]
    kw = dict(rec_adapt["kw"])
    kw["fmap_bank"] = kw["fmap_bank"][lane : lane + 1]
    if kw.get("head") is not None:
        kw["head"] = pytree.tree_map(lambda t: t[lane : lane + 1], kw["head"])
    dev = kw["fmap_bank"].device
    kw["schedule"] = (rows.reshape(1, 1, -1).to(dev), torch.ones(1, rows.numel(), device=dev))
    with torch.no_grad():
        block, head = ee._adapt_block(params, stats, bank_y, [torch.Generator()], **kw)
    after = named_state(_flat_block(pytree.tree_map(lambda t: t[0], block)),
                        None if head is None else {k: v[0] for k, v in head.items()})
    return port_start(rec_adapt, lane), after


def reference_step(models: dict, ep, d: dict, member: str, bank: torch.Tensor, cell: dict, precision: str) -> tuple:
    """The reference's first step of ``member`` on ``bank`` from the
    episode's start: ``(start, after)`` in the reference's names."""
    model = dict(ref.adapting_members(cell))[member]
    net = ref.backbone(models[model], cell, Precision(precision))
    block0, head0 = ref.start_state(net, d, member, bank.device)
    steps = ref.member_steps(d, member, cell["batch"])[:1]
    block, head = ref.adapt(net, bank, ref.labels_of(ep, member), steps, block0, head0, lr=cell["lr"],
                            head_wd=cell.get("head_wd", 0.0))
    return named_state(block0, head0), named_state(block, head)


def delta(before: dict, after: dict) -> dict:
    return {k: after[k].float() - before[k].float() for k in after}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def _widest(out: dict, key: str, value: float) -> None:
    out[key] = max(out.get(key, 0.0), value)


def adaptation_gaps(got: dict, want: dict, grads: dict) -> dict:
    """A member's whole adaptation (each leaf's change ``got``) against the
    reference's (``want``).  A leaf's gap is the gap between the norms of
    its two changes, against the reference's norm of that leaf or of the
    median leaf, whichever is larger: ``dnorm`` is the median leaf's gap,
    ``dnorm_worst`` the worst leaf's, and ``dgap`` the worst norm of the
    changes' difference on the same scale.  Leaves whose first gradient in
    the reference (``grads``: norms) is under ``GRAD_FLOOR`` of the median
    leaf's are left out: Adam moves them by round-off alone."""
    floor = GRAD_FLOOR * float(np.median(list(grads.values())))
    keep = [k for k in want if grads[k] >= floor]
    norms = {k: float(want[k].norm()) for k in keep}
    median = float(np.median(list(norms.values())))
    scale = {k: max(norms[k], median) for k in keep}
    gaps = [abs(float(got[k].norm()) - norms[k]) / scale[k] for k in keep]
    return {"dnorm": float(np.median(gaps)), "dnorm_worst": max(gaps),
            "dgap": max(float((got[k] - want[k].to(got[k].device)).norm()) / scale[k] for k in keep)}


def reference_delta(full: dict, member: str) -> dict:
    """Each leaf's change in the reference's own adaptation of ``member``."""
    return delta(named_state(*full["start"][member]), named_state(*full["state"][member]))


def verify(p, window_scores: list, batch: int, picks: list) -> dict:
    """The numbers of the module's docstring for the sampled lanes
    ``picks`` (``(shard, lane)``) of global batch ``batch``, the port's
    models still loaded; returns ``{number: value}`` and the episodes."""
    cell, G, E = p.ref_cell, p.global_batch, p.lanes
    members = [m for m, _ in ref.adapting_members(cell)]
    program = lane_program(p)
    out = {k: 0.0 for k in NUMBERS}
    episodes = []
    for shard in sorted({s for s, _ in picks}):
        lanes = [j for s, j in picks if s == shard]
        first = batch * G + shard * E
        scores, rec = rerun(p, program, first, E, lanes)
        window = torch.stack([window_scores[first + j] for j in range(E)]).float()
        _widest(out, "rerun_gap", float((scores - window).abs().max()))
        adapts = dict(zip(members, rec["adapts"]))
        banks = dict(zip(members, (b["fmap"] for b in rec["banks"])))
        for i, j in enumerate(lanes):
            index = first + j
            episodes.append(index)
            full = ref.run_episode(p.sd_models, episode_images(p, index), episode_generator(p.seed, index), cell)
            ep, d = full["episode"], full["draws"]
            state = {m: _lane_block(adapts[m], i) for m in members}
            want = window_scores[index].float()
            got = {m: ref.member_scores(p.sd_models, ep, m, *state[m], Precision("float32")).float().cpu()
                   for m in members}
            port = [rec["members"][m][i] for m in members]
            _widest(out, "sum_gap", sum_gap(port, want))
            _widest(out, "score_gap", float((sum(got.values()) - want).abs().max()))
            for m, mine in zip(members, port):
                adapted = delta(port_start(adapts[m], j), named_state(*state[m]))
                readings = {**member_gaps(mine.float(), got[m]),
                            **adaptation_gaps(adapted, reference_delta(full, m), full["first_grads"][m])}
                for k, v in readings.items():
                    _widest(out, f"{k}.{m}", v)
                _widest(out, "bank_err", rel_err(banks[m][i], full["banks"][m]))
                rows = ref.member_steps(d, m, cell["batch"])[0]
                before, after = port_step(p, adapts[m], j, rows)
                bank_rows = adapts[m]["kw"]["fmap_bank"][j].float()
                r_before, r_after = reference_step(p.sd_models, ep, d, m, bank_rows, cell, "float32")
                _widest(out, "step_flip", _flip_share(delta(before, after), delta(r_before, r_after)))
    return out, episodes


def sum_gap(members: list, want: torch.Tensor) -> float:
    """The widest gap between the window's scores and the members' own
    scores summed in run order, in their dtype or in float32 (whichever
    the port sums in: both are exact sums of the same numbers)."""
    native = members[0]
    for m in members[1:]:
        native = native + m
    wide = sum(m.float() for m in members)
    return min(float((native.float() - want).abs().max()), float((wide - want).abs().max()))


#: reference probabilities below this carry no logit a comparison can read
LOGP_FLOOR = 1e-3


def member_gaps(got: torch.Tensor, want: torch.Tensor) -> dict:
    """A member's softmax scores against the reference's: the widest gap
    (``gap``) and the widest gap of their logarithms where the reference's
    probability is ``LOGP_FLOOR`` or more (``logp_gap``): the gap of the
    logits, which a saturated softmax hides."""
    keep = want >= LOGP_FLOOR
    logp = (torch.log(got.clamp(min=1e-30)) - torch.log(want))[keep].abs()
    return {"gap": float((got - want).abs().max()), "logp_gap": float(logp.max()) if keep.any() else 0.0}


def _lane_block(adapt_rec: dict, i: int) -> tuple:
    """Lane ``i`` of a recorded adaptation as reference-named ``(block,
    head)``."""
    block = _flat_block(pytree.tree_map(lambda t: t[i], adapt_rec["block"]))
    head = None if adapt_rec["head"] is None else {k: v[i] for k, v in adapt_rec["head"].items()}
    return block, head


def control_readings(p, index: int, precision: str = "float8", plant=None) -> dict:
    """The numbers 3 to 6 with the reference computed in ``precision`` put
    in the port's place (the control), against the float32 reference.
    ``plant``: a context manager factory that breaks the reference put in
    the port's place (a fault's readings)."""
    cell = p.ref_cell
    images = episode_images(p, index)
    hi = ref.run_episode(p.sd_models, images, episode_generator(p.seed, index), cell)
    with plant() if plant else contextlib.nullcontext():
        low = ref.run_episode(p.sd_models, images, episode_generator(p.seed, index), cell, precision)
    ep, d = low["episode"], low["draws"]
    members = [m for m, _ in ref.adapting_members(cell)]
    got = ref.scores_from_state(p.sd_models, ep, low["state"], Precision("float32"))
    out = {"rerun_gap": 0.0, "sum_gap": 0.0, "score_gap": float((got - low["scores"]).abs().max())}
    for m in members:
        fine = ref.member_scores(p.sd_models, ep, m, *low["state"][m], Precision("float32"))
        coarse = ref.member_scores(p.sd_models, ep, m, *low["state"][m], Precision(precision))
        readings = {**member_gaps(coarse.float(), fine.float()),
                    **adaptation_gaps(reference_delta(low, m), reference_delta(hi, m), hi["first_grads"][m])}
        out.update({f"{k}.{m}": v for k, v in readings.items()})
        _widest(out, "bank_err", rel_err(low["banks"][m], hi["banks"][m]))
        lo_step = reference_step(p.sd_models, ep, d, m, low["banks"][m], cell, precision)
        hi_step = reference_step(p.sd_models, ep, d, m, low["banks"][m], cell, "float32")
        _widest(out, "step_flip", _flip_share(delta(*lo_step), delta(*hi_step)))
    return out
