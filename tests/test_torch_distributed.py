"""Data-parallel training and eval over ``torch.distributed``
(mft_tpu_torch/parallel/distributed.py, the ``group`` of
train/steps.py, ops/norm.py's BN over a process group, cli/finetune.py
``evaluate`` over a group, parallel/dryrun.py) on the CPU with gloo, f64, at the
narrow widths of tests/test_torch_train_steps.py.

One global batch of E = 4 episodes (8 baseline rows) runs at world 1, 2 and
4 (one, two and four ranks a batch of 4), each world spawned once with
every job (``dryrun.run_step_jobs``), beside the same jobs in one process
(``group=None``) and JAX's steps on the same inputs and draws:

* the baseline step (BN statistics over every rank's rows), the episodic
  GnnNet and ProtoNet steps, the FO-MAML step in both BN modes (an explicit
  shared inner schedule), DampNet's plain, corrupt (JAX's own corruption
  through ``corrupt_x``) and recover steps, and the ResNet10_FW step with
  JAX's per-episode noise: against the one-process port step (loss rtol
  1e-10, every parameter, stat and Adam moment rtol 1e-10) and against
  JAX's step (the bounds of tests/test_torch_train_steps.py: rtol 1e-8, the
  meta fine-tune's 1e-6);
* the draws a generator makes (the FO-MAML inner schedules, ResNet10_FW's
  noise, DampNet's corruption): the whole batch's on every rank, each rank
  its slice's, equal to one process's at rtol 1e-10;
* world 1 through the group path: bit-equal to ``group=None``;
* every rank's outputs bit-equal to rank 0's;
* two steps of DampNet's prototype variant with the store refreshed from
  the gathered banks equal one process's; a store refreshed from each
  rank's own banks (the planted fault) parts at the second step;
* the baseline step with its BN's backward left on each rank (the dry
  run's planted fault there) keeps the loss and parts the gradients;
* a batch the world does not divide is refused;
* the dry run at world 2 (``dryrun.main``): the FO-MAML step within phase
  4's rules of one process, the planted fault outside them, and the
  rank-local eval's scores equal to one device's with every collective
  made to raise inside its lane batches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from mft_tpu.core import episode as jep
from mft_tpu.methods import dampnet as jdn
from mft_tpu.methods import gnnnet as jgn
from mft_tpu.models import backbone as jbb
from mft_tpu.train import inner_loop as jil
from mft_tpu.train import optimizers as jopt
from mft_tpu.train import steps as jsteps
from mft_tpu_torch import convert
from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.methods import dampnet as tdn
from mft_tpu_torch.methods import gnnnet as tgn
from mft_tpu_torch.parallel import distributed as pdist
from mft_tpu_torch.parallel import dryrun
from mft_tpu_torch.train import inner_loop as til
from mft_tpu_torch.train import steps as tsteps
from mft_tpu_torch.utils.checkpoint import keyed
from tests.test_torch_backbone_train import JFW, TFW, _model as _fw_model
from tests.test_torch_backbone_zoo import jax_fwt_draws
from tests.test_torch_train_steps import GKW, JCFG, SIZE, SPEC, TCFG, _check_step, _f64, _model, _np

E = 4
WORLDS = (1, 2, 4)
#: a spawned world's seconds before it fails the test instead of the suite
JOIN_TIMEOUT = 240.0
N_QUERY = SPEC[2]
DSMALL = dict(feat_dim=16, n_way=3, n_support=2, gnn_dim=16, gnn_nf=8, ntn_dim=8, mlp_hidden=16)
JDCFG, TDCFG = jdn.DampNetCfg(**DSMALL, stat="class"), tdn.DampNetCfg(**DSMALL, stat="class")
TPROTO = tdn.prototype_cfg(16, 3, 2)._replace(gnn_dim=16, gnn_nf=8, ntn_dim=8, mlp_hidden=16, mlp_hidden2=12,
                                                store_len=4)
#: the jobs held against JAX, and the meta fine-tune's looser bounds there
JAX_JOBS = ("baseline", "episodic", "protonet", "fine_tune_episode", "fine_tune_minibatch", "damp_plain",
            "damp_corrupt", "damp_recover", "fwt")
JOBS = JAX_JOBS + ("fine_tune_drawn", "fwt_drawn", "damp_corrupt_drawn", "proto_plain", "proto_recover",
                   "proto_plain_fault", "proto_recover_fault", "baseline_bn_fault")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 1, 2, 5, 3, 4))))


def _build():
    """The jobs (``dryrun.run_step_jobs``'s, in JOBS order) and JAX's
    outputs of the JAX_JOBS on the same inputs, f64."""
    rs = np.random.RandomState(0)
    gp, gs = _model("gnnnet", 3)
    bp, bs = _model("baseline", 4)
    xj = rs.rand(E, SPEC[0], SPEC[1] + N_QUERY, SIZE, SIZE, 3)
    xt = _nchw(xj)
    bx = rs.rand(8, SIZE, SIZE, 3)
    by = rs.randint(0, 10, 8)
    bank = SPEC[0] * SPEC[1]
    perms = np.stack([rs.permutation(bank) for _ in range(2)])
    jspec, tspec = jep.EpisodeSpec(*SPEC), EpisodeSpec(*SPEC)
    jg, tg = jgn.GnnNetCfg(**GKW), tgn.GnnNetCfg(**GKW)
    fwp, fws = _fw_model(JFW, "gnn")
    jkey = jax.random.PRNGKey(3)
    fwt_noise = [jax_fwt_draws(r, JFW) for r in jax.random.split(jkey, E)]
    jobs, want = {}, {}
    with jax.enable_x64():
        jd_params, jd_state = jax.jit(lambda k: jdn.init_dampnet(k, JDCFG))(jax.random.PRNGKey(1))
        jd_params = _f64(jd_params)
        jd_state = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
                                else jnp.asarray(a), jd_state)
        jd_state = jax.tree.map(np.asarray, jdn.update_prototypes(jd_state, jnp.asarray(rs.randn(40, 16))))
        fresh = lambda t: jax.tree.map(lambda a: jnp.array(a, copy=True), t)
        p, s = jax.tree.map(jnp.asarray, _f64(gp)), jax.tree.map(jnp.asarray, _f64(gs))
        tx = jopt.torch_adam(1e-3)
        want["episodic"] = _np(jsteps.episodic_train_step(fresh(p), fresh(s), tx.init(p), jnp.asarray(xj),
                                                          jax.random.PRNGKey(0), method="gnnnet", bcfg=JCFG, gcfg=jg, spec=jspec, tx=tx))
        pp = {"feature": p["feature"]}
        want["protonet"] = _np(jsteps.episodic_train_step(fresh(pp), fresh(s), tx.init(pp), jnp.asarray(xj),
                                                          jax.random.PRNGKey(0), method="protonet", bcfg=JCFG, gcfg=None, spec=jspec, tx=tx))
        for mode in ("episode", "minibatch"):
            icfg = jil.InnerLoopCfg(epochs=2, batch_size=4, bank_size=bank)
            want[f"fine_tune_{mode}"] = _np(jsteps.meta_finetune_train_step(
                fresh(p), fresh(s), tx.init(p), jnp.asarray(xj), jax.random.PRNGKey(0), method="gnnnet", bcfg=JCFG, gcfg=jg,
                spec=jspec, mcfg=jsteps.MetaFinetuneCfg(epochs=2, bn_mode=mode), tx=tx,
                schedule=jil.schedule_from_perms(perms, icfg)))
        b = jax.tree.map(jnp.asarray, _f64(bp))
        bst = jax.tree.map(jnp.asarray, _f64(bs))
        want["baseline"] = _np(jsteps.baseline_train_step(b, bst, tx.init(b), jnp.asarray(bx), jnp.asarray(by),
                                                          bcfg=JCFG, tx=tx))
        dparams = {"feature": p["feature"], **jax.tree.map(jnp.asarray, jd_params)}
        dstate = jax.tree.map(jnp.asarray, jd_state)
        drng = jax.random.PRNGKey(8)
        corrupt_x = np.stack([np.asarray(jdn.sample_corruption(
            k, jbb.apply_backbone(p["feature"], s, jep.flatten_episode(ep), cfg=JCFG, train=True)[0], 16,
            prototype=False)) for ep, k in zip(jnp.asarray(xj), jax.random.split(drng, E))])
        for mode in ("plain", "corrupt", "recover"):
            out = jsteps.dampnet_train_step(fresh(dparams), fresh(s), tx.init(dparams), fresh(dstate), jnp.asarray(xj), drng, mode=mode,
                                            bcfg=JCFG, dcfg=JDCFG, spec=jspec, tx=tx)
            want[f"damp_{mode}"] = _np(out)
        fp, fs = jax.tree.map(jnp.asarray, fwp), jax.tree.map(jnp.asarray, fws)
        ftx = jopt.freeze_masked(jopt.torch_adam(1e-3), jbb.fwt_trainable_mask(fp))
        want["fwt"] = _np(jsteps.episodic_train_step(fp, fs, ftx.init(fp), jnp.asarray(xj), jkey, method="gnnnet",
                                                     bcfg=JFW, gcfg=jg, spec=jspec, tx=ftx))

    tp, ts = convert.from_jax(_f64(gp), _f64(gs))
    tbp, tbs = convert.from_jax(_f64(bp), _f64(bs))
    tdp, tds = convert.from_jax({"feature": _f64(gp)["feature"], **jd_params}, _f64(gs))
    tdstate = convert.from_jax(jd_params, jd_state)[1]
    tfp, tfs = convert.from_jax(fwp, fws)
    tsched = til.schedule_from_perms(perms, til.InnerLoopCfg(epochs=2, batch_size=4, bank_size=bank))
    gkw = dict(bcfg=TCFG, gcfg=tg, spec=tspec)
    ep = lambda mode: dict(method="gnnnet", mcfg=tsteps.MetaFinetuneCfg(epochs=2, bn_mode=mode), **gkw)
    dkw = dict(bcfg=TCFG, dcfg=TDCFG, spec=tspec)
    gen = lambda seed: torch.Generator().manual_seed(seed)
    jobs["baseline"] = dict(step="baseline_train_step", params=tbp, stats=tbs,
                            args=[torch.from_numpy(np.ascontiguousarray(np.transpose(bx, (0, 3, 1, 2)))),
                                  torch.from_numpy(by)], kwargs=dict(bcfg=TCFG), local=(0, 1))
    jobs["baseline_bn_fault"] = dict(jobs["baseline"], fault="bn_backward_local")
    jobs["episodic"] = dict(step="episodic_train_step", params=tp, stats=ts, args=[xt], local=(0,),
                            kwargs=dict(method="gnnnet", **gkw))
    jobs["protonet"] = dict(step="episodic_train_step", params={"feature": tp["feature"]}, stats=ts, args=[xt],
                            local=(0,), kwargs=dict(method="protonet", bcfg=TCFG, gcfg=None, spec=tspec))
    for mode in ("episode", "minibatch"):
        jobs[f"fine_tune_{mode}"] = dict(step="meta_finetune_train_step", params=tp, stats=ts, args=[xt, None],
                                         local=(0,), kwargs=dict(schedule=tsched, **ep(mode)))
    jobs["fine_tune_drawn"] = dict(step="meta_finetune_train_step", params=tp, stats=ts, args=[xt, gen(5)],
                                   local=(0,), kwargs=ep("episode"))
    for mode in ("plain", "corrupt", "recover"):
        jobs[f"damp_{mode}"] = dict(step="dampnet_train_step", params=tdp, stats=tds, args=[tdstate, xt, None],
                                    local=(1,), kwargs=dict(mode=mode, corrupt_x=torch.from_numpy(corrupt_x)
                                                            if mode == "corrupt" else None, **dkw))
    jobs["damp_corrupt_drawn"] = dict(step="dampnet_train_step", params=tdp, stats=tds,
                                      args=[tdstate, xt, gen(6)], local=(1,),
                                      kwargs=dict(mode="corrupt", **dkw))
    fkw = dict(method="gnnnet", bcfg=TFW, gcfg=tg, spec=tspec)
    jobs["fwt"] = dict(step="episodic_train_step", params=tfp, stats=tfs, args=[xt], local=(0,),
                       kwargs=dict(fwt_noise=fwt_noise, **fkw))
    jobs["fwt_drawn"] = dict(step="episodic_train_step", params=tfp, stats=tfs, args=[xt], local=(0,),
                             kwargs=dict(fwt_noise=gen(9), **fkw))
    php, phs = tdn.init_dampnet(gen(7), TPROTO, dtype=torch.float64)
    pparams = {"feature": tp["feature"], **php}
    for tag, refresh in (("", "gathered"), ("_fault", "local")):
        pkw = dict(bcfg=TCFG, dcfg=TPROTO, spec=tspec)
        jobs["proto_plain" + tag] = dict(step="dampnet_train_step", params=pparams, stats=ts, args=[phs, xt, None],
                                         local=(1,), kwargs=dict(mode="plain", **pkw), refresh=refresh)
        jobs["proto_recover" + tag] = dict(step="dampnet_train_step", params=pparams, stats=ts, args=[phs, xt, None],
                                           local=(1,), kwargs=dict(mode="recover", **pkw), chain=True,
                                           refresh=refresh)
    return [jobs[k] for k in JOBS], want


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """Every world spawned once (``dryrun.Ranks``), running while JAX's
    steps and the one-process port run here."""
    jobs, want = _build()
    ranks = {w: dryrun.Ranks(w, dryrun.run_step_jobs, jobs, device="cpu") for w in WORLDS}
    one = dict(zip(JOBS, dryrun.run_step_jobs(None, torch.device("cpu"), jobs)))
    results, errors = {}, {}
    for w, r in ranks.items():
        try:
            results[w] = r.join(JOIN_TIMEOUT)
        except (RuntimeError, TimeoutError) as e:  # reported by the tests that need the world
            errors[w] = e
    return {"want": want, "one": one, "results": results, "errors": errors}


def _world(case, world):
    if world in case["errors"]:
        raise case["errors"][world]
    assert world in case["results"], f"world {world} did not finish"
    return case["results"][world]


def _assert_close(got, want, rtol, label):
    """Two port outputs ``(params, stats, opt_state, metrics)`` leaf by leaf:
    rtol, atol 1e-12 of each leaf's largest value plus 1e-12 of the tree's
    (a bias before a batch-statistics BN has a gradient that is zero in
    exact arithmetic: f64 noise that two Adam steps carry to some 1e-13)."""
    ga, wa = keyed(got), keyed(want)
    assert ga.keys() == wa.keys(), label
    floats = [v for v in wa.values() if isinstance(v, torch.Tensor) and v.is_floating_point() and v.numel()]
    tree_max = max(float(v.abs().max()) for v in floats)
    for k, w in wa.items():
        if not isinstance(w, torch.Tensor):
            assert ga[k] == w, f"{label} {k}"
            continue
        w = w.double().numpy() if w.is_floating_point() else w.numpy()
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(ga[k].numpy(), w, rtol=rtol, atol=1e-12 * scale + 1e-12 * tree_max,
                                   err_msg=f"{label} {k}")


@pytest.mark.parametrize("job", [j for j in JOBS if not j.endswith("_fault")])
@pytest.mark.parametrize("world", [2, 4])
def test_step_matches_one_process(case, world, job):
    got = _world(case, world)[0][JOBS.index(job)]
    _assert_close(got, case["one"][job], 1e-10, f"world {world} {job}")


@pytest.mark.parametrize("job", JAX_JOBS)
@pytest.mark.parametrize("world", [2, 4])
def test_step_matches_jax(case, world, job):
    got, want = _world(case, world)[0][JOBS.index(job)], case["want"][job]
    if job.startswith("damp"):
        tp, ts, to, tm = got
        jp, js, jo, jm = want
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-10)
        gp, gs = convert.to_jax(tp, ts)
        from tests.test_golden_reference import _assert_tree_close

        _assert_tree_close(gp, jp, rtol=1e-8, atol_frac=1e-10, label="params")
        _assert_tree_close(gs, js, rtol=1e-9, atol_frac=1e-12, label="stats")
        np.testing.assert_allclose(tm["support_bank"].numpy(), jm["support_bank"], rtol=1e-10, atol=1e-13)
    elif job == "fwt":
        from tests.test_torch_backbone_train import _check

        _check(got, want)
    elif job.startswith("fine_tune"):
        _check_step(got, want, loss_rtol=1e-8, rtol=1e-6, stats_rtol=1e-8)
    else:
        _check_step(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_bit_equal(case, world):
    """Every rank's outputs bit-equal to rank 0's (and, for DampNet, the
    gathered banks); at world 1 the group path bit-equal to ``group=None``."""
    ranks = _world(case, world)
    for r, res in enumerate(ranks[1:], 1):
        for job, a, b in zip(JOBS, res, ranks[0]):
            if job.endswith("_fault"):
                continue
            la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
            assert len(la) == len(lb) and all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                                             for x, y in zip(la, lb)), f"world {world} rank {r} {job}"
    if world == 1:
        for job, a in zip(JOBS, ranks[0]):
            la, lb = pytree.tree_leaves(a), pytree.tree_leaves(case["one"][job])
            assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb)), job
    checks = {pdist.tree_checksum(res[JOBS.index("fine_tune_drawn")][0]) for res in ranks}
    assert len(checks) == 1


@pytest.mark.parametrize("world", [2, 4])
def test_prototype_store_refresh_from_gathered_banks(case, world):
    """Two prototype-variant steps (plain, then recover off the refreshed
    store) equal one process's; a store refreshed from each rank's own
    banks (the planted fault) keeps the first step and parts at the
    second."""
    ranks = _world(case, world)
    one = case["one"]
    res = ranks[0]
    loss = lambda job, src: float(src[JOBS.index(job)][3]["loss"]) if src is res else float(src[job][3]["loss"])
    for job in ("proto_plain", "proto_recover"):
        np.testing.assert_allclose(loss(job, res), loss(job, one), rtol=1e-10)
    np.testing.assert_allclose(loss("proto_plain_fault", res), loss("proto_plain", one), rtol=1e-10)
    assert abs(loss("proto_recover_fault", res) - loss("proto_recover", one)) > 1e-6 * abs(loss("proto_recover", one))


@pytest.mark.parametrize("world", [2, 4])
def test_bn_backward_fault_parts_the_gradients(case, world):
    """The dry run's planted fault on the baseline step, the BN over the
    ranks with a rank-local backward (its forward sums still synced): the
    loss stays one process's, the gradients (Adam's first moments after one
    step) part from it."""
    got, one = _world(case, world)[0][JOBS.index("baseline_bn_fault")], case["one"]["baseline"]
    np.testing.assert_allclose(float(got[3]["loss"]), float(one[3]["loss"]), rtol=1e-10)
    mu_got, mu_one = keyed(got[2]), keyed(one[2])
    apart = max(float((mu_got[k] - v).abs().max()) / max(float(v.abs().max()), 1e-300)
                for k, v in mu_one.items() if isinstance(v, torch.Tensor) and v.is_floating_point() and v.numel())
    assert apart > 1e-3, f"world {world}: the rank-local BN backward left the gradients within {apart:.3e}"


def test_episode_slice_refuses_a_ragged_batch():
    assert pdist.episode_slice(1, 2, 4) == slice(2, 4)
    assert pdist.episode_slice(3, 4, 8) == slice(6, 8)
    with pytest.raises(ValueError, match="do not split evenly"):
        pdist.episode_slice(0, 2, 3)
    with pytest.raises(ValueError, match="do not split evenly"):
        pdist.episode_slice(0, 4, 6)
    with pytest.raises(ValueError, match="not in a world"):
        pdist.episode_slice(2, 2, 4)


def test_no_collectives_guard_raises():
    with dryrun.no_collectives():
        with pytest.raises(RuntimeError, match="inside the eval"):
            dist.all_reduce(torch.zeros(1))
        with pytest.raises(RuntimeError, match="inside the eval"):
            dist.all_gather_object([None], 0)
    assert dist.all_reduce.__name__ == "all_reduce"


def test_dryrun_world_2_on_cpu(capsys):
    """The dry run's default run at world 2: the FO-MAML step within phase
    4's rules of one process, the planted fault caught, the ranks' trees
    bit-equal, and the rank-local eval (every collective raising inside its
    lane batches) equal to one device's scores."""
    assert dryrun.main(["--world", "2", "--device", "cpu", "--timeout", str(JOIN_TIMEOUT)]) == 0
    out = capsys.readouterr().out
    assert "fine_tune step" in out and "trees bit-equal on 2 ranks" in out
    assert "planted fault" in out and "caught by" in out
    assert "scores equal to one device's" in out
