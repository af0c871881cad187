"""The port's synthetic full pipeline (mft_tpu_torch/examples/synthetic_pipeline.py)
against the JAX library calls that examples/synthetic_pipeline.py makes.

(a) The chain, stage by stage, on the script's manifests and streams
(synthetic seed 3, held-out tints seed 99; ``BatchStream`` seed 5,
``EpisodeStream`` seeds ``1000 + step``, ``5000 + step``, ``70 + batch``):
2 baseline steps of 8 images, 2 episodic GnnNet steps of 2 episodes, 1
FO-MAML step of 2 episodes (15 inner epochs of batch 4), then one
``--method all`` batch of 2 held-out episodes (``gen_examples=0``, one epoch
per member) through the port's eval program (``make_eval_program``, as
``main`` runs it) against JAX's members on the raw episodes.  Each
package's chain runs from its own previous stage.  The draws are explicit
and shared: the training stages' augment views at explicit draws (the
port's; JAX's warp and jitter at the same draws give them within 1e-4, the
2e-5 of tests/test_torch_augment.py through normalization's 1/std of at
most 4.45), the inner schedules and the classifier init; each package
centres the held-out episodes itself.  A narrow
ResNet10-shaped backbone (widths 8, 12, 14, 16) computes in f64 in both
packages (``compute_dtype='float64'``, ``jax.enable_x64``), at 64 px (at 32
px the final block sees 1x1 maps and its batch statistics amplify rounding,
tests/test_torch_slice.py); the GnnNet head takes the plain edge op, since
the Pallas path runs in f32 in both packages (its kernel is held against
the Pallas kernel in interpret mode in tests/test_torch_gnn.py).
Tolerances, f64: losses rtol 1e-10 and parameters, running stats and Adam
moments rtol 1e-8 (atol 1e-10 of each tensor's largest value) after stages
1 and 2; the FO-MAML stage at the JAX golden test's bounds, loss rtol 1e-8
and parameters rtol 1e-6 (15 inner Adam(0.01) steps amplify roundoff);
the held-out scores atol 5e-5 and the same argmax: the two packages' f32
centre views part by up to 2e-5 (tests/test_torch_augment.py; 5.2e-6 on
these episodes), and the scores move by less than the views (3.0e-6 for
5.2e-6 measured).  Measured: parameters within 1.4e-10 of each tensor's
largest value, losses 3.3e-14 relative; scores 3.0e-6 apart (5.8e-13
relative when JAX is given the port's views).

(b) ``main(["--device", "cpu", ...])`` at the smallest counts: finite
losses in every stage and accuracies in [0, 100].
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mft_tpu.core.episode import EpisodeSpec as JSpec
from mft_tpu.data import manifests as jmf
from mft_tpu.data.pipeline import BatchStream as JBatchStream
from mft_tpu.data.pipeline import EpisodeStream as JEpisodeStream
from mft_tpu.methods import gnnnet as jgn
from mft_tpu.models import backbone as jbb
from mft_tpu.ops import augment as jaug
from mft_tpu.train import eval_engine as jee
from mft_tpu.train import inner_loop as jil
from mft_tpu.train import optimizers as jopt
from mft_tpu.train import steps as jsteps
from mft_tpu_torch import convert
from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.data import manifests as tmf
from mft_tpu_torch.data import registry
from mft_tpu_torch.data.pipeline import BatchStream, EpisodeStream
from mft_tpu_torch.examples import synthetic_pipeline as sp
from mft_tpu_torch.methods import gnnnet as tgn
from mft_tpu_torch.methods.baseline import init_classifier
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.ops import augment as taug
from mft_tpu_torch.train import eval_engine as tee
from mft_tpu_torch.train import inner_loop as til
from tests.test_golden_reference import _assert_tree_close

WIDTHS = (8, 12, 14, 16)
JCFG = jbb.ResNetCfg((1, 1, 1, 1), WIDTHS, "simple", flatten=True, compute_dtype="float64")
TCFG = tbb.ResNetCfg((1, 1, 1, 1), WIDTHS, compute_dtype="float64")
GKW = dict(feat_dim=16, n_way=3, n_support=2, proj_dim=16, gnn_nf=8)
TRAIN, EVAL = (3, 2, 2), (3, 2, 3)  # n_way, n_support, n_query
SIZE, BATCH, EPISODES, LANES = 64, 8, 2, 2
STEPS = {"baseline": 2, "episodic": 2, "fine_tune": 1}
N_CLASSES = sp.N_CLASSES
INNER = dict(epochs=15, batch_size=4, bank_size=TRAIN[0] * TRAIN[1])
GNN_ROWS, LIN_ROWS = 3 * EVAL[0] * EVAL[1], EVAL[0] * EVAL[1]  # the clean support three times; once


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _man(seed):
    kw = dict(n_classes=N_CLASSES, per_class=sp.PER_CLASS, base_size=sp.BASE, seed=seed)
    return tmf.synthetic(**kw), jmf.synthetic(**kw)


def _chw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


def _hwc(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(t.numpy(), -3, -1))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    """The explicit draws and initial trees both packages share."""
    g = torch.Generator().manual_seed(11)
    acfg = registry.get("synthetic").train_aug._replace(image_size=SIZE)
    per_ep = TRAIN[0] * (TRAIN[1] + TRAIN[2])
    draws = {"baseline": [taug.augment_draws(g, BATCH) for _ in range(STEPS["baseline"])],
             "episodic": [taug.augment_draws(g, EPISODES * per_ep) for _ in range(STEPS["episodic"])],
             "fine_tune": [taug.augment_draws(g, EPISODES * per_ep) for _ in range(STEPS["fine_tune"])]}
    rs = np.random.RandomState(12)
    ft_perms = [np.stack([rs.permutation(INNER["bank_size"]) for _ in range(INNER["epochs"])])
                for _ in range(STEPS["fine_tune"])]
    lin_perms = [np.stack([rs.permutation(LIN_ROWS)]) for _ in range(LANES)]
    gnn_perms = [np.stack([rs.permutation(GNN_ROWS)]) for _ in range(LANES)]
    heads = [{"w": rs.randn(EVAL[0], 16) * 0.2, "b": rs.randn(EVAL[0]) * 0.1} for _ in range(LANES)]  # port layout
    g0 = torch.Generator().manual_seed(0)
    f64 = torch.float64
    feature, stats = tbb.init_backbone(g0, TCFG, dtype=f64)
    params_b = {"feature": feature, "classifier": init_classifier(g0, 16, N_CLASSES, dtype=f64)}
    head = tgn.init_head(torch.Generator().manual_seed(2), tgn.GnnNetCfg(**GKW), dtype=f64)
    return dict(acfg=acfg, draws=draws, ft_perms=ft_perms, lin_perms=lin_perms, gnn_perms=gnn_perms, heads=heads,
                params_b=params_b, stats=stats, head=head)


def _port_chain(s):
    man, _ = _man(3)
    eman, _ = _man(99)
    gcfg = tgn.GnnNetCfg(**GKW)
    kw = dict(gen=None, device="cpu", bcfg=TCFG, aug_cfg=s["acfg"])
    spec = EpisodeSpec(*TRAIN)
    s1 = sp.pretrain_baseline(man, s["params_b"], s["stats"], steps=STEPS["baseline"], batch_size=BATCH,
                              draws=s["draws"]["baseline"], **kw)
    params = {"feature": sp._copy(s1.params["feature"]), **s["head"]}
    s2 = sp.meta_train(man, params, sp._copy(s1.stats), steps=STEPS["episodic"], gcfg=gcfg, spec=spec,
                       episodes=EPISODES, draws=s["draws"]["episodic"], **kw)
    icfg = til.InnerLoopCfg(**INNER)
    s3 = sp.meta_finetune(man, s2.params, s2.stats, s2.opt_state, steps=STEPS["fine_tune"], gcfg=gcfg, spec=spec,
                          episodes=EPISODES, draws=s["draws"]["fine_tune"],
                          schedules=[til.schedule_from_perms(p, icfg) for p in s["ft_perms"]], **kw)
    stack = lambda perms, rows: til.stack_schedules([til.schedule_from_perms(p, til.InnerLoopCfg(1, 5, rows))
                                                     for p in perms])
    heads = {k: torch.from_numpy(np.stack([h[k] for h in s["heads"]])) for k in ("w", "b")}
    models = {"baseline": (s1.params["feature"], s1.stats),
              "gnn": (s3.params["feature"], s3.stats, {"fc": s3.params["fc"], "gnn": s3.params["gnn"]})}
    eval_kw = dict(bcfg=TCFG, gcfg=gcfg, spec=EpisodeSpec(*EVAL), gen_examples=0,
                   tcfg=tee.TransferCfg(fine_tune_epochs=1, linear_epochs=1, opt_state_dtype="float32"),
                   aug_cfg=registry.get("synthetic").eval_aug._replace(image_size=SIZE))
    draws = dict(inner_schedule=(stack(s["lin_perms"], LIN_ROWS), stack(s["gnn_perms"], GNN_ROWS)), head0=heads)
    ev = sp.heldout_eval(eman, models, batches=1, lanes=LANES, gen=None, device="cpu",
                         schedules=[draws["inner_schedule"]], heads=[heads], **eval_kw)
    return {"baseline": s1, "episodic": s2, "fine_tune": s3, "eval": ev,
            "eval_inputs": (eman, models, eval_kw, draws)}


def _views(images, draws, acfg):
    """The shared augment views of host images ``[..., H, W, 3]``, NHWC."""
    return _hwc(taug.augment_with_draws(_chw(images), draws, acfg))


def _jax_chain(s):
    """examples/synthetic_pipeline.py's library calls at the shared draws."""
    _, man = _man(3)
    _, eman = _man(99)
    acfg, draws = s["acfg"], s["draws"]
    jg = jgn.GnnNetCfg(**GKW)
    spec = JSpec(*TRAIN)
    out = {}
    with jax.enable_x64():
        p, st = convert.to_jax(s["params_b"], s["stats"])
        txb = jopt.torch_adam(1e-3)
        ob = txb.init(_jnp(p))
        bstep = jax.jit(lambda p, s, o, x, y: jsteps.baseline_train_step(p, s, o, x, y, bcfg=JCFG, tx=txb))
        losses, batches = [], []
        for i, (bx, by) in enumerate(JBatchStream(man, BATCH, STEPS["baseline"], base_size=sp.BASE, seed=5)):
            batches.append((bx, by))
            p, st, ob, m = bstep(p, st, ob, jnp.asarray(_views(bx, draws["baseline"][i], acfg)), jnp.asarray(by))
            losses.append(float(m["loss"]))
        out["baseline"] = (_np(p), _np(st), ob, losses)
        out["batches"] = batches

        head, _ = convert.to_jax(s["head"])
        pg = {"feature": jax.tree.map(jnp.copy, p["feature"]), "fc": head["fc"], "gnn": head["gnn"]}
        sg = jax.tree.map(jnp.copy, st)
        txg = jopt.torch_adam(1e-3)
        og = txg.init(_jnp(pg))
        gstep = jax.jit(lambda p, s, o, x: jsteps.episodic_train_step(
            p, s, o, x, jax.random.PRNGKey(0), method="gnnnet", bcfg=JCFG, gcfg=jg, spec=spec, tx=txg))
        losses, eps_seen = [], []
        for i in range(STEPS["episodic"]):
            eps = np.stack([im for im, _ in JEpisodeStream(man, spec, EPISODES, base_size=sp.BASE, seed=1000 + i)])
            eps_seen.append(eps)
            pg, sg, og, m = gstep(pg, sg, og, jnp.asarray(_views(eps, draws["episodic"][i], acfg)))
            losses.append(float(m["loss"]))
        out["episodic"] = (_np(pg), _np(sg), og, losses)
        out["episodes"] = eps_seen

        mcfg = jsteps.MetaFinetuneCfg(epochs=15, batch_size=4)
        mstep = jax.jit(lambda p, s, o, x, idx, w: jsteps.meta_finetune_train_step(
            p, s, o, x, jax.random.PRNGKey(0), method="gnnnet", bcfg=JCFG, gcfg=jg, spec=spec, mcfg=mcfg, tx=txg,
            schedule=(idx, w)))
        losses = []
        for i in range(STEPS["fine_tune"]):
            eps = np.stack([im for im, _ in JEpisodeStream(man, spec, EPISODES, base_size=sp.BASE, seed=5000 + i)])
            idx, w = jil.schedule_from_perms(s["ft_perms"][i], jil.InnerLoopCfg(**INNER))
            pg, sg, og, m = mstep(pg, sg, og, jnp.asarray(_views(eps, draws["fine_tune"][i], acfg)), idx, w)
            losses.append(float(m["loss"]))
        out["fine_tune"] = (_np(pg), _np(sg), og, losses)

        # the held-out batch: JAX's own clean views of the raw episodes, as its
        # eval program centres them (the pipeline dtype of an f64 backbone, f32)
        espec = JSpec(*EVAL)
        tcfg = jee.TransferCfg(fine_tune_epochs=1, linear_epochs=1, opt_state_dtype="float32")
        eacfg = jaug.AugmentCfg(image_size=SIZE)
        k = jax.random.PRNGKey(0)
        kw = dict(bcfg=JCFG, spec=espec, tcfg=tcfg, aug_cfg=eacfg, gen_examples=0)
        gnn_head = {"fc": pg["fc"], "gnn": pg["gnn"]}

        def episode_scores(base, li, lw, gi, gw, h0):
            ep = jaug.center_batch(base, SIZE, dtype=jaug.pipeline_dtype(JCFG.compute_dtype))
            sup = base[:, : EVAL[1]]
            lin = jee.linear_member_scores(p["feature"], st, ep, sup, k, k, inner_schedule=(li, lw), head0=h0, **kw)
            gnn = jee.gnn_member_scores(pg["feature"], sg, gnn_head, ep, sup, k, k, gcfg=jg,
                                        inner_schedule=(gi, gw), **kw)
            return lin + gnn

        eps = np.stack([im for im, _ in JEpisodeStream(eman, espec, LANES, base_size=sp.BASE, seed=70)])
        fn = jax.jit(episode_scores)
        scores = []
        for i in range(LANES):
            li, lw = jil.schedule_from_perms(s["lin_perms"][i], jil.InnerLoopCfg(1, 5, LIN_ROWS))
            gi, gw = jil.schedule_from_perms(s["gnn_perms"][i], jil.InnerLoopCfg(1, 5, GNN_ROWS))
            h0 = {"w": s["heads"][i]["w"].T, "b": s["heads"][i]["b"]}  # JAX layout
            scores.append(np.asarray(fn(eps[i], li, lw, gi, gw, h0)))
        out["eval"] = np.stack(scores)
        out["eval_episodes"] = eps
    return out


@pytest.fixture(scope="module")
def chains(inputs):
    return _port_chain(inputs), _jax_chain(inputs)


def _check_stage(port, want, *, loss_rtol, rtol):
    jp, js, jo, jl = want
    np.testing.assert_allclose(port.losses, jl, rtol=loss_rtol)
    got_p, got_s = convert.to_jax(port.params, port.stats)
    _assert_tree_close(got_p, jp, rtol=rtol, atol_frac=1e-10, label="params")
    _assert_tree_close(got_s, js, rtol=rtol, atol_frac=1e-12, label="stats")
    moments = convert.adam_to_jax(port.opt_state)
    assert moments["count"] == int(jo[0].count)
    _assert_tree_close(moments["mu"], _np(jo[0].mu), rtol=rtol, atol_frac=1e-10, label="mu")
    _assert_tree_close(moments["nu"], _np(jo[0].nu), rtol=rtol, atol_frac=1e-10, label="nu")


def test_streams_and_views_are_the_jax_scripts(inputs, chains):
    """The port's streams give the JAX streams' batches and episodes, and
    the shared views are JAX's warp and jitter at the same draws."""
    _, want = chains
    man, _ = _man(3)
    for (bx, by), (jx, jy) in zip(BatchStream(man, BATCH, STEPS["baseline"], base_size=sp.BASE, seed=5),
                                  want["batches"]):
        np.testing.assert_array_equal(bx, jx)
        np.testing.assert_array_equal(by, jy)
    spec = EpisodeSpec(*TRAIN)
    for i, jeps in enumerate(want["episodes"]):
        eps = np.stack([im for im, _ in EpisodeStream(man, spec, EPISODES, base_size=sp.BASE, seed=1000 + i)])
        np.testing.assert_array_equal(eps, jeps)
    eman, _ = _man(99)
    eps = np.stack([im for im, _ in EpisodeStream(eman, EpisodeSpec(*EVAL), LANES, base_size=sp.BASE, seed=70)])
    np.testing.assert_array_equal(eps, want["eval_episodes"])

    acfg, u = inputs["acfg"], inputs["draws"]["baseline"][0]
    images = want["batches"][0][0]
    top, left, ch, cw = (np.asarray(v) for v in taug._sample_crop(u[:, :4], sp.BASE, sp.BASE, acfg))
    r = (np.asarray([acfg.brightness, acfg.contrast, acfg.color]) * (2.0 * u[:, 4:7].numpy() - 1.0) + 1.0)

    def view(im, t, l, h, w, fh, rb, rc, rs):
        img = jnp.clip(jaug._crop_resize(jaug.to_float(im), t, l, h, w, SIZE, flip_h=fh), 0.0, 1.0)
        return jaug.normalize(jaug.apply_enhance(img, rb, rc, rs))

    jviews = jax.jit(jax.vmap(view))(images, top, left, ch, cw, u[:, 7].numpy() < 0.5, r[:, 0], r[:, 1], r[:, 2])
    np.testing.assert_allclose(_views(images, u, acfg), np.asarray(jviews), atol=1e-4)


def test_baseline_stage_matches_jax(chains):
    port, want = chains
    _check_stage(port["baseline"], want["baseline"], loss_rtol=1e-10, rtol=1e-8)
    assert len(port["baseline"].top1) == STEPS["baseline"]


def test_episodic_stage_matches_jax(chains):
    port, want = chains
    _check_stage(port["episodic"], want["episodic"], loss_rtol=1e-10, rtol=1e-8)


def test_finetune_stage_matches_jax(chains):
    port, want = chains
    _check_stage(port["fine_tune"], want["fine_tune"], loss_rtol=1e-8, rtol=1e-6)


def test_heldout_scores_match_jax(chains):
    port, want = chains
    ev = port["eval"]
    got = ev.scores[0].numpy()
    assert got.shape == (LANES, EVAL[0] * EVAL[2], EVAL[0])
    np.testing.assert_allclose(got, want["eval"], rtol=0, atol=5e-5)
    np.testing.assert_array_equal(got.argmax(-1), want["eval"].argmax(-1))
    spec = JSpec(*EVAL)
    want_accs = [float(jee.episode_accuracy(jnp.asarray(s), spec)) for s in want["eval"]]
    np.testing.assert_allclose(ev.accs, want_accs)
    assert (ev.mean, ev.ci95) == pytest.approx(tuple(float(v) for v in jee.mean_ci95(np.asarray(want_accs))))


def test_explicit_draws_reach_every_ensemble_route(chains):
    """The eval program's explicit draws drive the lane-fused ensemble
    (``ensemble_fuse='lane'``: both members' inner loops step together) to
    the sequential members' scores, within f64 rounding (rtol 1e-10); in the
    minibatch BN mode the program's lanes at the same draws give the member
    lanes' scores on the replica banks the program builds (rtol 1e-10)."""
    port, _ = chains
    eman, models, kw, draws = port["eval_inputs"]
    base = sp._episodes(eman, kw["spec"], LANES, sp.BASE, 70, "cpu")
    fused = tee.make_eval_program(method="all", **{**kw, "tcfg": kw["tcfg"]._replace(ensemble_fuse="lane")})
    got, accs = fused(models, base, [None] * LANES, **draws)
    np.testing.assert_allclose(got.numpy(), port["eval"].scores[0].numpy(), rtol=1e-10, atol=1e-14)
    assert accs == port["eval"].accs
    tcfg = kw["tcfg"]._replace(bn_mode="minibatch")
    minibatch = tee.make_eval_program(method="all", **{**kw, "tcfg": tcfg})
    got, accs = minibatch(models, base, [None] * LANES, **draws)
    spec, acfg = kw["spec"], kw["aug_cfg"]
    episodes = taug.center_batch(base, acfg.image_size, dtype=taug.pipeline_dtype(kw["bcfg"].compute_dtype))
    banks = torch.stack([taug.make_eval_replicas(None, s, acfg, kw["gen_examples"]) for s in base[:, :, : spec.n_support]])
    mkw = dict(bcfg=kw["bcfg"], spec=spec, tcfg=tcfg, aug_cfg=acfg, gen_examples=kw["gen_examples"])
    sched_lin, sched_gnn = draws["inner_schedule"]
    want = (tee.linear_member_lanes(*models["baseline"], episodes, banks, [None] * LANES, inner_schedule=sched_lin,
                                    head0=draws["head0"], **mkw)
            + tee.gnn_member_lanes(*models["gnn"], episodes, banks, [None] * LANES, gcfg=kw["gcfg"],
                                   inner_schedule=sched_gnn, **mkw))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-14)
    assert accs == tee.lane_accuracies(want, spec)


def test_main_on_the_cpu_at_the_smallest_counts(monkeypatch):
    """``main`` through every stage at full width on the CPU, one step or
    batch of each and one episode a step or batch (the episodes, lanes and
    replicas are the module's constants), the edge op and the fused scan in
    their plain versions; no kernel launches off the card."""
    for name, value in (("EPISODES", 1), ("EVAL_LANES", 1), ("GEN_EXAMPLES", 0)):
        monkeypatch.setattr(sp, name, value)
    res = sp.main(["--device", "cpu", "--steps", "1", "--baseline_steps", "1", "--finetune_steps", "1",
                   "--eval_batches", "1", "--use_pallas", "--inner_scan", "fused"])
    for stage, n in (("baseline", 1), ("episodic", 1), ("fine_tune", 1)):
        assert len(res["losses"][stage]) == n and all(math.isfinite(v) for v in res["losses"][stage]), res["losses"]
    assert len(res["accs"]) == 1 and all(0.0 <= v <= 100.0 for v in res["accs"])
    assert math.isfinite(res["acc"]) and set(res["seconds"]) == {"baseline", "episodic", "fine_tune", "eval"}
    assert all(c == 0 for counts in res["launches"].values() for c in counts.values())
    assert res["peak_bytes"] is None


def test_main_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        sp.main(["--steps", "1"])
