"""The eval (mft_tpu_torch/train/eval_engine.py, cli/finetune.py) on the
other backbones: ResNet18's structural last block (512 -> 512, identity
shortcut; README "Documented deviations") and ResNet10_FW's noise strengths,
which ride the adapted block unused.

* Lanes, f64: an E = 3 batch of the GNN and linear members on a ResNet18-
  and a ResNet10_FW-shaped backbone equals each episode alone with the same
  generator (``gen_examples=1``) and the JAX member on that episode with the
  same explicit draws (``gen_examples=0``): rtol 1e-8, as
  tests/test_torch_eval_lanes.py.
* ResNet10_FW at full width, 64 px, f32, bf16 Adam moments:
  ``inner_scan='fused'`` (the scan's plain version on the CPU) against
  ``'eager'`` on the same schedule, at the bounds of
  tests/test_torch_fused_inner_scan.py (atol 2e-2 on the softmax scores,
  the same argmax), with one scan call on the ResNet10 geometry; the noise
  strengths come out of both loops bit for bit.
* The fused scan refuses ResNet18 (the engine and the driver), and the
  drivers run ResNet18 (eager) and ResNet10_FW (fused) end to end at 32 px.
"""

import json
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mft_tpu.core import episode as jep
from mft_tpu.methods import gnnnet as jgn
from mft_tpu.models import backbone as jbb
from mft_tpu.ops import augment as jaug
from mft_tpu.train import eval_engine as jee
from mft_tpu.train import inner_loop as jil
from mft_tpu_torch import convert
from mft_tpu_torch.core import episode as tep
from mft_tpu_torch.kernels import fused_inner_scan as tfis
from mft_tpu_torch.methods import gnnnet as tgn
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.ops import augment as taug
from mft_tpu_torch.train import eval_engine as tee
from mft_tpu_torch.train import inner_loop as til
from mft_tpu_torch.utils.checkpoint import keyed

F = 16
WIDTHS = (64, 12, 14, F)
#: narrow counterparts: ResNet18's stage sizes; ResNet10_FW's blocks (the first without a shortcut)
BACKBONES = {"ResNet18": ((2, 2, 2, 2), "simple"), "ResNet10_FW": ((1, 1, 1, 1), "fwt")}
GKW = dict(feat_dim=F, n_way=3, n_support=2, proj_dim=16, gnn_nf=8)
SPEC = (3, 2, 2)
LANES = 3
SIZE = 32
BASE = int(SIZE * 1.15)
RTOL, ATOL = 1e-8, 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    sizes, block = BACKBONES[name]
    return (jbb.ResNetCfg(sizes, WIDTHS, block, flatten=True, compute_dtype="float64"),
            tbb.ResNetCfg(sizes, WIDTHS, compute_dtype="float64", block=block))


@pytest.fixture(scope="module", params=sorted(BACKBONES))
def setup(request):
    """JAX-initialized weights (1-D leaves perturbed) as f64 numpy and the
    port's copies, a GNN head, three episodes of uint8 images."""
    name = request.param
    jcfg, tcfg = _cfgs(name)
    rs = np.random.RandomState(0)
    perturb = lambda a: np.asarray(a, np.float64) + (rs.rand(*np.shape(a)) * 0.2 if np.ndim(a) == 1 else 0)
    init = jax.jit(lambda k: jbb.init_backbone(k, jcfg._replace(compute_dtype="float32")))
    j = {}
    for member, seed in (("baseline", 0), ("gnn", 1)):
        p, s = init(jax.random.PRNGKey(seed))
        j[member] = (jax.tree.map(perturb, p), jax.tree.map(perturb, s))
    head = jax.jit(lambda k: jgn.init_head(k, jgn.GnnNetCfg(**GKW)))(jax.random.PRNGKey(2))
    j["head"] = jax.tree.map(lambda a: np.asarray(a, np.float64), head)
    t = {member: convert.from_jax(*j[member]) for member in ("baseline", "gnn")}
    t["head"], _ = convert.from_jax(j["head"])
    n_way, n_s, n_q = SPEC
    base = rs.randint(0, 256, (LANES, n_way, n_s + n_q, BASE, BASE, 3)).astype(np.uint8)
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, j=j, t=t, base=base)


def _port_inputs(base):
    tb = torch.from_numpy(base).permute(0, 1, 2, 5, 3, 4)
    return taug.center_batch(tb, SIZE), tb[:, :, : SPEC[1]]


def _port_member(s, member, episodes, supports, gens, tcfg, **kw):
    t = s["t"]
    common = dict(bcfg=s["tcfg"], spec=tep.EpisodeSpec(*SPEC), tcfg=tcfg, aug_cfg=taug.AugmentCfg(image_size=SIZE),
                  **kw)
    if member == "linear":
        return tee.linear_member_lanes(*t["baseline"], episodes, supports, gens, **common)
    return tee.gnn_member_lanes(*t["gnn"], t["head"], episodes, supports, gens, gcfg=tgn.GnnNetCfg(**GKW), **common)


@pytest.mark.parametrize("member", ["linear", "gnn"])
def test_member_lanes_equal_each_episode_alone(setup, member):
    """Each lane of an E = 3 batch equals the one-episode member with that
    lane's generator, and leaves the generator where the one-episode run
    leaves it."""
    tcfg = tee.TransferCfg(fine_tune_epochs=1, linear_epochs=2, opt_state_dtype="float32")
    episodes, supports = _port_inputs(setup["base"])
    gens = [torch.Generator().manual_seed(20 + i) for i in range(LANES)]
    got = _port_member(setup, member, episodes, supports, gens, tcfg, gen_examples=1)
    assert got.shape == (LANES, 6, 3) and torch.isfinite(got).all()
    after = [torch.rand(1, generator=g).item() for g in gens]
    for i in range(LANES):
        gen = torch.Generator().manual_seed(20 + i)
        one = _port_member(setup, member, episodes[i : i + 1], supports[i : i + 1], [gen], tcfg, gen_examples=1)
        np.testing.assert_allclose(got[i].numpy(), one[0].numpy(), rtol=RTOL, atol=ATOL)
        assert torch.rand(1, generator=gen).item() == after[i]
    assert not np.allclose(got[0].numpy(), got[1].numpy(), atol=1e-6)


@pytest.mark.parametrize("member", ["linear", "gnn"])
def test_member_lanes_match_jax(setup, member):
    """Each lane against the JAX member on its episode with the same
    explicit schedules (and classifier init), f64 rtol 1e-8.  The JAX member
    reads the port's clean views (tests/test_torch_eval_lanes.py explains
    why)."""
    rs = np.random.RandomState(5)
    spec = tep.EpisodeSpec(*SPEC)
    rows = spec.support_size if member == "linear" else 3 * spec.support_size
    perms = [np.stack([rs.permutation(rows) for _ in range(2)]) for _ in range(LANES)]
    head0 = [{"w": rs.randn(F, 3) * 0.2, "b": rs.randn(3) * 0.1} for _ in range(LANES)]  # JAX layout
    sched = til.stack_schedules([til.schedule_from_perms(p, til.InnerLoopCfg(2, 5, rows)) for p in perms])
    kw = {"inner_schedule": sched}
    if member == "linear":
        kw["head0"] = {"w": torch.from_numpy(np.stack([h["w"].T for h in head0])),
                       "b": torch.from_numpy(np.stack([h["b"] for h in head0]))}
    tcfg = tee.TransferCfg(fine_tune_epochs=2, linear_epochs=2, opt_state_dtype="float32")
    episodes, supports = _port_inputs(setup["base"])
    got = _port_member(setup, member, episodes, supports, [None] * LANES, tcfg, gen_examples=0, **kw)
    views = taug.center_batch(supports, SIZE)
    nhwc = lambda t: np.ascontiguousarray(np.moveaxis(t.numpy(), -3, -1))
    j, k = setup["j"], jax.random.PRNGKey(0)
    jkw = dict(bcfg=setup["jcfg"], spec=jep.EpisodeSpec(*SPEC), aug_cfg=jaug.AugmentCfg(image_size=SIZE),
               tcfg=jee.TransferCfg(fine_tune_epochs=2, linear_epochs=2, opt_state_dtype="float32"), gen_examples=0)

    def run(ep, sup, idx, w, h0):
        if member == "linear":
            return jee.linear_member_scores(*j["baseline"], ep, sup, k, k, inner_schedule=(idx, w), head0=h0, **jkw)
        return jee.gnn_member_scores(*j["gnn"], j["head"], ep, sup, k, k, gcfg=jgn.GnnNetCfg(**GKW),
                                     inner_schedule=(idx, w), **jkw)

    fn = jax.jit(run)
    for i in range(LANES):
        idx, w = jil.schedule_from_perms(perms[i], jil.InnerLoopCfg(2, 5, rows))
        with jax.enable_x64(), mock.patch.object(jaug, "center_batch", lambda images, *a, **kw_: images):
            want = np.asarray(fn(*jax.tree.map(jnp.asarray, (nhwc(episodes[i]), nhwc(views[i]), idx, w, head0[i]))))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# ResNet10_FW and the fused scan; ResNet18's refusal
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fw_episode():
    """ResNet10_FW at full width (its noise strengths perturbed off their
    init), a GNN head at 512 features, one 64 px episode, a schedule."""
    g = torch.Generator().manual_seed(3)
    cfg = tbb.resnet10_fw()
    gp, gs = tbb.init_backbone(g, cfg)
    for stage in gp["stages"]:
        for blk in stage:
            for k in [k for k in blk if k.startswith("fwt_")]:
                blk[k] = blk[k] + torch.rand(blk[k].shape, generator=g) * 0.2
    head = tgn.init_head(g, tgn.GnnNetCfg(feat_dim=512, n_way=3, n_support=2))
    rs = np.random.RandomState(4)
    base = rs.randint(0, 256, (3, 4, 73, 73, 3)).astype(np.uint8)
    perms = np.stack([rs.permutation(18) for _ in range(2)])
    return dict(gp=gp, gs=gs, head=head, base=base, perms=perms)


def _fw_scores(e, inner_scan):
    spec = tep.EpisodeSpec(*SPEC)
    tcfg = tee.TransferCfg(fine_tune_epochs=2, inner_scan=inner_scan)
    base = torch.from_numpy(e["base"]).permute(0, 1, 4, 2, 3)
    sched = til.schedule_from_perms(e["perms"], til.InnerLoopCfg(2, 5, 3 * spec.support_size))
    return tee.gnn_member_scores(
        e["gp"], e["gs"], e["head"], taug.center_batch(base, 64), base[:, : spec.n_support], None,
        bcfg=tbb.resnet10_fw(), gcfg=tgn.GnnNetCfg(feat_dim=512, n_way=3, n_support=2, use_pallas=True), spec=spec,
        tcfg=tcfg, aug_cfg=taug.AugmentCfg(image_size=64), gen_examples=0, inner_schedule=sched).numpy()


def test_fw_gnn_member_fused_matches_eager(fw_episode):
    """ResNet10_FW's final block through the fused scan (its noise strengths
    split off and put back) against the eager loop on the same 8-step
    schedule: atol 2e-2, the same argmax; one scan call on ResNet10's
    geometry."""
    eager = _fw_scores(fw_episode, "eager")
    with mock.patch.object(tfis, "fused_inner_scan_lanes", wraps=tfis.fused_inner_scan_lanes) as spy:
        fused = _fw_scores(fw_episode, "fused")
    assert spy.call_count == 1
    assert spy.call_args.kwargs["geom"] == tfis.BlockGeom(4, 256, 512, 2, 5)
    assert set(spy.call_args.args[0]) == set(tfis.PKEYS)
    assert fused.shape == (6, 3) and np.isfinite(fused).all()
    np.testing.assert_allclose(fused, eager, atol=2e-2)
    np.testing.assert_array_equal(fused.argmax(1), eager.argmax(1))


@pytest.mark.parametrize("inner_scan", ["eager", "fused"])
def test_fw_adapted_block_keeps_noise_strengths(fw_episode, inner_scan):
    """The adapted blocks of three lanes (f32 carry) hold the noise strengths
    bit for bit as they went in, and every other leaf moved."""
    e = fw_episode
    spec = tep.EpisodeSpec(*SPEC)
    tcfg = tee.TransferCfg(fine_tune_epochs=1, inner_scan=inner_scan)
    base = torch.from_numpy(np.stack([e["base"]] * 3)).permute(0, 1, 2, 5, 3, 4)
    gens = [torch.Generator().manual_seed(i) for i in range(3)]
    fmap, _, n_rep = tee._member_bank(e["gp"], e["gs"], base[:, :, : spec.n_support], gens, bcfg=tbb.resnet10_fw(),
                                      tcfg=tcfg, aug_cfg=taug.AugmentCfg(image_size=64), gen_examples=1)
    block, _ = tee._adapt_block(e["gp"], e["gs"], tee.bank_labels(spec, n_rep), gens, bcfg=tbb.resnet10_fw(),
                                tcfg=tcfg, epochs=1, fmap_bank=fmap)
    start = keyed(tbb.adapt_split(e["gp"])[1])
    for k, v in keyed(block).items():
        if "fwt_" in k:
            assert all(torch.equal(v[i], start[k]) for i in range(3)), k
        else:
            assert not torch.equal(v[0].to(start[k].dtype), start[k]), k
    assert sum("fwt_" in k for k in keyed(block)) == 4


def test_fused_scan_refuses_resnet18(tmp_path):
    """ResNet18's final block (identity shortcut) is not the block the
    scan's kernels take: the engine raises, and so does the driver before it
    loads anything; it never quietly runs the eager loop."""
    cfg = tbb.resnet18()
    p, _ = tbb.init_backbone(torch.Generator().manual_seed(0), tbb.ResNetCfg((2, 2), (8, 16)))
    block = tee._expand(tbb.adapt_split(p)[1], 1)
    with mock.patch.object(tfis, "fused_inner_scan_lanes", side_effect=AssertionError("no scan call")):
        with pytest.raises(ValueError, match="identity shortcut: use inner_scan='eager'"):
            tee._adapt_block_fused(block, None, torch.zeros(1, 6, 16, 4, 4), None, bcfg=cfg,
                                   tcfg=tee.TransferCfg(inner_scan="fused"), icfg=til.InnerLoopCfg(1, 5, 6))
    from mft_tpu_torch.cli import finetune

    for model in ("ResNet18", "ResNet34"):
        with pytest.raises(SystemExit, match=f"{model}'s final block has an identity shortcut"):
            finetune.main(["--device", "cpu", "--method", "gnnnet", "--test_dataset", "synthetic", "--model", model,
                           "--inner_scan", "fused", "--paths_json", str(tmp_path / "none.json")])


def test_drivers_run_resnet18_and_resnet10_fw(tmp_path):
    """``cli.train`` then ``cli.finetune`` at full width, 32 px: ResNet18
    (GnnNet, the eager inner loop, two lanes) and ResNet10_FW (GnnNet with
    ``--train_aug``, the fused scan)."""
    from mft_tpu_torch.cli import finetune, train

    pj = str(tmp_path / "paths.json")
    with open(pj, "w") as f:
        json.dump({"save_dir": str(tmp_path)}, f)
    common = ["--device", "cpu", "--dataset", "synthetic", "--image_size", "32", "--n_shot", "2", "--paths_json", pj]
    for model, aug, scan in (("ResNet18", [], "eager"), ("ResNet10_FW", ["--train_aug"], "fused")):
        res = train.main(common + aug + ["--model", model, "--method", "gnnnet", "--n_query", "2",
                                         "--episodes_per_epoch", "1", "--stop_epoch", "0"])
        assert np.isfinite(res.losses).all()
        out = finetune.main(common + aug + ["--model", model, "--method", "gnnnet", "--test_dataset", "synthetic",
                                            "--save_iter", "0", "--iter_num", "2", "--eval_batch", "2",
                                            "--gen_examples", "1", "--fine_tune_epoch", "1", "--n_query", "3",
                                            "--inner_scan", scan])
        assert len(out.accs) == 2 and all(0.0 <= v <= 100.0 for v in out.accs)
