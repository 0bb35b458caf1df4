"""The port's Trainer against the JAX package's, on a 32-px synthetic AOI
with a 4x64 trunk and 8 + 8 samples, on the CPU:

  * the host schedule: steps per epoch, the static phase of every step,
    _next_phase_change, the epochs at which validation and checkpoints
    happen (and the chunks a scan_chunk run dispatches), and the handoff's
    restored key set: exactly equal; the learning rate of every step to
    two float32 ulps (optax evaluates the staircase's power with XLA's
    float32 pow, which no libm or torch power reproduces bit for bit; the
    port rounds the float64 value);
  * the trajectory: from the same weights (the JAX Trainer's init through
    the npz layout) and the same draws per step (the JAX step's
    fold_in(base_key, step) key, extracted as render_draws does), the
    parameters after 6 steps;
  * resume (20 steps straight = 10, a resume, 10 more) and scan_chunk (4
    against 1): bit-identical;
  * optimizer state: the port's .opt.npz restores through the JAX
    package's restore_opt_state with equal values, and the reverse;
  * validation's scores: ssim, masked_scores and the DSM mae_report.

Tolerances: the trajectory to rtol 5e-4, atol 5e-4 of each tensor's scale,
as tests/test_torch_port_train.py holds three steps (its reasons), except
that at most 0.1% of a tensor's elements may instead differ by up to 2 * lr
per step (a gradient element near zero takes its sign from the summation
order, and Adam turns either sign into a step of about lr); the scores to
1e-5 (float32 images, float64 DSMs); everything else bit-equal.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import brdfnerf_tpu.native as jnative
from brdfnerf_tpu import metrics as jmetrics
from brdfnerf_tpu import train as jtrain
from brdfnerf_tpu.config import RunConfig as JRunConfig
from brdfnerf_tpu.data import satellite as jsat
from brdfnerf_tpu.geo import dsm as jdsm
from brdfnerf_tpu.parallel import train_step as jts
from brdfnerf_tpu.utils import checkpoint as jckpt

from brdfnerf_tpu_torch import metrics as tmetrics
from brdfnerf_tpu_torch import train as ttrain
from brdfnerf_tpu_torch.config import RunConfig as TRunConfig
from brdfnerf_tpu_torch.data import satellite as tsat
from brdfnerf_tpu_torch.data.synth_aoi import build_aoi
from brdfnerf_tpu_torch.geo import dsm as tdsm
from brdfnerf_tpu_torch.parallel.train_step import TrainState
from brdfnerf_tpu_torch.utils import checkpoint as tckpt

from torch_port_common import (SMALL, FLAGSHIP_HEADS, model_configs,
                               render_configs, render_draws)

BATCH = 128          # 2 training images of 32 x 32: 16 steps an epoch


@pytest.fixture(scope="module")
def aoi(tmp_path_factory):
    """The AOI and both packages' training stores and val datasets."""
    root = str(tmp_path_factory.mktemp("aoi"))
    info = build_aoi(root)
    jc = jsat.SatelliteConfig(root_dir=info["root"], aoi_id=info["aoi_id"])
    tc = tsat.SatelliteConfig(root_dir=info["root"], aoi_id=info["aoi_id"])
    return dict(info, jtrain=jsat.SatelliteDataset(jc, "train"),
                jval=jsat.SatelliteDataset(jc, "val"),
                ttrain=tsat.SatelliteDataset(tc, "train"),
                tval=tsat.SatelliteDataset(tc, "val"))


def run_configs(heads=True, model=None, render=None, **train):
    """(JAX RunConfig, port RunConfig) of a stage-2 run (or stage 1 with
    heads=False) at this file's size."""
    mkw = dict(SMALL, **(FLAGSHIP_HEADS if heads else {}),
               compute_dtype="float32", **(model or {}))
    jm, tm = model_configs(**mkw)
    rkw = dict(dict(n_samples=8, guided_samples=8, apply_brdf=heads,
                    apply_theta=False), **(render or {}))
    jr, tr = render_configs(**rkw)
    tkw = dict(dict(lr=5e-4, batch_size=BATCH, ds_lambda=10.0,
                    max_train_steps=48,
                    **(dict(nr_reg_an_lambda=0.1, hs_lambda=0.5,
                            brdf_on=0.5) if heads else {})), **train)
    from brdfnerf_tpu import config as jc
    from brdfnerf_tpu_torch import config as tc
    return (JRunConfig(model=jm, render=jr, train=jc.TrainConfig(**tkw)),
            TRunConfig(model=tm, render=tr, train=tc.TrainConfig(**tkw)))


def trainers(aoi, tmp, jcfg, tcfg, jkw=None, tkw=None, val=False):
    def paths(side):
        return dict(logs_dir=os.path.join(tmp, side, "logs"),
                    ckpts_dir=os.path.join(tmp, side, "ckpts"),
                    gt_dir=aoi["gt_dir"], aoi_id=aoi["aoi_id"])
    jt = jtrain.Trainer(jcfg, aoi["jtrain"].store,
                        jtrain.TrainerPaths(**paths("jax")),
                        val_dataset=aoi["jval"] if val else None,
                        **(jkw or {}))
    tt = ttrain.Trainer(tcfg, aoi["ttrain"].store,
                        ttrain.TrainerPaths(**paths("torch")),
                        val_dataset=aoi["tval"] if val else None,
                        device="cpu", **(tkw or {}))
    return jt, tt


def fake_steps(monkeypatch, jt, tt, calls):
    """Both trainers' step functions replaced by ones that only count: the
    host loop, its chunking and its cadences run, nothing is computed.
    `calls` collects (package, chunk length) per call."""
    def jfn(phase, scan=False):
        def fn(state, store, idx, key):
            n = idx.shape[0] if scan else 1
            calls.append(("jax", n))
            return (state._replace(step=state.step + n),
                    {"loss": jnp.float32(0.0), "psnr": jnp.float32(0.0)})
        return fn

    def tfn(phase, scan=False):
        def fn(state, store, idx, seed):
            n = idx.shape[0] if scan else 1
            calls.append(("torch", n))
            return (TrainState(state.params, state.opt_state,
                               state.step + n),
                    {"loss": torch.tensor(0.0), "psnr": torch.tensor(0.0)})
        return fn

    monkeypatch.setattr(jt, "_get_step_fn", jfn)
    monkeypatch.setattr(jt, "_get_scan_fn", lambda p: jfn(p, scan=True))
    monkeypatch.setattr(tt, "_get_step_fn", tfn)


# ------------------------------------------------------- host schedule

def test_static_phases_and_learning_rate_match_jax(aoi, tmp_path):
    jcfg, tcfg = run_configs(
        render=dict(apply_theta=True, gsam_only=True),
        brdf_on=0.2, gsam_only_on=0.3, lr_warmup_steps=-1)
    jt, tt = trainers(aoi, str(tmp_path), jcfg, tcfg)
    assert tt.steps_per_epoch == jt.steps_per_epoch == 16
    _, jsched = jts.make_optimizer(jcfg.train, jt.steps_per_epoch)
    for step in range(60):
        assert tt._static_phase(step) == tuple(
            bool(v) for v in jt._static_phase(step)), step
        assert tt._next_phase_change(step) == jt._next_phase_change(step)
        ref = np.float32(jsched(step))
        assert abs(tt.opt.schedule(step) - ref) <= 2 * np.spacing(ref), step
    assert tt._gate_schedule() == tuple(jt._gate_schedule())


@pytest.mark.parametrize("eval_every,save_every,scan_chunk,log_every", [
    (1, 1, 1, 100), (2, 3, 5, 100), (0, 0, 3, 4), (1, 2, 8, 3)])
def test_cadences_and_chunks_match_jax(aoi, tmp_path, monkeypatch,
                                       eval_every, save_every, scan_chunk,
                                       log_every):
    """Validation and checkpoint epochs, the log rows and the chunk
    lengths of fit, with both packages' steps replaced by counters."""
    jcfg, tcfg = run_configs(brdf_on=0.3)
    jt, tt = trainers(aoi, str(tmp_path), jcfg, tcfg, val=True)
    calls, vals = [], []
    fake_steps(monkeypatch, jt, tt, calls)
    for side, tr in (("jax", jt), ("torch", tt)):
        monkeypatch.setattr(tr, "validate",
                            lambda e, side=side: vals.append((side, e)))
        tr.fit(max_steps=40, log_every=log_every,
               eval_every_n_epochs=eval_every,
               save_ckpt_every_n_epochs=save_every, scan_chunk=scan_chunk,
               progress=False)
    for side in ("jax", "torch"):
        assert sum(n for s, n in calls if s == side) == 40
    assert [n for s, n in calls if s == "torch"] == \
        [n for s, n in calls if s == "jax"]
    assert [e for s, e in vals if s == "torch"] == \
        [e for s, e in vals if s == "jax"]

    def ckpts(side):
        return sorted(os.listdir(os.path.join(str(tmp_path), side,
                                              "ckpts")))

    def rows(side):
        with open(os.path.join(str(tmp_path), side, "logs",
                               "scalars.jsonl")) as f:
            return [json.loads(ln)["step"] for ln in f]
    assert ckpts("torch") == ckpts("jax") and ckpts("jax")
    assert rows("torch") == rows("jax") and rows("jax")


def test_handoff_restores_the_jax_key_set(aoi, tmp_path):
    """Stage 2 from a stage-1 checkpoint written by the JAX package: the
    handoff heads take the checkpoint's values, the BRDF heads keep the
    init's."""
    j1, _ = run_configs(heads=False)
    jcfg, tcfg = run_configs()
    s1 = jtrain.Trainer(j1, aoi["jtrain"].store, jtrain.TrainerPaths(
        str(tmp_path / "l1"), str(tmp_path / "c1")), seed=5)
    path = jckpt.save_checkpoint(str(tmp_path / "s1.npz"), s1.state.params)
    include = tckpt.handoff_include("coarse", tcfg.model.hapke_b)
    assert include == jckpt.handoff_include("coarse", jcfg.model.hapke_b)
    jt, tt = trainers(aoi, str(tmp_path), jcfg, tcfg,
                      jkw=dict(in_ckpts=path), tkw=dict(in_ckpts=path))
    fresh = tckpt.params_to_flat(ttrain.Trainer(
        tcfg, aoi["ttrain"].store, ttrain.TrainerPaths(
            str(tmp_path / "l2"), str(tmp_path / "c2")),
        device="cpu").state.params)
    s1_flat = jckpt.load_flat(path)
    got = tckpt.params_to_flat(tt.state.params)
    jgot = jckpt._flatten(jt.state.params)
    restored = {k for k in got if np.array_equal(got[k], s1_flat.get(k))}
    jrestored = {k for k in jgot if np.array_equal(jgot[k], s1_flat.get(k))}
    assert restored == jrestored
    assert restored == {k for k in got if any(k.startswith(p)
                                              for p in include)}
    for k in set(got) - restored:
        assert np.array_equal(got[k], fresh[k]), k


# --------------------------------------------------------- trajectory

def test_six_steps_match_jax_from_the_same_weights(aoi, tmp_path):
    jcfg, tcfg = run_configs(render=dict(perturb=0.0))
    jt, tt = trainers(aoi, str(tmp_path), jcfg, tcfg)
    init = jckpt.save_checkpoint(str(tmp_path / "init.npz"),
                                 jt.state.params)
    tckpt.restore_params(tt.state.params, init)
    base_key = jt._base_key
    n_sun = jcfg.render.sun_march_count(16)
    for i in range(6):
        phase = jt._static_phase(i)
        assert tt._static_phase(i) == tuple(bool(v) for v in phase)
        jidx = jt.batcher.next_indices().astype(np.int32)
        idx = tt.batcher.next_index_tensor()
        assert np.array_equal(idx.numpy(), jidx)
        draws = render_draws(jax.random.fold_in(base_key, i), jcfg.render,
                             BATCH, n_sun)
        jt.state, jm = jt._get_step_fn(phase)(
            jt.state, jt.batcher.store, jnp.asarray(jidx), base_key)
        tt.state, m = tt._get_step_fn(phase)(
            tt.state, tt.batcher.store, idx, tt._draw_seed, draws=draws)
    assert tt.state.step == int(jt.state.step) == 6
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=5e-4)
    ref = jckpt._flatten(jt.state.params)
    got = tckpt.params_to_flat(tt.state.params)
    assert set(got) == set(ref)
    lr = tcfg.train.lr
    for k, r in ref.items():
        d = np.abs(got[k] - r)
        scale = max(float(np.abs(r).max()), 1e-3)
        flipped = d > 5e-4 * scale + 5e-4 * np.abs(r)
        assert flipped.mean() <= 1e-3, (k, flipped.sum())
        assert d.max() <= 2 * lr * 6, (k, d.max())


# ------------------------------------------------- resume and scan_chunk

def _fit(aoi, tmp, tcfg, steps, scan_chunk=1, **kw):
    tt = ttrain.Trainer(tcfg, aoi["ttrain"].store, ttrain.TrainerPaths(
        os.path.join(tmp, "logs"), os.path.join(tmp, "ckpts")),
        device="cpu", **kw)
    tt.fit(max_steps=steps, scan_chunk=scan_chunk, progress=False)
    tt.log.close()
    return tt


def test_resume_and_scan_chunk_are_bit_identical(aoi, tmp_path):
    """20 steps straight; 10, a resume from the checkpoint, 10 more; and 20
    with scan_chunk=4 (chunks clamp at the phase change after step 12 and
    the epoch boundary at 16): the same parameters and Adam moments, bit
    for bit."""
    _, tcfg = run_configs(brdf_on=0.2, max_train_steps=60)
    straight = _fit(aoi, str(tmp_path / "a"), tcfg, 20)
    half = _fit(aoi, str(tmp_path / "b"), tcfg, 10)
    path = half.checkpoint_path(0)
    assert tckpt.checkpoint_step(path) == 10
    resumed = _fit(aoi, str(tmp_path / "c"), tcfg, 20, resume_from=path)
    scanned = _fit(aoi, str(tmp_path / "d"), tcfg, 20, scan_chunk=4)
    ref = tckpt.params_to_flat(straight.state.params)
    for tt in (resumed, scanned):
        assert tt.state.step == 20
        got = tckpt.params_to_flat(tt.state.params)
        for k in ref:
            assert np.array_equal(got[k], ref[k]), k
        for p, q in zip(tt.state.params.parameters(),
                        straight.state.params.parameters()):
            for m in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(tt.state.opt_state.state[p][m],
                                   straight.state.opt_state.state[q][m])


# ------------------------------------------------------ optimizer state

def _jax_opt_template(jcfg, spe, frozen=None):
    state, opt = jts.create_train_state(jax.random.PRNGKey(0), jcfg.model,
                                        jcfg.train, spe)
    if frozen:
        import optax
        mask = jckpt.freeze_mask(state.params, frozen)
        labels = jax.tree_util.tree_map(
            lambda t: "train" if t else "freeze", mask)
        base, _ = jts.make_optimizer(jcfg.train, spe)
        opt = optax.multi_transform(
            {"train": base, "freeze": optax.set_to_zero()}, labels)
    return opt.init(state.params)


@pytest.mark.parametrize("frozen", [None, ["all"]])
def test_optimizer_state_moves_both_ways(aoi, tmp_path, frozen):
    jcfg, tcfg = run_configs()
    # port -> JAX: the port's Adam after two steps
    tt = _fit(aoi, str(tmp_path / "t"), tcfg, 2, freeze=frozen)
    if frozen:
        # nothing trains: the parameters stay the seed's init
        init = tckpt.params_to_flat(ttrain.Trainer(
            tcfg, aoi["ttrain"].store, ttrain.TrainerPaths(
                str(tmp_path / "l0"), str(tmp_path / "c0")),
            device="cpu").state.params)
        got = tckpt.params_to_flat(tt.state.params)
        assert all(np.array_equal(got[k], v) for k, v in init.items())
        assert tt.state.opt_state is None and tt.state.step == 2
    path = tckpt.save_opt_state(str(tmp_path / "t.opt.npz"),
                                tt.state.params, tt.state.opt_state,
                                count=tt.state.step)
    template = _jax_opt_template(jcfg, 16, frozen)
    restored = jckpt.restore_opt_state(template, path)
    leaves = jax.tree_util.tree_leaves(restored)
    flat = np.load(path)
    assert len(leaves) == len(flat.files) == (2 if frozen else 58)
    assert int(leaves[0]) == int(leaves[-1]) == 2
    if not frozen:
        adam = restored[0]
        mu, nu = jckpt._flatten(adam.mu), jckpt._flatten(adam.nu)
        for name, p in tt.state.params.named_parameters():
            key = name.replace(".", "/")
            st = tt.state.opt_state.state[p]
            for tree, m in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
                v = st[m].t() if name.endswith(".w") else st[m]
                assert np.array_equal(tree[key], v.numpy()), (key, m)
    # JAX -> port: a JAX state of random moments
    rng = np.random.RandomState(1)
    lv, tdef = jax.tree_util.tree_flatten(template)
    lv = [np.asarray(7, np.int32) if np.ndim(x) == 0 else
          rng.normal(size=np.shape(x)).astype(np.float32) for x in lv]
    jpath = jckpt.save_opt_state(str(tmp_path / "j.opt.npz"),
                                 jax.tree_util.tree_unflatten(tdef, lv))
    opt = tt.opt.init(tt.state.params)
    assert tckpt.restore_opt_state(tt.state.params, opt, jpath) == 7
    back = tckpt.save_opt_state(str(tmp_path / "back.opt.npz"),
                                tt.state.params, opt, count=7)
    with np.load(jpath) as z, np.load(back) as b:
        assert sorted(z.files) == sorted(b.files)
        for k in z.files:
            assert np.array_equal(b[k], z[k]), k
    # a state of another configuration (stage 1's) is refused, as the JAX
    # package refuses it
    j1, _ = run_configs(heads=False)
    other = jckpt.save_opt_state(str(tmp_path / "o.opt.npz"),
                                 _jax_opt_template(j1, 16))
    with pytest.raises(ValueError, match="leaf count"):
        tckpt.restore_opt_state(tt.state.params,
                                tt.opt.init(tt.state.params), other)


# ----------------------------------------------------------- validation

def test_validation_scores_match_jax(aoi, monkeypatch):
    """ssim and masked_scores on a rendered-like image pair with a mask,
    and the DSM chain (dsm_from_depth, interpolate_nans, mae_report) on
    the AOI's rays with a perturbed depth, through both packages (the JAX
    package on its NumPy registration)."""
    monkeypatch.setattr(jnative, "usable", lambda *a, **k: None)
    rng = np.random.RandomState(2)
    gt = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(
        np.float32)
    mask = rng.uniform(0, 1, (32, 32, 1)) > 0.3
    for m in (None, mask):
        got = tmetrics.masked_scores(
            torch.from_numpy(pred), torch.from_numpy(gt),
            None if m is None else torch.from_numpy(m), scl=True,
            with_unmasked=True)
        ref = jmetrics.masked_scores(
            jnp.asarray(pred), jnp.asarray(gt),
            None if m is None else jnp.asarray(m), scl=True,
            with_unmasked=True)
        assert set(got) == set(ref)
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-5 * max(1.0, abs(ref[k])), k
    np.testing.assert_allclose(
        float(tmetrics.ssim(torch.from_numpy(pred), torch.from_numpy(gt))),
        float(jmetrics.ssim(jnp.asarray(pred), jnp.asarray(gt))),
        atol=1e-5)

    s = aoi["tval"].get_image(1)
    depth = s["depths"][:, 0] + rng.normal(0, 0.01, s["depths"].shape[0])
    roi = tdsm.load_roi(aoi["gt_dir"], aoi["aoi_id"])
    assert np.array_equal(roi, jdsm.load_roi(aoi["gt_dir"], aoi["aoi_id"]))
    for fair in (False, True):
        out = []
        for mod, ds in ((tdsm, aoi["tval"]), (jdsm, aoi["jval"])):
            dsm, prof = mod.dsm_from_depth(
                s["rays"], depth, ds.scene, cs=ds.cfg.cs,
                utm_zone=ds.utm_zone, resolution=float(roi[3]))
            if fair:
                dsm = mod.interpolate_nans(dsm)
            out.append((dsm, mod.mae_report(dsm, prof, aoi["gt_dir"],
                                            aoi["aoi_id"])))
        (d_t, r_t), (d_j, r_j) = out
        assert np.array_equal(d_t, d_j, equal_nan=True)
        for k in ("mae", "mae_in", "mae_out", "mae_nr"):
            assert abs(getattr(r_t, k) - getattr(r_j, k)) <= 1e-5, k
        assert np.isfinite(r_t.mae) and np.isfinite(r_t.mae_nr)
