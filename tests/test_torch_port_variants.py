"""The nerf, s-nerf, sat-nerf and sps-nerf variants (beta off) and
spsbrdf-nerf with the learned sun's solar-correction pass, against the JAX
package on the CPU: the render at train and eval time on the JAX
package's draws, compute_losses (loss, terms and every gradient), three
fused train steps, a train-CLI run, the `[kernels]` line, and that what
ROADMAP.md Queue 1 item 9b brought (beta, the keypoint pass, the fine
model, density noise) runs.

None of these variants runs a Pallas kernel in the JAX package
(apply_network, analytic_normals, sigma_and_sun_v), so their port is plain
torch; spsbrdf with the learned sun keeps its sigma probe and main pass on
the fused kernels' twins here (K1, K2/K3 on the card).

Tolerances: each inference function on the same samples, and the renders
where no density places a sample (nerf, s-nerf, sat-nerf), to 1e-5 (of
1 + |ref|, per element); where sps-nerf's guided band or spsbrdf's probe
places samples, an ulp of the probe's depth moves a sample and the siren
trunk amplifies it on isolated rays (measured: up to 8e-5 for sps-nerf,
2e-4 with the learned sun), so those renders are held as
tests/test_torch_port_serve.py holds them (close_slice: mean 1e-3, p99
1e-2); the loss and terms to 1e-5 relative;
the gradients to rtol 5e-4 (atol 5e-5 of the tensor's largest magnitude);
the three steps as tests/test_torch_port_train.py's."""

import dataclasses as dc
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu.parallel import train_step as jts
from brdfnerf_tpu.render import render as jrender

from brdfnerf_tpu_torch.parallel import train_step as tts
from brdfnerf_tpu_torch.render import render as trender

from test_torch_port_serve import close_slice
from test_torch_port_train import GATES, train_configs
from torch_port_common import (a, close, grads_close, jax_batch, make_store,
                               model_configs, networks, render_configs,
                               render_draws, t, three_fused_steps_match,
                               torch_batch)

N_RAYS = 16
TRUNK = dict(layers=4, feat=64, skips=(2,), mapping=True)
VARIANTS = {
    "nerf": dict(variant="nerf", siren=False),
    "s-nerf": dict(variant="s-nerf", siren=True, sun_v="learned",
                   indirect_light=True),
    "sat-nerf": dict(variant="sat-nerf", siren=True, sun_v="learned",
                     indirect_light=True),
    "sps-nerf": dict(variant="sps-nerf", siren=True, sun_v="learned",
                     indirect_light=True),
    "spsbrdf learned sun": dict(
        variant="spsbrdf-nerf", siren=True, sun_v="learned",
        normal="analystic", func_m=True, func_f=True, func_h=1),
}
# the renders no density moves a sample of
EXACT = ("nerf", "s-nerf", "sat-nerf")


def setup(name, **rkw):
    kw = dict(TRUNK, **VARIANTS[name])
    jm, tm = model_configs(**kw, compute_dtype="float32")
    fused = name.startswith("spsbrdf")
    jr, tr = render_configs(**dict(dict(
        n_samples=8, guided_samples=8, apply_brdf=fused, use_pallas=fused,
        fused_trunk=fused), **rkw))
    params, net = networks(jm, tm)
    return jm, tm, jr, tr, params, net


def _render_both(name, train, perturb=1.0):
    jm, tm, jr, tr, params, net = setup(name, perturb=perturb)
    s = make_store(N_RAYS, seed=2)
    key = jax.random.PRNGKey(3)
    ref = jrender.render_rays(
        {"coarse": params}, jm, jr, jrender.RenderInputs(
            rays=jnp.asarray(s["rays"]),
            valid_depth=jnp.asarray(s["valid_depth"]),
            target_depths=jnp.asarray(s["depths"]),
            target_std=jnp.asarray(s["depth_std"]),
            cos_irra_on=jnp.asarray(False)), key, train=train)
    with torch.set_grad_enabled(train):
        got = trender.render_rays(
            net, tm, tr, trender.RenderInputs(
                rays=t(s["rays"]), valid_depth=t(s["valid_depth"]),
                target_depths=t(s["depths"]), target_std=t(s["depth_std"]),
                cos_irra_on=torch.tensor(False)),
            train=train, draws=render_draws(key, jr, N_RAYS,
                                            jr.sun_march_count(16)))
    return ref, got


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_render_matches_jax(name, train):
    """render_rays key by key on the JAX package's draws; the solar-
    correction keys appear at train time alone, with the learned sun."""
    ref, got = _render_both(name, train)
    assert set(got) == set(ref)
    sc = {"weights_sc_coarse", "transparency_sc_coarse", "sun_sc_coarse"}
    assert (sc <= set(got)) == (train and name != "nerf"), sorted(got)
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        if name in EXACT:
            g, r = a(got[k]), a(ref[k])
            assert np.all(np.abs(g - r) <= 1e-5 * (1.0 + np.abs(r))), (
                k, float(np.max(np.abs(g - r))))
        else:
            close_slice(got[k], ref[k], N_RAYS, k)


@pytest.mark.parametrize("fn", ["inference_classic", "inference_shadow",
                                "solar_correction_pass"])
def test_inference_functions_match_jax(fn):
    """Each variant's inference on the same z samples (sorted draws, so no
    density places a sample), every key within 1e-5: the renders above
    that a guided band places samples in differ from here by the
    band's amplified ulps alone."""
    from brdfnerf_tpu.render import inference as jinf
    from brdfnerf_tpu_torch.render import inference as tinf
    name = {"inference_classic": "nerf", "inference_shadow": "sps-nerf",
            "solar_correction_pass": "spsbrdf learned sun"}[fn]
    jm, tm, jr, tr, params, net = setup(name)
    rays = make_store(N_RAYS, seed=7)["rays"]
    z = np.sort(np.random.RandomState(8).uniform(0.0, 2.0, (N_RAYS, 12)),
                -1).astype(np.float32)
    o, d, sun = rays[:, 0:3], rays[:, 3:6], rays[:, 8:11]
    args = {"inference_classic": (o, d, z),
            "inference_shadow": (o, d, z, sun),
            "solar_correction_pass": (o, sun, z)}[fn]
    ref = getattr(jinf, fn)(params, jm, jr, *map(jnp.asarray, args))
    with torch.no_grad():
        got = getattr(tinf, fn)(net, tm, tr, *map(t, args))
    assert set(got) == set(ref)
    for k in ref:
        g, r = a(got[k]), a(ref[k])
        assert g.shape == r.shape, k
        assert np.all(np.abs(g - r) <= 1e-5 * (1.0 + np.abs(r))), (
            k, float(np.max(np.abs(g - r))))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_compute_losses_match_jax(name):
    """The loss by load_loss(variant, beta=False, ...) with the sc terms
    (sc_lambda 0.05) and, but for nerf and s-nerf, the depth loss:
    sat-nerf's over every ray (subset=False), sps-nerf's and spsbrdf's on
    the valid rays: the loss, every term and every parameter's gradient
    against jax.value_and_grad of the JAX package's compute_losses.
    perturb=0, so that no sample moves."""
    jm, tm, jr, tr, params, net = setup(name, perturb=0.0)
    ds = 0.0 if name in ("nerf", "s-nerf") else 10.0
    jt, tt = train_configs(sc_lambda=0.05, ds_lambda=ds,
                           nr_reg_an_lambda=0.0, hs_lambda=0.0)
    s = make_store(N_RAYS, seed=5)
    key = jax.random.PRNGKey(9)
    jg = jts.TrainGates(**{k: jnp.asarray(v) for k, v in GATES.items()})
    (l_ref, (terms_ref, aux_ref)), g_ref = jax.value_and_grad(
        lambda p: jts.compute_losses(p, jm, jr, jt, jax_batch(s), key, jg),
        has_aux=True)({"coarse": params})
    loss, (terms, aux) = tts.compute_losses(
        net, tm, tr, tt, torch_batch(s), tts.TrainGates(**GATES),
        draws=render_draws(key, jr, N_RAYS, jr.sun_march_count(16)))
    loss.backward()
    close(loss, l_ref, atol=0.0, rtol=1e-5, what="loss")
    assert set(terms) == set(terms_ref)
    if name != "nerf":
        assert "coarse_sc_term2" in terms
    for k in terms_ref:
        close(terms[k], terms_ref[k], atol=1e-7, rtol=1e-5, what=k)
    for k in aux_ref:
        close(aux[k], aux_ref[k], atol=1e-6, rtol=1e-5, what=k)
    grads_close(net, g_ref, name, atol_frac=5e-5, rtol=5e-4)


@pytest.mark.parametrize("name", ["nerf", "sps-nerf",
                                  "spsbrdf learned sun"])
def test_three_fused_steps_match_jax(name):
    """make_fused_train_step, three steps, each from the JAX state
    (three_fused_steps_match)."""
    jm, tm, jr, tr, _, _ = setup(name, perturb=0.0)
    jt, tt = train_configs(batch_size=N_RAYS, sc_lambda=0.05,
                           nr_reg_an_lambda=0.0, hs_lambda=0.0)
    three_fused_steps_match(jm, tm, jr, tr, jt, tt, N_RAYS)


def test_chunk_draws_follow_each_variants_order():
    """chunk_draws makes the draws a generator seeded alike gives
    render_rays(train=False), in each variant's order: stratified z, then
    sps-nerf's guided band; nerf, s-nerf and sat-nerf draw z alone."""
    for name in VARIANTS:
        _, tm, _, tr, _, net = setup(name)
        rays = t(make_store(N_RAYS, seed=1)["rays"])
        draws = trender.chunk_draws(tm, tr, N_RAYS, torch.device("cpu"), 4)
        want = {"z"} | ({"guided"} if name in ("sps-nerf",
                                              "spsbrdf learned sun")
                        else set())
        assert set(draws) == want, (name, sorted(draws))
        inp = trender.RenderInputs(rays=rays,
                                   cos_irra_on=torch.tensor(False))
        with torch.no_grad():
            x = trender.render_rays(net, tm, tr, inp, draws=draws)
            y = trender.render_rays(
                net, tm, tr, inp,
                generator=torch.Generator().manual_seed(4))
        for k in x:
            assert torch.equal(x[k], y[k]), (name, k)


@pytest.mark.parametrize("name", ["nerf", "s-nerf", "sat-nerf", "sps-nerf"])
def test_train_cli_runs_each_variant(tmp_path, capsys, name):
    """The port's train CLI, 4 steps of each variant on the synthetic AOI,
    with the learned sun's sc loss where the variant has it; its
    `[kernels]` line, a checkpoint and finite validation scores."""
    import json
    from brdfnerf_tpu_torch.cli.train import main
    from brdfnerf_tpu_torch.data.synth_aoi import build_aoi
    info = build_aoi(str(tmp_path / "aoi"))
    logs, ckpts = str(tmp_path / "logs"), str(tmp_path / "ckpts")
    extra = ([] if name == "nerf" else
             ["--sun_v", "learned", "--sc_lambda", "0.05"])
    if name == "sps-nerf":
        extra += ["--ds_lambda", "10"]
    assert main(["--root_dir", info["root"], "--gt_dir", info["gt_dir"],
                 "--aoi_id", info["aoi_id"], "--logs_dir", logs,
                 "--ckpts_dir", ckpts, "--exp_name", "v", "--model", name,
                 "--mapping", "--fc_feat", "32", "--fc_layers", "4",
                 "--n_samples", "8", "--guided_samples", "8",
                 "--batch_size", "256", "--max_train_steps", "4",
                 "--lr", "1e-3"] + extra, device="cpu") == 0
    out = capsys.readouterr().out
    assert "[kernels] none" in out
    assert os.path.exists(os.path.join(ckpts, "v", "epoch=0.npz"))
    with open(os.path.join(logs, "v", "scalars.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    val = [r for r in rows if "val/psnr_1" in r]
    assert losses and all(np.isfinite(losses))
    assert val and np.isfinite(val[-1]["val/psnr_1"])


@pytest.mark.parametrize("model,extra,fused_heads,want", [
    ("nerf", [], False, ["none: the nerf variant runs its trunk in plain "
                         "torch"]),
    ("sps-nerf", ["--sun_v", "learned"], True,
     ["none: the sps-nerf variant"]),
    ("sat-nerf", [], False, ["none: the sat-nerf variant"]),
    ("spsbrdf-nerf", ["--b", "--c", "--theta", "--brdf_on", "0"], True,
     ["K1 (the sigma-only passes)", "K2 + K3", "K4/K5 take only the "
      "RPV(111) heads, so the Hapke heads stay on K2 + K3"]),
    ("spsbrdf-nerf", ["--roughness", "--brdf_on", "0.5"], True,
     ["K2 + K3", "so the Microfacet heads stay on K2 + K3"]),
    ("spsbrdf-nerf", ["--roughness", "--brdf_on", "0.5"], False,
     ["K2 + K3 (the differentiated trunk"]),
    ("spsbrdf-nerf", ["--funcM", "1", "--funcF", "1", "--funcH", "1",
                      "--brdf_on", "0.5"], True,
     ["K4 + K5 in their place where the flagship head set runs"])])
def test_kernels_line_names_each_path(monkeypatch, model, extra,
                                      fused_heads, want):
    """The `[kernels]` line: none for the variants the JAX package runs
    without a Pallas kernel; for Hapke and Microfacet with the switch set,
    K2 + K3 and why K4/K5 do not run."""
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.cli.train import kernels_line
    if fused_heads:
        monkeypatch.setenv("BRDFNERF_FUSED_HEADS", "1")
    else:
        monkeypatch.delenv("BRDFNERF_FUSED_HEADS", raising=False)
    args = opts.postprocess(opts.train_parser().parse_args(
        ["--root_dir", "r", "--exp_name", "e", "--model", model,
         "--mapping", "--normal", "analystic", "--compute_dtype",
         "bfloat16_all"] + extra))
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    line = kernels_line(opts.to_run_config(args, device=cuda), cuda)
    for w in want:
        assert w in line, (w, line)
    assert ("K1" in line) == (model == "spsbrdf-nerf"), line
    assert "K4 + K5" not in line or "--funcM" in extra, line


def test_what_item_9b_brought_runs():
    """beta with the t-embedding, the sat-nerf keypoint pass, the fine
    model and density noise, which raised until ROADMAP.md Queue 1 item 9b
    was ported, run: a render of each, a state with the t table, a fused
    step with the keypoint store (their parity with the JAX package:
    tests/test_torch_port_defaults*.py)."""
    _, tm, _, tr, _, net = setup("sat-nerf")
    _, tt = train_configs(ds_lambda=1.0)
    s = make_store(N_RAYS, seed=1)
    rays = t(s["rays"])
    inp = trender.RenderInputs(rays=rays, ts=t(s["ts"]),
                               cos_irra_on=torch.tensor(False))
    gen = torch.Generator().manual_seed(0)
    for m, r, key in ((dc.replace(tm, beta=True), tr, "beta_coarse"),
                      (tm, dc.replace(tr, n_importance=8), "rgb_fine"),
                      (tm, dc.replace(tr, noise_std=1.0), "rgb_coarse")):
        state, _ = tts.create_train_state(
            m, tt, 1, n_importance=r.n_importance, device="cpu")
        with torch.no_grad():
            out = trender.render_rays(state.params, m, r, inp, generator=gen)
        assert torch.isfinite(out[key]).all(), key
    sched = tts.GateSchedule(1e18, 1e18, -1.0, 1, 0)
    state, opt = tts.create_train_state(tm, tt, 1, device="cpu")
    step = tts.make_fused_train_step(tm, tr, tt, opt, sched, has_kp=True)
    store = torch_batch(s)
    kp = {"rays": rays[:, :8], "depths": t(s["depths"]), "ts": t(s["ts"])}
    state, m = step(state, store, torch.arange(8), 0, kp_store=kp,
                    kp_idx=torch.arange(4))
    assert state.step == 1 and np.isfinite(float(m["loss"]))
