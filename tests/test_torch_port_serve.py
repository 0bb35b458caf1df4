"""The port's serving slice against the JAX package: render_rays on the
spsbrdf RPV(111) configuration, and load_renderer(...).render_image on a
run directory written by the JAX package.  Plus the port's hygiene: it
imports nothing of JAX or the JAX package, and never falls back to the CPU
on its own.

Slice-level tolerance: both packages compute the same f32 formulas, but XLA
fuses multiply-adds and sums in other orders, so sampled depths differ by
an ulp or so, and the siren trunk (w0 = 30) turns a 1e-5 change of a depth
into up to 1e-2 of rgb on an isolated ray.  So, as __graft_entry__.py:373-381
does, each output is held to a mean (1e-3) and a 99th-percentile (1e-2)
bound on its per-ray max of |difference| / (1 + |reference|), not to a max.
The 1 + |reference| keeps the near-grazing diagnostics (rpv_G, hpk_scl
reach 4e4) on the same footing as the O(1) outputs.  Measured here: every
key's mean below 2e-4 and p99 below 5e-3."""

import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu.cli import opts as jopts
from brdfnerf_tpu.models.network import init_network as jinit
from brdfnerf_tpu.parallel.train_step import (make_render_step as jstep,
                                              reduce_panels as jreduce)
from brdfnerf_tpu.render import render as jrender
from brdfnerf_tpu.utils.checkpoint import save_checkpoint as jsave

from brdfnerf_tpu_torch import serve as tserve
from brdfnerf_tpu_torch.render import render as trender
from brdfnerf_tpu_torch.utils.device import resolve_device

from torch_port_common import (SMALL, FLAGSHIP_HEADS, a, make_rays,
                               model_configs, networks, render_configs,
                               render_draws, t)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close_slice(got, ref, n_rays, what, mean=1e-3, p99=1e-2):
    g, r = a(got), a(ref)
    d = (np.abs(g - r) / (1.0 + np.abs(r))).reshape(n_rays, -1).max(-1)
    assert np.isfinite(g).all(), what
    assert d.mean() <= mean and np.quantile(d, 0.99) <= p99, (
        what, d.mean(), np.quantile(d, 0.99), d.max())


@pytest.mark.parametrize("perturb", [0.0, 1.0])
def test_render_rays_rpv111(perturb):
    """render_rays key by key, with the fused kernels' twins on (the JAX
    side runs its Pallas kernels in interpret mode)."""
    jm, tm = model_configs(**SMALL, **FLAGSHIP_HEADS, compute_dtype="float32")
    kw = dict(n_samples=8, guided_samples=8, perturb=perturb,
              apply_brdf=True, use_pallas=True, fused_trunk=True)
    jr, tr = render_configs(**kw)
    params, net = networks(jm, tm)
    n = 48
    rays = make_rays(n, seed=3)
    key = jax.random.PRNGKey(2)
    ref = jrender.render_rays(
        {"coarse": params}, jm, jr,
        jrender.RenderInputs(rays=jnp.asarray(rays),
                             cos_irra_on=jnp.asarray(False)), key)
    draws = render_draws(key, jr, n, jr.sun_march_count(16))
    with torch.no_grad():
        got = trender.render_rays(
            net, tm, tr, trender.RenderInputs(rays=t(rays),
                                              cos_irra_on=torch.tensor(False)),
            draws=draws)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        close_slice(got[k], ref[k], n, k)


def _write_jax_run(tmp_path, extra=()):
    """A run directory as the JAX package writes it: opts.json from its
    train_parser and a seeded epoch=1.npz."""
    run_dir = str(tmp_path / "run")
    ckpts = str(tmp_path / "ckpts")
    argv = ["--root_dir", str(tmp_path), "--exp_name", "e",
            "--ckpts_dir", ckpts, "--model", "spsbrdf-nerf",
            "--fc_layers", "6", "--fc_feat", "64", "--mapping",
            "--normal", "analystic", "--sun_v", "analystic", "--funcM", "1",
            "--funcF", "1", "--funcH", "1", "--brdf_on", "0.5",
            "--n_samples", "8", "--guided_samples", "8", "--chunk", "96",
            "--compute_dtype", "float32", *extra]
    args = jopts.postprocess(jopts.train_parser().parse_args(argv))
    jopts.dump_opts(args, run_dir)
    cfg = jopts.to_run_config(args)
    params = {"coarse": jinit(jax.random.PRNGKey(5), cfg.model)}
    jsave(os.path.join(ckpts, "e", "epoch=1.npz"), params, step=10)
    return run_dir, args, cfg, params


def test_load_renderer_matches_jax_render_step(tmp_path):
    import dataclasses as dc
    from brdfnerf_tpu.train import Trainer
    run_dir, args, cfg, params = _write_jax_run(tmp_path)
    rays = make_rays(200, seed=4)
    chunk = 96
    rcfg = dc.replace(cfg.render, apply_brdf=True, apply_theta=False)
    fn = jstep(cfg.model, rcfg)
    key = jax.random.PRNGKey(0)
    ref = {}
    for i in range(0, 200, chunk):
        part = rays[i:i + chunk]
        keep = part.shape[0]
        part = np.concatenate([part, np.tile(part[-1:],
                                             (chunk - keep, 1))], 0)
        res = fn(params, jrender.RenderInputs(
            rays=jnp.asarray(part), ts=jnp.zeros(chunk, jnp.int32),
            cos_irra_on=jnp.asarray(False)), key)
        out = {k: res[k] for k in Trainer.PER_RAY_KEYS if k in res}
        out.update(jreduce(res, Trainer.PANEL_ACCUM))
        for k, v in out.items():
            ref.setdefault(k, []).append(np.asarray(v)[:keep])
    ref = {k: np.concatenate(v, 0) for k, v in ref.items()}

    r = tserve.load_renderer(run_dir, 1, device="cpu")
    assert r.chunk == chunk and r.render_config() == dc.replace(
        r.cfg.render, apply_brdf=True)
    draws = render_draws(key, rcfg, chunk, rcfg.sun_march_count(16))
    got = r.render_image({"rays": rays}, draws=draws)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        close_slice(got[k], ref[k], 200, k)


def test_render_image_chunks_reuse_draws(tmp_path):
    """Every chunk renders with the same draws, so a ray renders the same
    whatever chunk it lands in, and the padded last chunk changes
    nothing."""
    run_dir, *_ = _write_jax_run(tmp_path)
    r = tserve.load_renderer(run_dir, 1, device="cpu")
    rays = make_rays(200, seed=6)
    full = r.render_image({"rays": rays})
    first = r.render_image({"rays": rays[:96]})
    tail = r.render_image({"rays": rays[192:]})
    for k in full:
        assert np.isfinite(full[k]).all(), k
        assert np.array_equal(full[k][:96], first[k]), k
        assert full[k].shape[0] == 200
        np.testing.assert_allclose(full[k][192:], tail[k], atol=1e-6,
                                   err_msg=k)


def test_entry_points_never_fall_back_to_cpu(tmp_path, monkeypatch):
    run_dir, *_ = _write_jax_run(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.load_renderer(run_dir, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    from brdfnerf_tpu_torch.models.network import init_network
    from brdfnerf_tpu_torch.utils.checkpoint import params_from_flat
    _, tm = model_configs(**SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_network(tm, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_flat({}, tm)
    assert resolve_device("cpu") == torch.device("cpu")
    r = tserve.load_renderer(run_dir, 1, device="cpu")
    # by index, render_image builds the run's dataset: with --data blender
    # the blender loader, which finds no transforms_val.json in an AOI
    r.args.data = "blender"
    with pytest.raises(FileNotFoundError, match="transforms_val.json"):
        r.render_image(0)


@pytest.mark.parametrize("dtype,fast_sin,on_cuda", [
    ("bfloat16_all", "1", True), ("float32", "1", True),
    ("bfloat16", "1", True), ("float32", "0", True),
    ("bfloat16_all", "0 --siren 0", True),
    ("float32", "1 --fc_feat 96", True),
    ("float32", "1 --fc_feat 64", True),
    ("bfloat16_all", "1 --fc_feat 2048 --fc_layers 12", True)])
def test_kernels_default_on_for_cuda_where_they_cover_the_model(
        dtype, fast_sin, on_cuda):
    """Every compute dtype the kernels take (float32 as split products),
    every activation (the polynomial and the exact sine, ReLU) and every
    width turns them on by default on CUDA: the widths the fused kernels
    are built for (64 among them), a width under 512 they run zero-padded
    (96) and the layer-major family's (12 x 2048); the CPU never turns
    them on."""
    from brdfnerf_tpu_torch.cli import opts
    argv = ["--root_dir", "r", "--exp_name", "e", "--mapping",
            "--normal", "analystic", "--compute_dtype", dtype,
            "--fast_sin", *fast_sin.split()]
    args = opts.postprocess(opts.train_parser().parse_args(argv))
    for device, on in (("cuda", on_cuda), ("cpu", False)):
        r = opts.to_run_config(args, device=device).render
        assert (r.use_pallas, r.fused_trunk) == (on, on), device


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "brdfnerf_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]    # build outputs
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 15
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "brdfnerf_tpu", "optax",
                               "flax", "PIL", "cv2"), (path, mod)
