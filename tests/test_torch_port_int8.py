"""The port's int8 serving path against the JAX package (tests/test_int8.py's
cases, each on both packages), on the CPU at a 4 x 64 siren trunk.

The trunk's matmul inputs are bounded in [-1, 1] for siren + mapping
configurations, so int8 serving quantizes them with the constant scale
1/127 and the weights per output channel; the product is int8 x int8 ->
int32 (torch._int_mm here, XLA's int8 dot in the JAX package), exact in
both.  Serving-only: training refuses it, and every gradient consumer runs
on the bfloat16_all twin.

Tolerances: the dense layer is bit-equal to the JAX package's on the same
f32 inputs (both products are exact integers and the dequantization is one
f32 multiply-add in the same order).  The int8 sigma is held to one bf16
ulp of the JAX package's (2^-7 of the value): the activations between the
layers are bf16 in both packages, and a bf16 rounding that differs moves an
activation across an int8 code boundary.  A render through the int8 sigma
passes is held to the scale of the JAX package's own int8 against
bfloat16_all gap on the same rays (mean and p99 of the per-ray largest
|delta rgb| / |delta depth|), since such a flipped code moves the probe's
depth and the guided samples with it.  The bfloat16_all twin paths are bit
for bit.
"""

import dataclasses as dc
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu.models import network as jnet
from brdfnerf_tpu.render import render as jrender

from brdfnerf_tpu_torch.models import network as tnet
from brdfnerf_tpu_torch.render import render as trender

from torch_port_common import (FLAGSHIP_HEADS, SMALL, a, make_rays,
                               model_configs, networks, render_configs,
                               render_draws, t)

INT8 = dict(SMALL, **FLAGSHIP_HEADS, compute_dtype="int8")


@pytest.fixture(scope="module")
def setup():
    jm, tm = model_configs(**INT8)
    params, net = networks(jm, tm)
    xyz = np.random.RandomState(1).uniform(-0.8, 0.8, (512, 3)).astype(
        np.float32)
    return jm, tm, params, net, xyz


@pytest.mark.parametrize("rows,k", [(256, 63), (256, 60), (5, 60),
                                    (40, 64)])
def test_linear_int8_equals_jax(rows, k):
    """_linear_int8 bit for bit the JAX package's on the same f32 inputs:
    K = 60 (the encoding's lanes, padded to 64 for the product) and 63,
    fewer rows than torch._int_mm takes on CUDA (padded to 17), and an
    aligned shape; and within the JAX test's error budget of the f32
    layer (~1/254 relative per operand over the dot)."""
    rng = np.random.RandomState(rows + k)
    x = rng.uniform(-1, 1, (rows, k)).astype(np.float32)
    w = (rng.randn(k, 64) * 0.1).astype(np.float32)
    b = (rng.randn(64) * 0.01).astype(np.float32)
    ref = np.asarray(jnet._linear_int8(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)))
    before = tnet.INT8_MM.launches
    got = tnet._linear_int8(t(w.T.copy()), t(b), t(x))
    assert tnet.INT8_MM.launches == before + 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (rows, 64)
    np.testing.assert_array_equal(a(got), a(jnp.asarray(ref, jnp.float32)))
    f32 = x @ w + b
    scale = max(float(np.abs(f32).max()), 1.0)
    assert np.abs(a(got) - f32).max() < 0.02 * scale


def test_int8_mm_pads_to_the_cuda_limits(monkeypatch):
    """int8_mm: K zero-padded to a multiple of 8 and M to 17 rows on every
    device, the exact int32 product either way; the operands in the one
    layout cuBLASLt's int8 product takes on the card (a row-major first
    operand, a column-major second: two row-major ones are refused there);
    a column count that is no multiple of 8 refused."""
    real = torch._int_mm
    layouts = []

    def int_mm(x, w):
        layouts.append((x.is_contiguous(), w.stride(0) == 1,
                        x.shape[0] >= 17, x.shape[1] % 8 == 0))
        return real(x, w)

    monkeypatch.setattr(torch, "_int_mm", int_mm)
    rng = np.random.RandomState(0)
    for m, k in ((3, 60), (17, 8), (33, 61), (40, 64)):
        xq = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
        wq = torch.from_numpy(rng.randint(-127, 128, (k, 16)).astype(np.int8))
        got = tnet.int8_mm(xq, wq)
        assert got.dtype == torch.int32 and tuple(got.shape) == (m, 16)
        assert torch.equal(got, xq.int() @ wq.int())
    assert layouts == [(True, True, True, True)] * 4, layouts
    with pytest.raises(ValueError, match="multiple of 8"):
        tnet.int8_mm(xq, wq[:, :12])


def test_int8_sigma_against_jax(setup):
    """The int8 sigma (trunk int8, sigma head at bfloat16_all) against the
    JAX package's: within one bf16 ulp; and, as the JAX test holds its
    own, within quantization noise of the float32 forward."""
    jm, tm, params, net, xyz = setup
    ref = np.asarray(jnet.sigma_fn(params, jm, jnp.asarray(xyz)))
    before = tnet.INT8_MM.launches
    with torch.no_grad():
        got = a(tnet.sigma_fn(net, tm, t(xyz)))
    # layers 0, 1 and 3, and the skip layer's two blocks
    assert tnet.INT8_MM.launches == before + 5
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=1e-6)
    with torch.no_grad():
        s32 = a(tnet.sigma_fn(net, dc.replace(tm, compute_dtype="float32"),
                              t(xyz)))
    rng = max(float(s32.max() - s32.min()), 1e-3)
    assert np.sqrt(np.mean((got - s32) ** 2)) / rng < 0.05


@pytest.mark.parametrize("fused,heads", [(False, False), (True, False),
                                         (True, True)])
def test_int8_normals_use_the_bf16_twin(setup, monkeypatch, fused, heads):
    """analytic_normals and apply_network_with_normals under int8 are the
    bfloat16_all programs (round() has no gradient, so the config is
    swapped before the kernel gate): equal bit for bit, through autograd,
    through K2's twin (fused_trunk) and through K4's (the switch set), and
    no int8 product runs."""
    jm, tm, params, net, xyz = setup
    if heads:
        monkeypatch.setenv("BRDFNERF_FUSED_HEADS", "1")
    else:
        monkeypatch.delenv("BRDFNERF_FUSED_HEADS", raising=False)
    bf = dc.replace(tm, compute_dtype="bfloat16_all")
    dirs = t(np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32),
                     (len(xyz), 1)))
    kw = dict(dirs=dirs, apply_brdf=True, fused_trunk=fused)
    before = tnet.INT8_MM.launches
    with torch.no_grad():
        o8 = tnet.apply_network_with_normals(net, tm, t(xyz), **kw)
        ob = tnet.apply_network_with_normals(net, bf, t(xyz), **kw)
        n8 = tnet.analytic_normals(net, tm, t(xyz))
        nb = tnet.analytic_normals(net, bf, t(xyz))
    assert tnet.INT8_MM.launches == before
    assert set(o8) == set(ob)
    for k in ob:
        assert torch.equal(o8[k], ob[k]), k
    assert torch.equal(n8, nb)
    # and the JAX package's int8 normals are its bfloat16_all ones
    jn8 = np.asarray(jnet.analytic_normals(params, jm, jnp.asarray(xyz)))
    jnb = np.asarray(jnet.analytic_normals(
        params, dc.replace(jm, compute_dtype="bfloat16_all"),
        jnp.asarray(xyz)))
    np.testing.assert_array_equal(jn8, jnb)


def test_int8_full_forward_heads(setup):
    """apply_network at int8 with every BRDF head: finite, the heads'
    ranges kept, close to the float32 forward (the JAX test's bounds), and
    each head against the JAX package's int8 forward within the bf16
    heads' rounding (2^-6 of the head's largest value or of 1, whichever
    is larger: four bf16 ulps at 1; the sigmoid heads sit near 0.5, whose
    ulp a flipped code moves them by, and rpv_theta doubles it)."""
    jm, tm, params, net, xyz = setup
    n = len(xyz)
    dirs = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    sun = np.tile(np.asarray([[0.3, 0.1, 0.95]], np.float32), (n, 1))
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    kw = dict(apply_brdf=True, apply_theta=True)
    with torch.no_grad():
        o8 = tnet.apply_network(net, tm, t(xyz), dirs=t(dirs), sun_d=t(sun),
                                **kw)
        o32 = tnet.apply_network(net, dc.replace(tm, compute_dtype="float32"),
                                 t(xyz), dirs=t(dirs), sun_d=t(sun), **kw)
    ref = jnet.apply_network(params, jm, jnp.asarray(xyz),
                             dirs=jnp.asarray(dirs), sun_d=jnp.asarray(sun),
                             **kw)
    assert set(o8) == set(ref)
    for k, v in o8.items():
        v = a(v)
        assert np.isfinite(v).all(), k
        r = a(o32[k])
        rng = max(float(r.max() - r.min()), 1e-3)
        assert np.abs(v - r).max() / rng < 0.25, k
        j = a(ref[k])
        top = max(float(np.abs(j).max()), 1.0)
        assert np.abs(v - j).max() <= 2.0 ** -6 * top, (k, np.abs(v - j)
                                                        .max(), top)
    for k, lo, hi in (("rgb", 0.0, 1.0), ("rpv_k", 0.0, 2.0),
                      ("rpv_rhoc", 0.0, 1.0)):
        v = a(o8[k])
        assert v.min() >= lo - 2e-3 and v.max() <= hi + 2e-3, k


@pytest.mark.parametrize("off", ["mapping", "siren"])
def test_int8_unbounded_trunk_stays_bf16(off):
    """A raw-xyz trunk (mapping off) or a ReLU trunk is unbounded: int8
    runs it at bfloat16_all bit for bit, with no int8 product, as the JAX
    package does."""
    kw = dict(INT8)
    kw[off] = False
    jm, tm = model_configs(**kw)
    params, net = networks(jm, tm, seed=3)
    xyz = (np.random.RandomState(4).randn(128, 3) * 3.0).astype(np.float32)
    before = tnet.INT8_MM.launches
    with torch.no_grad():
        s8 = tnet.sigma_fn(net, tm, t(xyz))
        sb = tnet.sigma_fn(net, dc.replace(tm, compute_dtype="bfloat16_all"),
                           t(xyz))
    assert tnet.INT8_MM.launches == before
    assert torch.equal(s8, sb)
    np.testing.assert_array_equal(
        np.asarray(jnet.sigma_fn(params, jm, jnp.asarray(xyz))),
        np.asarray(jnet.sigma_fn(
            params, dc.replace(jm, compute_dtype="bfloat16_all"),
            jnp.asarray(xyz))))


def test_int8_training_refused(tmp_path):
    """Trainer.fit refuses int8 with the JAX package's message while the
    Trainer itself constructs (a Network at int8 builds)."""
    from brdfnerf_tpu_torch.config import RenderConfig, RunConfig, TrainConfig
    from brdfnerf_tpu_torch.train import Trainer, TrainerPaths
    _, tm = model_configs(**INT8)
    cfg = RunConfig(model=tm,
                    render=RenderConfig(n_samples=4, guided_samples=0),
                    train=TrainConfig(lr=1e-3, batch_size=32,
                                      max_train_steps=4))
    n = 64
    store = {"rays": np.random.RandomState(0).rand(n, 11).astype(np.float32),
             "rgbs": np.random.RandomState(1).rand(n, 3).astype(np.float32),
             "ts": np.zeros(n, np.int32)}
    tr = Trainer(cfg, store, TrainerPaths(logs_dir=str(tmp_path / "l"),
                                          ckpts_dir=str(tmp_path / "c")),
                 seed=0, device="cpu")
    with pytest.raises(ValueError, match="serving-only"):
        tr.fit(max_steps=2, progress=False)


def test_cli_int8_eval_only():
    """--compute_dtype int8 is an eval-parser option of both packages; both
    train parsers refuse it."""
    from brdfnerf_tpu.cli import opts as jopts
    from brdfnerf_tpu_torch.cli import opts as topts
    for opts in (jopts, topts):
        args = opts.eval_parser().parse_args(
            ["--logs_dir", "x", "--epoch_number", "1",
             "--compute_dtype", "int8"])
        assert args.compute_dtype == "int8"
        with pytest.raises(SystemExit):
            opts.train_parser().parse_args(
                ["--exp_name", "e", "--root_dir", "r", "--model", "nerf",
                 "--compute_dtype", "int8"])


def test_kernel_gates_refuse_int8():
    """kernel_supports steers int8 off the fused kernels (the sigma passes
    take the int8 trunk, not K1), as the JAX package's does, and the CUDA
    kernels do not cover an int8 model; the bfloat16_all twin passes."""
    from brdfnerf_tpu.ops.pallas_mlp import kernel_supports as jsupports
    from brdfnerf_tpu_torch.ops.fused_mlp import (cuda_kernels_cover,
                                                  kernel_supports)
    kw = dict(variant="spsbrdf-nerf", siren=True, mapping=True, layers=8,
              feat=64, skips=(4,), compute_dtype="int8")
    jm, tm = model_configs(**kw)
    assert not kernel_supports(tm) and not jsupports(jm)
    assert not cuda_kernels_cover(tm)
    bf = dc.replace(tm, compute_dtype="bfloat16_all")
    assert kernel_supports(bf) and cuda_kernels_cover(bf)
    assert jsupports(dc.replace(jm, compute_dtype="bfloat16_all"))


def _render(net_or_params, mcfg, rcfg, rays, draws=None, key=None):
    if key is not None:
        out = jrender.render_rays(
            {"coarse": net_or_params}, mcfg, rcfg,
            jrender.RenderInputs(rays=jnp.asarray(rays),
                                 cos_irra_on=jnp.asarray(False)), key)
        return {k: a(out[k]) for k in ("rgb_coarse", "depth_coarse")}
    with torch.no_grad():
        out = trender.render_rays(
            net_or_params, mcfg, rcfg,
            trender.RenderInputs(rays=t(rays),
                                 cos_irra_on=torch.tensor(False)),
            draws=draws)
    return {k: a(out[k]) for k in ("rgb_coarse", "depth_coarse")}


def _gap(x, y, n):
    d = np.abs(x - y).reshape(n, -1).max(-1)
    return float(d.mean()), float(np.quantile(d, 0.99))


def test_int8_render_against_jax():
    """256 rays of the flagship render (probe, guided samples, sun march,
    main pass) at int8 against the JAX package's int8 render on its draws:
    rgb and depth within the scale of the JAX package's own int8 against
    bfloat16_all gap on the same rays (mean and p99 of the per-ray
    largest difference); the int8 sigma passes run int8 products and the
    main pass none."""
    jm, tm = model_configs(**INT8)
    jr, tr = render_configs(n_samples=8, guided_samples=8, apply_brdf=True,
                            use_pallas=True, fused_trunk=True)
    params, net = networks(jm, tm, seed=2)
    n = 256
    rays = make_rays(n, seed=5)
    key = jax.random.PRNGKey(3)
    ref8 = _render(params, jm, jr, rays, key=key)
    refb = _render(params, dc.replace(jm, compute_dtype="bfloat16_all"), jr,
                   rays, key=key)
    draws = render_draws(key, jr, n, jr.sun_march_count(16))
    before = tnet.INT8_MM.launches
    got = _render(net, tm, tr, rays, draws=draws)
    # the probe and the sun march: 5 products each
    assert tnet.INT8_MM.launches == before + 10
    for k in got:
        assert np.isfinite(got[k]).all(), k
        gap_mean, gap_p99 = _gap(ref8[k], refb[k], n)
        mean, p99 = _gap(got[k], ref8[k], n)
        assert gap_mean > 0, k
        assert mean <= gap_mean and p99 <= max(gap_p99, 1e-6), (
            k, mean, p99, gap_mean, gap_p99)


def test_load_renderer_and_eval_cli_at_int8(tmp_path, capsys):
    """serve.load_renderer(compute_dtype='int8', device='cpu') renders a
    run's rays (int8 products counted, outputs finite and near the
    bfloat16_all request), and the eval CLI's --compute_dtype int8 scores
    a run of the port's train CLI (its [kernels] line says how int8
    serves)."""
    from brdfnerf_tpu_torch import serve as tserve
    from brdfnerf_tpu_torch.cli import eval as teval
    from brdfnerf_tpu_torch.cli.train import main as port_train_main
    from brdfnerf_tpu_torch.data.synth_aoi import build_aoi
    info = build_aoi(str(tmp_path / "aoi"))
    logs, ckpts = str(tmp_path / "logs"), str(tmp_path / "ckpts")
    argv = ["--root_dir", info["root"], "--gt_dir", info["gt_dir"],
            "--aoi_id", info["aoi_id"], "--logs_dir", logs,
            "--ckpts_dir", ckpts, "--model", "spsbrdf-nerf", "--mapping",
            "--fc_feat", "64", "--fc_layers", "4", "--n_samples", "8",
            "--guided_samples", "8", "--batch_size", "256",
            "--ds_lambda", "10", "--eval_every_n_epochs", "0",
            "--normal", "analystic", "--sun_v", "analystic", "--funcM", "1",
            "--funcF", "1", "--funcH", "1", "--brdf_on", "0",
            "--compute_dtype", "bfloat16_all", "--exp_name", "run",
            "--max_train_steps", "4"]
    assert port_train_main(argv, device="cpu") == 0
    run_dir = os.path.join(logs, "run")
    rays = make_rays(200, seed=6)
    r8 = tserve.load_renderer(run_dir, 0, compute_dtype="int8",
                              device="cpu")
    rb = tserve.load_renderer(run_dir, 0, device="cpu")
    assert r8.cfg.model.compute_dtype == "int8"
    before = tnet.INT8_MM.launches
    o8 = r8.render_image({"rays": rays})
    assert tnet.INT8_MM.launches > before
    ob = rb.render_image({"rays": rays})
    assert set(o8) == set(ob)
    for k in o8:
        assert np.isfinite(o8[k]).all(), k
    assert np.abs(o8["rgb_coarse"] - ob["rgb_coarse"]).mean() < 0.05
    capsys.readouterr()
    assert teval.main(["--logs_dir", run_dir, "--epoch_number", "0",
                       "--compute_dtype", "int8", "--output_dir",
                       str(tmp_path / "ev")], device="cpu") == 0
    out = capsys.readouterr().out
    assert "mean: psnr" in out and "[kernels]" in out
    assert os.path.isdir(tmp_path / "ev")


@pytest.mark.parametrize("mapping,heads,want,absent", [
    (True, False, ["int8 products", "K2 (the trunk", "'int8'"],
     ["K1 (", "K4"]),
    (True, True, ["int8 products", "K4 in its place"], ["K1 ("]),
    (False, False, ["raw-xyz trunk at bfloat16_all", "K2 (the trunk"],
     ["K1 ("])])
def test_kernels_line_at_int8(monkeypatch, mapping, heads, want, absent):
    """The [kernels] line of an int8 request on the card: no K1 (the sigma
    passes' trunk is int8, or for a raw-xyz trunk bfloat16_all torch), the
    main pass's K2 (K4 with the switch) on the bfloat16_all twin."""
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.cli.train import kernels_line
    if heads:
        monkeypatch.setenv("BRDFNERF_FUSED_HEADS", "1")
    else:
        monkeypatch.delenv("BRDFNERF_FUSED_HEADS", raising=False)
    argv = ["--root_dir", "r", "--exp_name", "e", "--normal", "analystic",
            "--sun_v", "analystic", "--funcM", "1", "--funcF", "1",
            "--funcH", "1", "--brdf_on", "0.5"] + (["--mapping"] if mapping
                                                   else [])
    args = opts.postprocess(opts.train_parser().parse_args(argv))
    args.compute_dtype = "int8"
    cuda = torch.device("cuda")
    line = kernels_line(opts.to_run_config(args, device=cuda), cuda,
                        train=False)
    assert all(w in line for w in want), (want, line)
    assert not any(x in line for x in absent), (absent, line)
