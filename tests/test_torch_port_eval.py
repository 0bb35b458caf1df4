"""The port's evaluation side against the JAX package, on the CPU: the eval
CLI (the North star's second check: a JAX-trained checkpoint scored by both
packages' eval), create_dsm, the BRF probes of analysis.py, depth_qa, the
reference-checkpoint import/export with convert_ckpt, and the block render
that serving, validation and evaluation render through.

Tolerances: whole-image scores are held to the cross-package bounds of
tests/test_torch_port_cli.py (0.5 dB PSNR, 0.02 SSIM, 0.05 m MAE), with the
port's eval fed the JAX package's draws (PRNGKey(0), as its eval renders
every chunk): at 8 steps the model is near its random init, and the port's
own draws alone move its scores by more than those bounds (its DSM MAE over
generator seeds 0-5 spans 1.60-1.70 m on the val split and 1.67-1.83 m as a
mean over the training images).  So the comparison shares the draws and
reads what differs between the packages, the arithmetic.  Where a probe's
draws are shared, each output is held to
test_torch_port_serve.close_slice's mean 1e-3 / p99 1e-2 of its per-ray
relative difference.  Host-only arithmetic (view directions,
weighted sums, depth_qa) is held at 1e-7 / 1e-6, checkpoint conversion and
the block render bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import jax

import brdfnerf_tpu.native as jnative
from brdfnerf_tpu import analysis as janalysis
from brdfnerf_tpu.cli import create_dsm as jcreate_dsm
from brdfnerf_tpu.cli import depth_qa as jdepth_qa
from brdfnerf_tpu.cli.eval import evaluate as jax_evaluate
from brdfnerf_tpu.cli.train import main as jax_train_main
from brdfnerf_tpu.serve import load_renderer as jax_load_renderer
from brdfnerf_tpu.utils import torch_export as jexport
from brdfnerf_tpu.utils import torch_import as jimport

from brdfnerf_tpu_torch import analysis as tanalysis
from brdfnerf_tpu_torch import serve as tserve
from brdfnerf_tpu_torch.cli import brf_probe as tbrf_probe
from brdfnerf_tpu_torch.cli import convert_ckpt as tconvert
from brdfnerf_tpu_torch.cli import create_dsm as tcreate_dsm
from brdfnerf_tpu_torch.cli import depth_qa as tdepth_qa
from brdfnerf_tpu_torch.cli import eval as teval
from brdfnerf_tpu_torch.cli.train import main as port_train_main
from brdfnerf_tpu_torch.config import RunConfig, TrainConfig
from brdfnerf_tpu_torch.data.synth_aoi import build_aoi
from brdfnerf_tpu_torch.parallel.train_step import render_blocks
from brdfnerf_tpu_torch.utils import checkpoint as tckpt
from brdfnerf_tpu_torch.utils import torch_export as texport
from brdfnerf_tpu_torch.utils import torch_import as timport

from torch_port_common import (SMALL, FLAGSHIP_HEADS, make_rays,
                               model_configs, networks, render_configs,
                               render_draws)
from test_torch_port_serve import close_slice

SCORE_TOL = (("psnr", 0.5), ("ssim", 0.02), ("mae", 0.05))
# the JAX Trainer that the JAX package's load_renderer builds opens its
# scalar log in the output directory, which is not an evaluation output
NOT_OUTPUTS = ("scalars.jsonl",)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A run of the JAX package's train CLI at 4x64 with the flagship heads
    (8 steps) on the tiny synthetic AOI."""
    root = tmp_path_factory.mktemp("eval")
    info = build_aoi(str(root / "aoi"))
    logs, ckpts = str(root / "logs"), str(root / "ckpts")
    argv = ["--root_dir", info["root"], "--gt_dir", info["gt_dir"],
            "--aoi_id", info["aoi_id"], "--logs_dir", logs,
            "--ckpts_dir", ckpts, "--model", "spsbrdf-nerf", "--mapping",
            "--fc_feat", "64", "--fc_layers", "4", "--n_samples", "8",
            "--guided_samples", "8", "--batch_size", "256",
            "--ds_lambda", "10", "--lr", "1e-3",
            "--eval_every_n_epochs", "0", "--normal", "analystic",
            "--sun_v", "analystic", "--funcM", "1", "--funcF", "1",
            "--funcH", "1", "--brdf_on", "0", "--nr_reg_an_lambda", "0.1",
            "--hs_lambda", "0.5", "--exp_name", "run",
            "--max_train_steps", "8"]
    assert jax_train_main(argv) == 0
    return {"root": root, "info": info, "run_dir": os.path.join(logs, "run"),
            "npz": os.path.join(ckpts, "run", "epoch=0.npz"), "argv": argv}


@pytest.fixture
def jax_draws(monkeypatch):
    """Every chunk the port's block render draws for takes the JAX
    package's draws for PRNGKey(0) instead (render_draws)."""
    import brdfnerf_tpu_torch.render.render as trender

    def draws(mcfg, rcfg, n_rays, device, seed=0):
        return render_draws(jax.random.PRNGKey(0), rcfg, n_rays,
                            rcfg.sun_march_count(rcfg.total_samples))
    monkeypatch.setattr(trender, "chunk_draws", draws)


@pytest.fixture
def numpy_paths(monkeypatch):
    """The JAX package on its NumPy paths (no native dispatch), which the
    port runs."""
    monkeypatch.setattr(jnative, "usable", lambda *a, **k: None)


def _files(d):
    return sorted(os.path.relpath(os.path.join(a, f), d)
                  for a, _, names in os.walk(d) for f in names
                  if not f.endswith(NOT_OUTPUTS))


def _close_scores(got, ref):
    for k, tol in SCORE_TOL:
        assert np.isfinite(got[k]) and np.isfinite(ref[k]), (k, got, ref)
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])


def test_port_eval_scores_a_jax_checkpoint_as_jax_does(run, tmp_path,
                                                      capsys, jax_draws):
    """The North star's second check: the JAX run's epoch=0.npz scored by
    both packages' eval on the val split (means over the test image)."""
    ref = jax_evaluate(run["run_dir"], 0, output_dir=str(tmp_path / "jax"))
    capsys.readouterr()
    got = teval.evaluate(run["run_dir"], 0, output_dir=str(tmp_path / "port"),
                         device="cpu")
    out = capsys.readouterr().out
    print("JAX eval", ref, "port eval", got)
    _close_scores(got, ref)
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))
    assert any(f.startswith("rdsm/") for f in _files(str(tmp_path / "port")))
    assert "[kernels] none: the run is on the CPU" in out
    assert "not ported" not in out
    assert sum(f.endswith("_panels.png")
               for f in _files(str(tmp_path / "port"))) == 2
    lines = out.splitlines()
    assert sum(ln.startswith("img_") and " psnr " in ln for ln in lines) == 2
    assert [ln for ln in lines if ln.startswith("mean: psnr ")] == [
        f"mean: psnr {got['psnr']:.2f} ssim {got['ssim']:.3f} "
        f"mae {got['mae']:.3f} mae_nr {got['mae_nr']:.2f}"]


def test_eval_split_train_scores_every_training_image(run, tmp_path,
                                                      capsys, jax_draws):
    ref = jax_evaluate(run["run_dir"], 0, split="train",
                       output_dir=str(tmp_path / "jax"))
    capsys.readouterr()
    assert teval.main(["--logs_dir", run["run_dir"], "--epoch_number", "0",
                       "--split", "train", "--output_dir",
                       str(tmp_path / "port")], device="cpu") == 0
    out = capsys.readouterr().out
    got = dict(zip(("psnr", "ssim", "mae"),
                   (float(v) for v in [ln for ln in out.splitlines()
                                       if ln.startswith("mean:")][0]
                    .split()[2:7:2])))
    print("JAX eval", ref, "port eval", got)
    _close_scores(got, ref)
    r = tserve.load_renderer(run["run_dir"], 0, split="train", device="cpu")
    assert r.dataset.split == "train_render"
    assert len(r) == len(r.dataset.train_files) == 2
    assert not any(r.get_image(i)["is_val"] for i in range(len(r)))
    # every training image is scored, one line each (with no MAE on the
    # line, as the JAX CLI prints it for an image that is not is_val)
    assert sum(ln.startswith("img_") and " psnr " in ln
               for ln in out.splitlines()) == 2
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))


def test_create_dsm_against_jax(run, tmp_path, capsys, numpy_paths,
                                jax_draws):
    jds = jax_load_renderer(run["run_dir"], 0).dataset
    tds = tserve.load_renderer(run["run_dir"], 0, device="cpu").dataset
    jv, js = jcreate_dsm.most_nadir_indices(jds)
    tv, ts = tcreate_dsm.most_nadir_indices(tds)
    assert tv == jv and np.array_equal(ts, js), (tv, jv, ts, js)

    def mae(text):
        [v] = [float(ln.split()[2]) for ln in text.splitlines()
               if ln.startswith("DSM MAE")]
        return v

    argv = ["--logs_dir", run["run_dir"], "--epoch_number", "0"]
    capsys.readouterr()
    assert jcreate_dsm.main(argv + ["--output_dir",
                                    str(tmp_path / "jax")]) == 0
    ref = mae(capsys.readouterr().out)
    assert tcreate_dsm.main(argv + ["--output_dir", str(tmp_path / "port")],
                            device="cpu") == 0
    got = mae(capsys.readouterr().out)
    print("DSM MAE: JAX", ref, "port", got)
    assert np.isfinite(got) and abs(got - ref) <= 0.05
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))


def test_view_directions_and_weighted_sums_equal_jax():
    rng = np.random.RandomState(3)
    sun = rng.normal(size=3)
    sun /= np.linalg.norm(sun)
    np.testing.assert_allclose(tanalysis.view_dir_fan(sun, 17, 55.0),
                               janalysis.view_dir_fan(sun, 17, 55.0),
                               atol=1e-7, rtol=0)
    el, az = rng.uniform(0, 90, (4, 5)), rng.uniform(0, 360, (4, 5))
    np.testing.assert_allclose(tanalysis.get_view_dirs(el, az),
                               janalysis.get_view_dirs(el, az),
                               atol=1e-7, rtol=0)
    w, x = rng.uniform(size=(6, 9)), rng.normal(size=(6, 9, 3))
    np.testing.assert_allclose(tanalysis.weighted_sample_sum(w, x),
                               janalysis.weighted_sample_sum(w, x),
                               atol=1e-7, rtol=0)


def test_brf_and_param_probes_against_jax():
    """Both probes on the same weights, the port fed the JAX package's
    draws from PRNGKey(0) for each of its renders."""
    jm, tm = model_configs(**SMALL, **FLAGSHIP_HEADS, compute_dtype="float32")
    jr, tr = render_configs(n_samples=8, guided_samples=8, apply_brdf=True,
                            use_pallas=True, fused_trunk=True)
    params, net = networks(jm, tm, seed=2)
    key = jax.random.PRNGKey(0)

    def draws(n):
        return render_draws(key, jr, n, jr.sun_march_count(16))

    ray = make_rays(1, seed=9)[0]
    n = 9
    ref = janalysis.brf_probe({"coarse": params}, jm, jr, ray, n_views=n,
                              key=key)
    got = tanalysis.brf_probe(net, tm, tr, ray, n_views=n, draws=draws)
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["view_zenith_deg"],
                                  ref["view_zenith_deg"])
    for k in ("brf", "rgb", "albedo"):
        assert got[k].shape == (n, 3), k
        close_slice(torch.from_numpy(got[k]), ref[k], n, k)

    ref = janalysis.pixel_param_probe({"coarse": params}, jm, jr, ray,
                                      key=key)
    got = tanalysis.pixel_param_probe(net, tm, tr, ray, draws=draws)
    assert sorted(got) == sorted(ref)
    for k in got:
        g, r = np.atleast_1d(got[k]), np.atleast_1d(np.asarray(ref[k]))
        assert g.shape == r.shape, k
        close_slice(torch.from_numpy(g.reshape(-1)), r.reshape(-1), 1, k)


def test_depth_qa_equals_jax(run, tmp_path, numpy_paths):
    info = run["info"]
    ref = jdepth_qa.depth_qa(info["root"], info["gt_dir"], info["aoi_id"],
                             out_dir=str(tmp_path / "jax"))
    got = tdepth_qa.depth_qa(info["root"], info["gt_dir"], info["aoi_id"],
                             out_dir=str(tmp_path / "port"))
    assert sorted(got) == sorted(ref) and len(got) == 3
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, (k, got[k], ref[k])
    assert tdepth_qa.main(["--root_dir", info["root"], "--gt_dir",
                           info["gt_dir"], "--aoi_id", info["aoi_id"]],
                          device="cpu") == 0


def _lightning_state_dict():
    """A reference-style state_dict: Sequential heads (Linear at even
    indices), bare nn.Linear heads, the t-embedding, and keys the
    converter must skip (a loss buffer, a module path of another layout)."""
    g = torch.Generator().manual_seed(4)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    return {
        "nerf_coarse.fc_net.0.weight": r(16, 6),
        "nerf_coarse.fc_net.0.bias": r(16),
        "nerf_coarse.fc_net.2.weight": r(16, 16),
        "nerf_coarse.fc_net.2.bias": r(16),
        "nerf_coarse.sigma_from_xyz.0.weight": r(1, 16),
        "nerf_coarse.sigma_from_xyz.0.bias": r(1),
        "nerf_coarse.feats_from_xyz.weight": r(16, 16),
        "nerf_coarse.feats_from_xyz.bias": r(16),
        "nerf_fine.rgb_from_xyzdir.2.weight": r(3, 8),
        "embedding_t.weight": r(5, 4),
        "loss.buffer": r(2),
        "nerf_coarse.odd.0.1.weight": r(2, 2),
    }


def _assert_flat_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_checkpoint_conversion_equals_jax_both_ways(tmp_path):
    sd = _lightning_state_dict()
    js, ts = [], []
    _assert_flat_equal(timport.convert_state_dict(sd, skipped=ts),
                       jimport.convert_state_dict(sd, skipped=js))
    assert ts == js == ["nerf_coarse.odd.0.1.weight"]
    ckpt = str(tmp_path / "epoch=3.ckpt")
    torch.save({"state_dict": sd, "global_step": 7, "epoch": 3}, ckpt)
    flat = timport.import_torch_checkpoint(ckpt)
    _assert_flat_equal(flat, jimport.import_torch_checkpoint(ckpt))
    assert int(flat["__step__"]) == 7
    _assert_flat_equal(texport.flat_to_state_dict(flat),
                       jexport.flat_to_state_dict(flat))
    # a port export read by the JAX import, and the reverse, bit-equal
    tpath, jpath = str(tmp_path / "t.ckpt"), str(tmp_path / "j.ckpt")
    texport.export_torch_checkpoint(flat, tpath)
    jexport.export_torch_checkpoint(flat, jpath)
    _assert_flat_equal(jimport.import_torch_checkpoint(tpath), flat)
    _assert_flat_equal(timport.import_torch_checkpoint(jpath), flat)
    # the port's load_flat reads reference checkpoints as the JAX one does
    _assert_flat_equal(tckpt.load_flat(ckpt), flat)
    # full unpickling needs the explicit opt-in
    bad = str(tmp_path / "bad.ckpt")
    torch.save({"state_dict": sd, "hook": os.path.join}, bad)
    with pytest.raises(ValueError, match="BRDFNERF_ALLOW_UNSAFE_CKPT"):
        timport.import_torch_checkpoint(bad)


@pytest.mark.parametrize("pair", [("a.npz", "b.npz"), ("a.ckpt", "b.pth"),
                                  ("a.ckpt", "b.txt"), ("a.txt", "b.ckpt")])
def test_convert_ckpt_refuses_bad_extensions(tmp_path, capsys, pair):
    argv = ["--input", str(tmp_path / pair[0]),
            "--output", str(tmp_path / pair[1])]
    assert tconvert.main(argv, device="cpu") == 2
    assert "error:" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_reference_checkpoint_serves_evaluates_and_hands_off(run, tmp_path,
                                                            capsys):
    """npz -> ckpt -> npz through the port's CLI is bit-equal; a .ckpt alone
    in a checkpoints directory loads in load_renderer (resolve_epoch_ckpt)
    and the port's train CLI hands off from a .ckpt (--in_ckpts)."""
    conv = tmp_path / "conv"
    conv.mkdir()
    ck, back = str(conv / "epoch=0.ckpt"), str(tmp_path / "back.npz")
    assert tconvert.main(["--input", run["npz"], "--output", ck]) == 0
    assert tconvert.main(["--input", ck, "--output", back]) == 0
    lines = capsys.readouterr().out.splitlines()
    with np.load(run["npz"]) as z:
        n = len([k for k in z.files if k != "__step__"])
        _assert_flat_equal(dict(np.load(back)), {k: z[k] for k in z.files})
    assert lines == [f"{run['npz']} -> {ck} ({n} params)",
                     f"{ck} -> {back} ({n} params, step 8)"]

    r_npz = tserve.load_renderer(run["run_dir"], 0, device="cpu")
    r_ck = tserve.load_renderer(run["run_dir"], 0, checkpoints_dir=str(conv),
                                device="cpu")
    _assert_flat_equal(tckpt.params_to_flat(r_ck.net),
                       tckpt.params_to_flat(r_npz.net))

    argv = [a if a != "run" else "handoff" for a in run["argv"]]
    argv[argv.index("--max_train_steps") + 1] = "2"
    assert port_train_main(argv + ["--in_ckpts", ck], device="cpu") == 0
    assert f"[handoff] restored ['coarse/fc_net'" in capsys.readouterr().out


def _block_setup(n_rays):
    jm, tm = model_configs(**SMALL, **FLAGSHIP_HEADS, compute_dtype="float32")
    _, tr = render_configs(n_samples=8, guided_samples=8, apply_brdf=True,
                           use_pallas=True, fused_trunk=True)
    _, net = networks(jm, tm, seed=1)
    cfg = RunConfig(model=tm, render=tr, train=TrainConfig())
    return net, cfg, make_rays(n_rays, seed=11)


@pytest.mark.parametrize("n_rays,chunk,block", [(300, 64, 2), (300, 64, 1),
                                                (50, 64, None)])
def test_block_render_is_bit_identical_to_the_chunk_loop(n_rays, chunk,
                                                         block):
    """A ray count that is no multiple of the chunk, blocks smaller than
    the chunk count (and a last block that is short), and fewer rays than a
    chunk: every output equal to render_in_chunks's bit for bit."""
    net, cfg, rays = _block_setup(n_rays)
    cpu = torch.device("cpu")
    ref = tserve.render_in_chunks(net, cfg, cfg.render, rays, chunk, cpu)
    got = render_blocks(net, cfg.model, cfg.render, rays, chunk, cpu,
                        cfg.train.cos_irra_on < 1.0, tserve.PER_RAY_KEYS,
                        tserve.PANEL_ACCUM, block=block)
    assert list(got) == list(ref) and len(got) >= 10
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        assert np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize("env,loop", [(None, False), ("0", False),
                                      ("1", True), ("yes", True)])
def test_render_image_takes_the_block_render_unless_switched_off(
        monkeypatch, env, loop):
    """BRDFNERF_NO_SCAN_RENDER set to anything truthy restores the chunk
    loop (the JAX package's switch)."""
    import brdfnerf_tpu_torch.parallel.train_step as ts
    if env is None:
        monkeypatch.delenv("BRDFNERF_NO_SCAN_RENDER", raising=False)
    else:
        monkeypatch.setenv("BRDFNERF_NO_SCAN_RENDER", env)
    calls = []
    blocks, chunks = ts.render_blocks, tserve.render_in_chunks

    def block_render(*a, **k):
        calls.append("block")
        return blocks(*a, **k)

    def chunk_loop(*a, **k):
        calls.append("loop")
        return chunks(*a, **k)

    monkeypatch.setattr(ts, "render_blocks", block_render)
    monkeypatch.setattr(tserve, "render_in_chunks", chunk_loop)
    net, cfg, rays = _block_setup(130)
    out = tserve.render_image_rays(net, cfg, cfg.render, rays, 64,
                                   torch.device("cpu"))
    assert calls == ["loop" if loop else "block"]
    assert out["rgb_coarse"].shape == (130, 3)


def test_eval_states_its_kernels(monkeypatch):
    """The eval CLI's kernels line at the flagship's width on the card: the
    serving instantiations (K1, K2 or K4; no backward), or why none; at
    float32 K1 and K2, and with BRDFNERF_FUSED_HEADS K4 in K2's place (at
    float32 too, since K4's float32 instantiation)."""
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.cli.train import kernels_line
    cuda = torch.device("cuda")
    base = ["--root_dir", "r", "--exp_name", "e", "--mapping", "--normal",
            "analystic", "--compute_dtype"]
    for dtype, heads, want, absent in (
            ("bfloat16_all", False, ["K1 (the sigma-only passes)",
                                     "K2 (the trunk with its sigma"],
             ["K3", "K4"]),
            ("bfloat16_all", True, ["K1", "K4 in its place"], ["K3", "K5"]),
            ("float32", False, ["K1 (the sigma-only passes)",
                                "K2 (the trunk with its sigma",
                                "compute_dtype='float32'"], ["K3", "K4"]),
            ("float32", True, ["K1", "K4 in its place",
                               "compute_dtype='float32'"], ["K3", "K5"]),
            ("bfloat16", False, ["K1 (the sigma-only passes)",
                                 "K2 (the trunk with its sigma"],
             ["K3", "K4"]),
            ("bfloat16", True, ["K1", "K4 in its place"], ["K3", "K5"])):
        if heads:
            monkeypatch.setenv("BRDFNERF_FUSED_HEADS", "1")
        else:
            monkeypatch.delenv("BRDFNERF_FUSED_HEADS", raising=False)
        args = opts.postprocess(opts.train_parser().parse_args(base
                                                               + [dtype]))
        line = kernels_line(opts.to_run_config(args, device=cuda), cuda,
                            train=False)
        assert all(w in line for w in want), (want, line)
        assert not any(a in line for a in absent), (absent, line)


def test_eval_parser_matches_jax():
    from brdfnerf_tpu.cli import opts as jopts
    from brdfnerf_tpu_torch.cli import opts as topts
    argv = ["--logs_dir", "l", "--epoch_number", "3"]
    assert (vars(topts.eval_parser().parse_args(argv))
            == vars(jopts.eval_parser().parse_args(argv)))
    flags = lambda p: sorted(a.dest for a in p._actions)   # noqa: E731
    assert flags(topts.eval_parser()) == flags(jopts.eval_parser())


@pytest.mark.parametrize("kw", [dict(compute_dtype="int8"),
                                dict(n_devices=2)])
def test_eval_runs_what_it_once_refused(run, tmp_path, kw):
    """The eval CLI's evaluate at int8 (Queue 1 item 10) and on two
    serving replicas (item 11) scores the JAX-trained run on the CPU:
    finite scores, the outputs written; two replicas score what one
    device scores (each chunk's rays split over them, as the JAX
    package's sharded render), and int8 within the cross-package bounds
    of its bfloat16 scores."""
    out = tmp_path / "ev"
    got = teval.evaluate(run["run_dir"], 0, output_dir=str(out),
                         device="cpu", **kw)
    assert all(np.isfinite(got[k]) for k in ("psnr", "ssim", "mae")), got
    assert any(f.endswith("_rgb.tif") for f in _files(out))
    ref = teval.evaluate(run["run_dir"], 0, output_dir=str(tmp_path / "one"),
                         device="cpu")
    if "n_devices" in kw:
        for k in ("psnr", "ssim", "mae"):
            assert abs(got[k] - ref[k]) <= 1e-4 * (1 + abs(ref[k])), k
    else:
        _close_scores(got, ref)


def test_find_best_t_on_a_run_with_the_t_embedding(run, tmp_path, capsys):
    """--find_best_t does nothing on a run without the t-embedding (as in
    the JAX package) and searches every embedding index on a run with it
    (its choice against the JAX package's:
    tests/test_torch_port_defaults_cli.py), here with --normal_at_surface
    overriding the run's render."""
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.models.network import init_params
    argv = [a if a != "run" else "beta" for a in run["argv"]] + [
        "--beta", "--t_embbeding_vocab", "2"]
    args = opts.postprocess(opts.train_parser().parse_args(argv))
    run_dir = os.path.join(args.logs_dir, args.exp_name)
    opts.dump_opts(args, run_dir)
    cfg = opts.to_run_config(args, device="cpu")
    params = init_params(cfg.model, torch.Generator().manual_seed(0),
                         device="cpu")
    tckpt.save_checkpoint(os.path.join(args.ckpts_dir, args.exp_name,
                                       "epoch=0.npz"),
                          params)
    def best_t():
        return [int(ln.split(":")[1].split()[0])
                for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[eval] best t for image")]

    capsys.readouterr()
    res = teval.evaluate(run_dir, 0, find_best_t=True, normal_at_surface=1,
                         device="cpu", output_dir=str(tmp_path / "ev"))
    found = best_t()
    assert len(found) == 2 and all(0 <= b < 2 for b in found)
    assert np.isfinite(res["psnr"])
    teval.evaluate(run["run_dir"], 0, find_best_t=True, device="cpu",
                   output_dir=str(tmp_path / "ev2"))
    assert best_t() == []


def test_evaluation_entry_points_need_the_card_or_a_device(run, tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--logs_dir", run["run_dir"], "--epoch_number", "0",
            "--output_dir", str(tmp_path / "out")]
    for main in (teval.main, tcreate_dsm.main, tbrf_probe.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.evaluate(run["run_dir"], 0)
    assert not (tmp_path / "out").exists()


def test_brf_probe_cli(run, tmp_path, capsys):
    out = tmp_path / "brf"
    assert tbrf_probe.main(["--logs_dir", run["run_dir"], "--epoch_number",
                            "0", "--param_probe", "--n_views", "7",
                            "--output_dir", str(out)], device="cpu") == 0
    text = capsys.readouterr().out
    assert "-- param probe (16,16):" in text and "rpv_k:" in text
    [txt] = [f for f in os.listdir(out) if f.endswith(".txt")]
    curve = np.loadtxt(out / txt)
    assert curve.shape == (7, 4) and np.isfinite(curve).all()
