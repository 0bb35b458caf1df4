"""sat-nerf's keypoint depth, --find_best_t and checkpoints with a fine
network and the t table, against the JAX package on the CPU: the keypoint
store (load_sparse_depth on build_aoi(with_keypoints=True)), compute_losses
with the keypoint render, the port's train CLI on sat-nerf --beta with
keypoints, the eval CLI's best-embedding search on a JAX checkpoint with
fine/ and t, and the JAX eval on the port's.

The evals render with the JAX package's draws fed to the port
(jax_chunk_draws); scores are held as tests/test_torch_port_eval.py holds
them (SCORE_TOL), the keypoint store bit for bit with the JAX package's
native dispatch off (its NumPy paths, which the port runs), the losses as
tests/test_torch_port_defaults.py holds them."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import brdfnerf_tpu.native as jnative
from brdfnerf_tpu.cli import opts as jopts
from brdfnerf_tpu.cli.eval import evaluate as jax_evaluate
from brdfnerf_tpu.data import satellite as jsat
from brdfnerf_tpu.parallel import train_step as jts
from brdfnerf_tpu.utils import checkpoint as jckpt

from brdfnerf_tpu_torch.cli import eval as teval
from brdfnerf_tpu_torch.cli.train import main as port_train_main
from brdfnerf_tpu_torch.data import satellite as tsat
from brdfnerf_tpu_torch.data.synth_aoi import build_aoi
from brdfnerf_tpu_torch.parallel import train_step as tts
from brdfnerf_tpu_torch.utils import checkpoint as tckpt

from test_torch_port_defaults import (GATES, SHADOW, TRUNK, both_params,
                                      hold_grads, hold_losses, jax_draws,
                                      jax_loss_grads, store_with_ts)
from test_torch_port_eval import SCORE_TOL
from test_torch_port_train import train_configs
from torch_port_common import model_configs, render_configs, t


@pytest.fixture(scope="module")
def aoi(tmp_path_factory):
    return build_aoi(str(tmp_path_factory.mktemp("kp") / "aoi"),
                     with_keypoints=True)


@pytest.fixture
def numpy_paths(monkeypatch):
    """The JAX package on its NumPy paths (no native dispatch)."""
    monkeypatch.setattr(jnative, "usable", lambda *a, **k: None)


@pytest.fixture
def jax_chunk_draws(monkeypatch):
    """Every chunk the port's block render draws for takes the JAX
    package's draws for PRNGKey(0) (its Trainer.render_image's key)."""
    import brdfnerf_tpu_torch.render.render as trender

    def draws(mcfg, rcfg, n_rays, device, seed=0):
        return jax_draws(jax.random.PRNGKey(0), mcfg, rcfg, n_rays)
    monkeypatch.setattr(trender, "chunk_draws", draws)


def _sat_configs(root, **kw):
    kw = dict(dict(root_dir=root, aoi_id="Synth_001", sparse_depth=True),
              **kw)
    return jsat.SatelliteConfig(**kw), tsat.SatelliteConfig(**kw)


def test_keypoint_store_matches_jax(aoi, numpy_paths):
    """load_sparse_depth (ECEF tie points to UTM, the rays at the keypoint
    pixels, depth |p - o| and the reprojection-error weights, image index
    and tie-point index) and the dataset's depth_store, equal to the JAX
    package's."""
    jc, tc = _sat_configs(aoi["root"])
    jds, tds = jsat.SatelliteDataset(jc, "train"), tsat.SatelliteDataset(
        tc, "train")
    ref = jsat.load_sparse_depth(jds.train_files, aoi["root"], jds.scene,
                                 cs="utm", aoi_id=aoi["aoi_id"])
    got = tsat.load_sparse_depth(tds.train_files, aoi["root"], tds.scene,
                                 cs="utm", aoi_id=aoi["aoi_id"])
    assert set(got) == set(ref) == {"rays", "depths", "ts", "kp_indices"}
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(
            got[k], ref[k]), k
    assert got["rays"].shape[1] == 8 and got["depths"].shape[1] == 2
    w = got["depths"][:, 1]
    assert np.all((w > 0) & (w <= 1)) and w.min() < 1
    assert set(tds.depth_store) == {"rays", "depths", "ts"}
    for k, v in jds.depth_store.items():
        assert np.array_equal(tds.depth_store[k], v), k
    w_t = tsat._keypoint_weights(tds.train_files,
                                 np.load(os.path.join(aoi["root"],
                                                      "pts3d.npy")),
                                 aoi["aoi_id"])
    assert np.array_equal(w_t, jsat._keypoint_weights(
        jds.train_files, np.load(os.path.join(aoi["root"], "pts3d.npy")),
        aoi["aoi_id"]))


def test_compute_losses_with_keypoints_match_jax(aoi, numpy_paths):
    """compute_losses of sat-nerf with beta and a keypoint sub-batch: the
    second render of the tie-point rays at eval (the same key's draws,
    draws['kp']), its DepthLoss over every keypoint ray under the kp_
    prefix; loss, terms and every gradient (t's included) against the JAX
    package's."""
    jm, tm = model_configs(**TRUNK, **SHADOW, variant="sat-nerf", beta=True)
    jr, tr = render_configs(n_samples=8, perturb=0.0)
    jt, tt = train_configs(sc_lambda=0.05, ds_lambda=10.0,
                           nr_reg_an_lambda=0.0, hs_lambda=0.0)
    params, tp = both_params(jm, tm)
    _, tc = _sat_configs(aoi["root"])
    kp = tsat.SatelliteDataset(tc, "train").depth_store
    n_kp = kp["rays"].shape[0]
    s = store_with_ts(16, seed=5)
    s.update(kp_rays=kp["rays"], kp_depths=kp["depths"], kp_ts=kp["ts"])
    key = jax.random.PRNGKey(9)
    (l_ref, (terms_ref, aux_ref)), g_ref = jax_loss_grads(
        params, jm, jr, jt, s, key, GATES)(params, s)
    loss, (terms, aux) = tts.compute_losses(
        tp, tm, tr, tt, {k: t(v) for k, v in s.items()},
        tts.TrainGates(**GATES), draws=jax_draws(key, jm, jr, 16, n_kp))
    loss.backward()
    assert "kp_coarse_ds" in terms and terms["kp_coarse_ds"].item() > 0
    hold_losses(loss, terms, aux, l_ref, terms_ref, aux_ref)
    hold_grads(tp, g_ref, "sat-nerf keypoints")


def _train_argv(aoi, logs, ckpts, name, extra=()):
    return ["--root_dir", aoi["root"], "--gt_dir", aoi["gt_dir"],
            "--aoi_id", aoi["aoi_id"], "--logs_dir", logs, "--ckpts_dir",
            ckpts, "--exp_name", name, "--mapping", "--fc_feat", "32",
            "--fc_layers", "4", "--n_samples", "8", "--guided_samples", "8",
            "--batch_size", "256", "--lr", "1e-3",
            "--eval_every_n_epochs", "0", "--t_embbeding_vocab", "2",
            *extra]


def test_train_cli_sat_nerf_beta_with_keypoints_then_both_evals(
        aoi, tmp_path, capsys, jax_chunk_draws):
    """The port's train CLI on sat-nerf --beta --n_importance 8 with the
    keypoint store (--ds_lambda 10), 4 steps: the keypoint line, no kernel,
    finite losses, a checkpoint of coarse, fine and t; then the JAX
    package's eval scores it as the port's eval does."""
    logs, ckpts = str(tmp_path / "logs"), str(tmp_path / "ckpts")
    argv = _train_argv(aoi, logs, ckpts, "kp", [
        "--model", "sat-nerf", "--beta", "--sun_v", "learned",
        "--sc_lambda", "0.05", "--ds_lambda", "10", "--n_importance", "8",
        "--max_train_steps", "4"])
    assert port_train_main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert "[kernels] none" in out and "keypoint rays" in out, out
    with open(os.path.join(logs, "kp", "scalars.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert losses and np.all(np.isfinite(losses))
    flat = tckpt.load_flat(os.path.join(ckpts, "kp", "epoch=0.npz"))
    assert flat["t"].shape == (2, 4)
    assert any(k.startswith("fine/") for k in flat)
    run_dir = os.path.join(logs, "kp")
    ref = jax_evaluate(run_dir, 0, output_dir=str(tmp_path / "jax"))
    got = teval.evaluate(run_dir, 0, output_dir=str(tmp_path / "port"),
                         device="cpu")
    print("JAX eval", ref, "port eval", got)
    for k, tol in SCORE_TOL:
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])


def test_eval_find_best_t_on_a_jax_checkpoint_picks_jax_s_t(
        aoi, tmp_path, capsys, jax_chunk_draws):
    """A JAX checkpoint of sps-nerf with beta and a fine network (coarse,
    fine, t) evaluated with --find_best_t by both packages' eval CLIs: the
    same embedding index for every image and the same scores."""
    logs, ckpts = str(tmp_path / "logs"), str(tmp_path / "ckpts")
    argv = _train_argv(aoi, logs, ckpts, "bt", [
        "--model", "sps-nerf", "--beta", "--sun_v", "learned",
        "--n_importance", "8", "--compute_dtype", "float32"])
    args = jopts.postprocess(jopts.train_parser().parse_args(argv))
    run_dir = os.path.join(logs, "bt")
    jopts.dump_opts(args, run_dir)
    cfg = jopts.to_run_config(args)
    jstate, _ = jts.create_train_state(jax.random.PRNGKey(4), cfg.model,
                                       cfg.train, 1, n_importance=8)
    params = dict(jstate.params)
    # distinct embeddings, so that the search has a choice to make
    params["t"] = jnp.asarray(np.random.RandomState(0).normal(
        0, 3, (2, 4)), jnp.float32)
    jckpt.save_checkpoint(os.path.join(ckpts, "bt", "epoch=0.npz"), params)
    capsys.readouterr()
    ref = jax_evaluate(run_dir, 0, find_best_t=True,
                       output_dir=str(tmp_path / "jax"))
    jax_t = [int(ln.split(":")[1].split()[0])
             for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[eval] best t for image")]
    got = teval.evaluate(run_dir, 0, find_best_t=True,
                         output_dir=str(tmp_path / "port"), device="cpu")
    port_t = [int(ln.split(":")[1].split()[0])
              for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("[eval] best t for image")]
    print("JAX", jax_t, ref, "port", port_t, got)
    assert port_t == jax_t and len(jax_t) == 2
    for k, tol in SCORE_TOL:
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])
