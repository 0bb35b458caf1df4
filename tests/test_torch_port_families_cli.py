"""The CLIs on a BRDF family, on the CPU: a JAX stage-1 train-CLI run on
the Hapke-shaded synthetic AOI hands off into the port's Hapke stage 2,
which the JAX package's eval CLI scores.  The JAX scores are held to the
port's eval of the same checkpoint fed the JAX package's draws, at 0.5 dB
PSNR, 0.02 SSIM and 0.05 m MAE, as tests/test_torch_port_cli.py holds the
RPV stage 2 (at 6 steps the model is near its random init, where draws
alone move the DSM MAE by up to 0.10 m)."""

import os

import numpy as np

import jax

from torch_port_common import render_draws


def test_jax_stage1_hands_off_to_port_hapke_stage2(tmp_path, monkeypatch):
    """A JAX stage-1 train-CLI run on the Hapke-shaded AOI hands off its
    trunk (no rgb head: Hapke's handoff) into the port's Hapke stage 2
    (b, c, theta, --hpk_scl 1), which brdfnerf_tpu.cli.eval scores within
    0.5 dB / 0.02 / 0.05 m of the port's eval on the JAX draws."""
    from brdfnerf_tpu.cli.eval import evaluate as jax_evaluate
    from brdfnerf_tpu.cli.train import main as jax_train_main
    import brdfnerf_tpu_torch.render.render as trender
    from brdfnerf_tpu_torch.cli.eval import evaluate as port_evaluate
    from brdfnerf_tpu_torch.cli.train import main as port_train_main
    from brdfnerf_tpu_torch.data.synth_aoi import HAPKE_GT, build_aoi
    from brdfnerf_tpu_torch.utils import checkpoint as tckpt
    info = build_aoi(str(tmp_path / "aoi"), bumpy=True, brdf=dict(HAPKE_GT))
    logs, ckpts = str(tmp_path / "logs"), str(tmp_path / "ckpts")
    common = ["--root_dir", info["root"], "--gt_dir", info["gt_dir"],
              "--aoi_id", info["aoi_id"], "--logs_dir", logs,
              "--ckpts_dir", ckpts, "--model", "spsbrdf-nerf", "--mapping",
              "--fc_feat", "64", "--fc_layers", "4", "--n_samples", "8",
              "--guided_samples", "8", "--batch_size", "256",
              "--ds_lambda", "10", "--lr", "1e-3", "--normal", "analystic",
              "--sun_v", "analystic", "--hpk_scl", "1",
              "--eval_every_n_epochs", "0"]
    assert jax_train_main(common + ["--exp_name", "s1",
                                    "--max_train_steps", "6"]) == 0
    stage1 = tckpt.latest_checkpoint(os.path.join(ckpts, "s1"))
    assert port_train_main(common + [
        "--b", "--c", "--theta", "--brdf_on", "0", "--exp_name", "s2",
        "--max_train_steps", "6", "--in_ckpts", stage1],
        device="cpu") == 0
    s2 = os.path.join(ckpts, "s2", "epoch=0.npz")
    with np.load(s2) as z:
        assert any(k.startswith("coarse/theta_from_xyz/") for k in z.files)
    run_dir = os.path.join(logs, "s2")
    ref = jax_evaluate(run_dir, 0, output_dir=str(tmp_path / "jev"))
    monkeypatch.setattr(
        trender, "chunk_draws",
        lambda mcfg, rcfg, n_rays, device, seed=0: render_draws(
            jax.random.PRNGKey(0), rcfg, n_rays,
            rcfg.sun_march_count(rcfg.total_samples)))
    got = port_evaluate(run_dir, 0, output_dir=str(tmp_path / "tev"),
                        device="cpu")
    for k, tol in (("psnr", 0.5), ("ssim", 0.02), ("mae", 0.05)):
        assert np.isfinite(got[k]) and abs(got[k] - ref[k]) <= tol, (
            k, got[k], ref[k])
