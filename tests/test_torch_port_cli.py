"""Checkpoints move both ways through the two packages' CLIs, on the CPU: a
stage-1 run of the JAX package's train CLI hands off its epoch=N.npz into
the port's train CLI for stage 2, and the JAX package's eval CLI scores the
port's stage-2 run directory (its opts.json and epoch=N.npz).  The port's
own validation of the same checkpoint scored the same images with its own
draws; at 8 steps the model is near its random init, where draws alone
move the DSM MAE by up to 0.10 m (tests/test_torch_port_eval.py), so the
JAX scores are held to the port's eval of the same checkpoint fed the JAX
package's draws (PRNGKey(0), as test_torch_port_eval.py does), at 0.5 dB
PSNR, 0.02 SSIM and 0.05 m MAE; the validation's scores are held finite.
"""

import json
import os

import numpy as np
import pytest

from brdfnerf_tpu.cli.eval import evaluate as jax_evaluate
from brdfnerf_tpu.cli.eval import main as jax_eval_main
from brdfnerf_tpu.cli.train import main as jax_train_main

from brdfnerf_tpu_torch.cli.train import main as port_train_main
from brdfnerf_tpu_torch.data.synth_aoi import build_aoi
from brdfnerf_tpu_torch.utils import checkpoint as tckpt

import torch_port_common  # noqa: F401  (one torch thread a process)


def test_jax_stage1_hands_off_to_port_stage2_which_jax_evaluates(
        tmp_path, capsys, monkeypatch):
    info = build_aoi(str(tmp_path / "aoi"))
    logs, ckpts = str(tmp_path / "logs"), str(tmp_path / "ckpts")
    common = ["--root_dir", info["root"], "--gt_dir", info["gt_dir"],
              "--aoi_id", info["aoi_id"], "--logs_dir", logs,
              "--ckpts_dir", ckpts, "--model", "spsbrdf-nerf", "--mapping",
              "--fc_feat", "64", "--fc_layers", "4", "--n_samples", "8",
              "--guided_samples", "8", "--batch_size", "256",
              "--ds_lambda", "10", "--lr", "1e-3",
              "--eval_every_n_epochs", "0"]
    assert jax_train_main(common + ["--exp_name", "s1",
                                    "--max_train_steps", "8"]) == 0
    stage1 = tckpt.latest_checkpoint(os.path.join(ckpts, "s1"))
    assert stage1.endswith("epoch=0.npz")

    heads = ["--normal", "analystic", "--sun_v", "analystic", "--funcM",
             "1", "--funcF", "1", "--funcH", "1", "--brdf_on", "0",
             "--nr_reg_an_lambda", "0.1", "--hs_lambda", "0.5"]
    capsys.readouterr()
    assert port_train_main(common + heads + [
        "--exp_name", "s2", "--max_train_steps", "8",
        "--in_ckpts", stage1], device="cpu") == 0
    out = capsys.readouterr().out
    assert "[handoff] restored ['coarse/fc_net'" in out
    assert "[kernels] none: the run is on the CPU" in out
    s2 = os.path.join(ckpts, "s2", "epoch=0.npz")
    assert tckpt.checkpoint_step(s2) == 8
    with np.load(s2) as z:
        assert any(k.startswith("coarse/rhoc_from_xyz/") for k in z.files)

    run_dir = os.path.join(logs, "s2")
    assert jax_eval_main(["--logs_dir", run_dir, "--epoch_number", "0"]) == 0
    files = os.listdir(os.path.join(run_dir, "eval_epoch0"))
    assert sum(f.endswith("_rgb.tif") for f in files) == 2
    assert os.path.isdir(os.path.join(run_dir, "eval_epoch0", "rdsm"))

    scores = jax_evaluate(run_dir, 0, output_dir=str(tmp_path / "ev"))
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        val = [json.loads(ln) for ln in f if '"val/psnr_1"' in ln][-1]
    # the eval CLI's means run over the test images alone (is_val)
    port_val = {k: val[f"val/{k}_1"] for k in ("psnr", "ssim", "mae")}
    assert all(np.isfinite(v) for v in port_val.values()), port_val
    # the port's eval of the same checkpoint on the JAX package's draws
    import jax
    import brdfnerf_tpu_torch.render.render as trender
    from brdfnerf_tpu_torch.cli.eval import evaluate as port_evaluate
    from torch_port_common import render_draws
    monkeypatch.setattr(
        trender, "chunk_draws",
        lambda mcfg, rcfg, n_rays, device, seed=0: render_draws(
            jax.random.PRNGKey(0), rcfg, n_rays,
            rcfg.sun_march_count(rcfg.total_samples)))
    port = port_evaluate(run_dir, 0, output_dir=str(tmp_path / "port_ev"),
                         device="cpu")
    print("JAX eval", scores, "port eval on its draws", port,
          "port validation", port_val)
    for k, tol in (("psnr", 0.5), ("ssim", 0.02), ("mae", 0.05)):
        assert np.isfinite(scores[k]) and abs(scores[k] - port[k]) <= tol, k

    # the port serves the run by image index (the val split's dataset
    # from opts.json), as its validation rendered it
    from brdfnerf_tpu_torch.serve import load_renderer
    r = load_renderer(run_dir, 0, device="cpu")
    assert len(r) == 2
    by_index = r.render_image(1)
    by_sample = r.render_image(r.get_image(1))
    assert set(by_index) == set(by_sample)
    for k in by_sample:
        assert np.array_equal(by_index[k], by_sample[k]), k


@pytest.mark.parametrize("dtype,heads_env,want", [
    ("float32", False, ["K1 (the sigma-only passes)", "K2 + K3",
                        "compute_dtype='float32'", "bf16 hi and lo"]),
    ("bfloat16_all", False, ["K1 (the sigma-only passes)", "K2 + K3"]),
    ("bfloat16_all", True, ["K1", "K2 + K3", "K4 + K5", "FUSED_HEADS"]),
    ("bfloat16", False, ["K1 (the sigma-only passes)", "K2 + K3",
                         "compute_dtype='bfloat16'"]),
    ("bfloat16", True, ["K1", "K2 + K3", "K4 + K5 in their place"]),
    ("float32", True, ["K1", "K2 + K3", "K4 + K5 in their place",
                       "compute_dtype='float32'", "bf16 hi and lo"])])
def test_train_cli_states_its_kernels(monkeypatch, dtype, heads_env, want):
    """The line the train CLI prints for a run on the card, at the
    flagship's width: which fused kernels run, or why none.  Every dtype
    the kernels take (float32 as split products) names K1 and K2 + K3;
    with BRDFNERF_FUSED_HEADS, K4 + K5 take K2 + K3's place at every
    dtype (at float32 since their split instantiations)."""
    import torch
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.cli.train import kernels_line
    if heads_env:
        monkeypatch.setenv("BRDFNERF_FUSED_HEADS", "1")
    else:
        monkeypatch.delenv("BRDFNERF_FUSED_HEADS", raising=False)
    args = opts.postprocess(opts.train_parser().parse_args(
        ["--root_dir", "r", "--exp_name", "e", "--mapping", "--normal",
         "analystic", "--compute_dtype", dtype]))
    cuda = torch.device("cuda")
    line = kernels_line(opts.to_run_config(args, device=cuda), cuda)
    for w in want:
        assert w in line, (w, line)
    cpu = torch.device("cpu")
    assert "on the CPU" in kernels_line(
        opts.to_run_config(args, device=cpu), cpu)


@pytest.mark.parametrize("extra,match", [
    (["--tp", "2"], "got 0"), (["--tp", "2", "--n_devices", "3"],
                               "got 3")])
def test_train_cli_refuses_what_is_not_ported(tmp_path, extra, match):
    """Tensor parallelism (--tp T) runs on --n_devices N ranks only where
    N is a multiple of T (the JAX package's check and message): --tp
    without --n_devices, or with N that T does not divide, is refused
    before anything is written (tests/test_torch_port_tp.py runs the
    path itself)."""
    argv = ["--root_dir", str(tmp_path), "--exp_name", "e",
            "--logs_dir", str(tmp_path / "logs")] + extra
    with pytest.raises(SystemExit, match=f"multiple of it \\({match}\\)"):
        port_train_main(argv, device="cpu")
    assert not os.path.exists(tmp_path / "logs")


@pytest.mark.parametrize("extra,lines", [
    (["--n_devices", "2"], ["[mesh] 2 data-parallel rank(s), gloo on cpu"]),
    (["--sharded_store", "1"], ["[mesh] sharded_store ignored: needs a mesh"]),
    (["--scale_global_batch", "1"], [])])
def test_train_cli_runs_the_multi_device_flags(tmp_path, capsys, extra,
                                               lines):
    """The flags this test once refused run on the CPU: --n_devices 2
    trains on two gloo ranks; --sharded_store and --scale_global_batch
    without a mesh do nothing, as in the JAX package (the first says it is
    ignored, the second leaves the batch and lr as they are)."""
    aoi = build_aoi(str(tmp_path / "aoi"))
    argv = ["--root_dir", aoi["root"], "--exp_name", "e", "--logs_dir",
            str(tmp_path / "logs"), "--ckpts_dir", str(tmp_path / "ckpts"),
            "--fc_feat", "64", "--fc_layers", "4", "--n_samples", "8",
            "--batch_size", "256", "--max_train_steps", "2",
            "--eval_every_n_epochs", "0"] + extra
    assert port_train_main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert all(ln in out for ln in lines), (lines, out)
    assert "scaled global batch" not in out
    ck = tckpt.latest_checkpoint(os.path.join(str(tmp_path / "ckpts"), "e"))
    assert tckpt.checkpoint_step(ck) == 2


@pytest.mark.parametrize("extra", [["--print_debuginfo"],
                                   ["--data", "blender", "--model", "nerf",
                                    "--img_wh", "24", "24"]])
def test_train_cli_runs_what_it_once_refused(tmp_path, extra):
    """--print_debuginfo (the NaN-guard layer on, as the JAX CLI turns it
    on) and --data blender train and checkpoint (Queue 1 item 7)."""
    from brdfnerf_tpu_torch.utils import guards
    from test_torch_port_blender import make_blender_dir
    if "blender" in extra:
        root = make_blender_dir(str(tmp_path / "data"), n_frames=1)
    else:
        root = build_aoi(str(tmp_path / "aoi"))["root"]
    argv = ["--root_dir", root, "--exp_name", "e", "--logs_dir",
            str(tmp_path / "logs"), "--ckpts_dir", str(tmp_path / "ckpts"),
            "--fc_feat", "64", "--fc_layers", "4", "--n_samples", "8",
            "--batch_size", "256", "--max_train_steps", "2",
            "--eval_every_n_epochs", "0"] + extra
    try:
        assert port_train_main(argv, device="cpu") == 0
        assert guards.enabled() == ("--print_debuginfo" in extra)
    finally:
        guards.enable(False)
    ck = tckpt.latest_checkpoint(os.path.join(str(tmp_path / "ckpts"), "e"))
    assert tckpt.checkpoint_step(ck) == 2
    assert any(f.startswith("val_") and f.endswith(".png")
               for f in os.listdir(tmp_path / "logs" / "e"))


def test_training_entry_points_need_the_card_or_a_device(tmp_path,
                                                         monkeypatch):
    import torch
    from brdfnerf_tpu_torch import train as ttrain
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--root_dir", str(tmp_path), "--exp_name", "e",
            "--logs_dir", str(tmp_path / "logs")]
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train_main(argv)
    assert not os.path.exists(tmp_path / "logs")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.Trainer(None, {}, ttrain.TrainerPaths(
            str(tmp_path / "l"), str(tmp_path / "c")))
    # a mesh is taken now, and a tensor-parallel state layout of that
    # mesh; a layout of another is refused
    from brdfnerf_tpu_torch.parallel import train_step as tts
    with pytest.raises(ValueError, match="layout of the step's mesh"):
        tts.make_fused_train_step(None, None, None, None, None,
                                  mesh=object(), state_shardings=object())
