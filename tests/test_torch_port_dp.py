"""The port's data parallelism on the CPU (tests/test_sharding.py's cases,
against the one-device step and the JAX package's mesh step).

The port trains one process a rank under torch.distributed; here two gloo
ranks on the CPU, spawned through parallel/mesh.run_ranks with a FileStore
rendezvous (tools/dp_check.on_ranks: the ranks import only the port).  The
JAX side runs in this process on its 8-device CPU mesh (tests/conftest.py).

Bounds: a data-parallel step against the one-device step on the global
batch is tests/test_sharding.py's (loss within 1e-5; gradients within
atol 5e-6 + rtol 5e-5 of each gradient's largest magnitude): the ranks'
shares sum to the global loss in another order.  Against the JAX package's
mesh step, three steps each from the JAX state are held as
torch_port_common.three_fused_steps_match holds the one-device steps
(metrics to rtol 5e-4; parameters to 5e-4 of scale and of themselves but
for at most 0.1% of a tensor's elements, within 2 * lr).  The sharded
store against the replicated one replaying its draws, and the mesh's
validation against the single device's, are bit for bit: each rank
gathers the same rows and renders them alone.
"""

import dataclasses as dc
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu.data import batcher as jbatch
from brdfnerf_tpu.parallel import train_step as jts
from brdfnerf_tpu.parallel.mesh import make_mesh
from brdfnerf_tpu.utils.checkpoint import _flatten as jflatten

from brdfnerf_tpu_torch import config as tconfig
from brdfnerf_tpu_torch.data import batcher as tbatch
from brdfnerf_tpu_torch.parallel import train_step as tts
from brdfnerf_tpu_torch.tools import dp_check
from brdfnerf_tpu_torch.utils.checkpoint import params_to_flat

from torch_port_common import (FLAGSHIP_HEADS, SMALL, make_store,
                               model_configs, render_configs, render_draws)

SCHED = dict(t_cos_irra=1e18, t_ds_drop=1e18, t_nrrg=-1.0,
             steps_per_epoch=1, first_beta_epoch=0)


def _store(n, seed=0):
    """make_store with per-ray near planes (ray 0's near moves the guided
    band, so a rank that read its own first ray would differ)."""
    s = make_store(n, seed=seed)
    s["rays"][:, 6] = np.random.RandomState(seed + 9).uniform(
        0.0, 0.3, n).astype(np.float32)
    return s


def _payload(mcfg, rcfg, tcfg, store, idx, seed=0, **kw):
    state, _ = tts.create_train_state(mcfg, tcfg, 3, seed=seed,
                                      device="cpu",
                                      n_importance=rcfg.n_importance)
    return dict(mcfg=mcfg, rcfg=rcfg, tcfg=tcfg, sched=SCHED,
                flat=params_to_flat(state.params), store=store, idx=idx,
                seed=seed + 1, **kw)


def _configs(variant="spsbrdf-nerf", **tkw):
    heads = (dict(FLAGSHIP_HEADS) if variant == "spsbrdf-nerf"
             else dict(sun_v="learned", beta=True))
    model = dict(SMALL, variant=variant, **heads)
    model.update(tkw.pop("model", {}))
    _, tm = model_configs(**model, compute_dtype="float32")
    _, tr = render_configs(n_samples=8, guided_samples=8, apply_brdf=True,
                           use_pallas=True, fused_trunk=True)
    tt = tconfig.TrainConfig(**dict(dict(
        lr=5e-4, batch_size=64, ds_lambda=10.0, nr_reg_an_lambda=0.1,
        hs_lambda=0.5), **tkw))
    return tm, tr, tt


def test_dp_step_equals_the_one_device_step():
    """One fused step over two gloo ranks against the same step on one
    device on the global batch (test_sharding.py:73-104), for the flagship
    losses with the valid-count normal supervision (nr_spv_type 3), for
    the 'an_lr' product of two means with the learned normals' terms
    (nr_spv_type 1), and for sat-nerf's beta loss (its constant share):
    the losses whose global counts and factors the ranks all-reduce.
    Rank 1's block has no valid depth, so its own kept-ray test fails
    where the global batch's passes."""
    store = _store(256, seed=3)
    idx = np.random.RandomState(4).permutation(256)[:64].astype(np.int32)
    store["valid_depth"][idx[32:]] = 0
    store["valid_depth"][idx[:32:2]] = 1
    payloads = [
        _payload(*_configs(nr_spv_lambda=0.05, nr_spv_type=3), store,
                 [idx]),
        _payload(*_configs(nr_spv_lambda=0.05, nr_spv_type=1,
                           nr_reg_lr_lambda=0.1,
                           model=dict(normal="analystic_learned")),
                 store, [idx]),
        _payload(*_configs("sat-nerf", sc_lambda=0.05), store, [idx]),
    ]
    many = dp_check.on_ranks(payloads, 2, "cpu")
    for p, dp in zip(payloads, many):
        one = dp_check.run_steps(None, p, device="cpu")
        c = dp_check.compare(one, dp)
        assert c["held"], (p["mcfg"].variant, c["loss"], c["worst"])
        for k, v in one["metrics"][0].items():
            np.testing.assert_allclose(dp["metrics"][0][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_one_rank_mesh_step_is_the_one_device_step():
    """A mesh of one rank (the world size that --n_devices 1 runs) gives
    the one-device step bit for bit: its draws come from
    render.batch_draws of the step's generator, which are the generator's
    own draws, and every reduction is of one rank."""
    store = _store(128, seed=5)
    idx = np.random.RandomState(6).permutation(128)[:64].astype(np.int32)
    p = _payload(*_configs(), store, [idx, idx[::-1].copy()])
    one = dp_check.run_steps(None, p, device="cpu")
    (mesh1,) = [dp_check.on_ranks([p], 1, "cpu")[0]]
    assert one["loss"] == mesh1["loss"]
    assert one["metrics"] == mesh1["metrics"]
    for k in one["grads"]:
        assert np.array_equal(one["grads"][k], mesh1["grads"][k]), k
    for k in one["params"]:
        assert np.array_equal(one["params"][k], mesh1["params"][k]), k


def _jax_start(jstate):
    adam = jstate.opt_state[0]
    return {"p": {k: np.array(v) for k, v in jflatten(jstate.params).items()},
            "mu": {k: np.array(v) for k, v in jflatten(adam.mu).items()},
            "nu": {k: np.array(v) for k, v in jflatten(adam.nu).items()},
            "count": int(adam.count)}


def test_three_dp_steps_match_the_jax_mesh_step():
    """Three fused steps over two gloo ranks against the JAX package's
    fused step on its 8-device mesh, each from the JAX state and on the
    draws of the JAX step's key for the global batch (render_draws), with
    the valid-count normal supervision on and one rank's block without
    valid depth (the global-count hazard).  The parameters are held to
    three_fused_steps_match's rule, with the share of a tensor's elements
    that may differ by up to 2 * lr raised by what the one-device step on
    the same inputs shows against the JAX step (the first siren layer's
    near-zero gradients take their sign from the summation order)."""
    n = 24
    kw = dict(SMALL, **FLAGSHIP_HEADS, compute_dtype="float32")
    jm, tm = model_configs(**kw)
    jr, tr = render_configs(n_samples=8, guided_samples=8, apply_brdf=True,
                            use_pallas=True, fused_trunk=True, perturb=0.0)
    tkw = dict(lr=5e-4, batch_size=n, ds_lambda=10.0, nr_reg_an_lambda=0.1,
               hs_lambda=0.5, nr_spv_lambda=0.05, nr_spv_type=3)
    from brdfnerf_tpu import config as jconfig
    jt, tt = jconfig.TrainConfig(**tkw), tconfig.TrainConfig(**tkw)
    store = _store(64, seed=11)
    rng = np.random.RandomState(12)
    idxs = [rng.permutation(64)[:n].astype(np.int32) for _ in range(3)]
    for idx in idxs:
        store["valid_depth"][idx[n // 2:]] = 0
    mesh = make_mesh(8)
    jstate, jopt = jts.create_train_state(jax.random.PRNGKey(0), jm, jt,
                                          steps_per_epoch=3)
    jstep = jts.make_fused_train_step(jm, jr, jt, jopt,
                                      jts.GateSchedule(**SCHED), mesh=mesh)
    base_key = jax.random.PRNGKey(1)
    starts, jmetrics, jparams, draws = [], [], [], []
    flat0 = {k: np.array(v) for k, v in jflatten(jstate.params).items()}
    for i, idx in enumerate(idxs):
        starts.append(_jax_start(jstate))
        d = render_draws(jax.random.fold_in(base_key, i), jr, n,
                         jr.sun_march_count(16))
        draws.append({k: v.numpy() for k, v in d.items()})
        jstate, m = jstep(jstate, store, idx, base_key)
        jmetrics.append({k: float(v) for k, v in m.items()})
        jparams.append({k: np.array(v)
                        for k, v in jflatten(jstate.params).items()})
    p = dict(mcfg=tm, rcfg=tr, tcfg=tt, sched=SCHED, flat=flat0,
             store=store, idx=idxs, draws=draws, states=starts, record=True)
    (got,) = dp_check.on_ranks([p], 2, "cpu")
    one = dp_check.run_steps(None, p, device="cpu")

    def flips(params, ref, scale):
        d = np.abs(params - ref)
        return d, d > 5e-4 * scale + 5e-4 * np.abs(ref)

    for i in range(3):
        for k in ("loss", "psnr", "perc_bad_nr", "depth_std_mean"):
            np.testing.assert_allclose(got["metrics"][i][k], jmetrics[i][k],
                                       rtol=5e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        for key, ref in jparams[i].items():
            scale = max(float(np.abs(ref).max()), 1e-3)
            d, flipped = flips(got["params_each"][i][key], ref, scale)
            _, own = flips(one["params_each"][i][key], ref, scale)
            # measured: the one-device step itself flips 15 of fc_net.0.w's
            # 3,840 elements at step 1 on this batch (0.39%)
            assert flipped.mean() <= own.mean() + 1e-3, (
                i, key, flipped.sum(), own.sum())
            assert d.max() <= 2 * tt.lr, (i, key, d.max())


class _Shards:
    """A mesh stand-in that ShardedRayBatcher reads for its shard count
    alone (place=False)."""

    def __init__(self, n):
        self.shape = {"data": n}
        self.size = n


def test_sharded_batcher_equals_jax_and_keeps_its_epoch():
    """ShardedRayBatcher: the same per-shard index sequence as the JAX
    package's for one seed (wrap padding, shard size, local batch,
    global_indices, padded_arrays); without replacement within a local
    epoch; and every ValueError of the JAX package's."""
    store = {"rays": np.arange(509 * 2, dtype=np.float32).reshape(509, 2)}
    jb = jbatch.ShardedRayBatcher(store, 128, _Shards(8), seed=3,
                                  place=False)
    tb = tbatch.ShardedRayBatcher(store, 128, _Shards(8), seed=3,
                                  place=False)
    assert (tb.shard_size, tb.local_batch, tb.steps_per_epoch) == (
        jb.shard_size, jb.local_batch, jb.steps_per_epoch) == (64, 16, 4)
    for _ in range(9):
        loc = tb.next_indices()
        assert np.array_equal(loc, jb.next_indices())
        assert np.array_equal(tb.global_indices(loc), jb.global_indices(loc))
    pj, pt = jb.padded_arrays(store), tb.padded_arrays(store)
    assert np.array_equal(pt["rays"], pj["rays"]) and len(pt["rays"]) == 512
    sb = tbatch.ShardedRayBatcher(
        {"rays": np.arange(512, dtype=np.float32)}, 64, _Shards(8),
        place=False)
    seen = [[] for _ in range(8)]
    for _ in range(sb.steps_per_epoch):
        for d, blk in enumerate(sb.next_indices().reshape(8, 8)):
            seen[d].extend(blk.tolist())
    assert all(sorted(s) == list(range(64)) for s in seen)
    for bad in (dict(batch_size=100), dict(n=5), dict(batch_size=1024)):
        n = bad.get("n", 509)
        arrays = {"rays": np.zeros((n, 2), np.float32)}
        for mod in (jbatch, tbatch):
            with pytest.raises(ValueError):
                mod.ShardedRayBatcher(arrays, bad.get("batch_size", 64),
                                      _Shards(8), place=False)


def test_sharded_store_equals_the_replicated_store():
    """Four fused steps on the store sharded over two ranks (each rank's
    shard on its device, per-shard local draws) against the replicated
    store replaying the same draws through global_indices, bit for bit
    (test_sharding.py:299); the store's 509 rays pad to 510."""
    store = _store(509, seed=7)
    tb = tbatch.ShardedRayBatcher(store, 64, _Shards(2), seed=3,
                                  place=False)
    locs = [tb.next_indices() for _ in range(4)]
    tm, tr, tt = _configs()
    base = _payload(tm, tr, tt, store, locs)
    sharded = dict(base, sharded=True)
    replicated = dict(base, store=tb.padded_arrays(store),
                      idx=[tb.global_indices(loc).astype(np.int32)
                           for loc in locs])
    got_sh, got_re = dp_check.on_ranks([sharded, replicated], 2, "cpu")
    assert got_sh["loss"] == got_re["loss"]
    for k in got_re["params"]:
        assert np.array_equal(got_sh["params"][k], got_re["params"][k]), k


def _aoi_argv(tmp_path, info, extra=()):
    return ["--root_dir", info["root"], "--gt_dir", info["gt_dir"],
            "--aoi_id", info["aoi_id"], "--logs_dir", str(tmp_path / "logs"),
            "--ckpts_dir", str(tmp_path / "ckpts"), "--model",
            "spsbrdf-nerf", "--mapping", "--fc_feat", "64", "--fc_layers",
            "4", "--n_samples", "8", "--guided_samples", "8",
            "--batch_size", "128", "--ds_lambda", "10", "--lr", "1e-3",
            "--normal", "analystic", "--sun_v", "analystic", "--funcM", "1",
            "--funcF", "1", "--funcH", "1", "--brdf_on", "0",
            "--eval_every_n_epochs", "0", "--max_train_steps", "12",
            "--exp_name", "run", *extra]


@pytest.mark.parametrize("extra", [[], ["--sharded_store", "1",
                                        "--scale_global_batch", "1",
                                        "--scan_chunk", "4"]])
def test_train_cli_on_two_ranks(tmp_path, capfd, extra):
    """The train CLI with --n_devices 2 runs two gloo ranks on the CPU
    (test_sharding.py:273, :384): the loss falls, rank 0 alone writes the
    log and the checkpoint, --scale_global_batch doubles the batch and the
    learning rate (with no warm-up), the sharded store runs the
    scan-chunked loop too, and rank 0's final validation equals the
    single device's validation of the saved weights bit for bit
    (test_sharding.py:461)."""
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.cli.train import main as port_train_main
    from brdfnerf_tpu_torch.data.satellite import SatelliteDataset
    from brdfnerf_tpu_torch.data.synth_aoi import build_aoi
    from brdfnerf_tpu_torch.train import Trainer, TrainerPaths
    from brdfnerf_tpu_torch.utils import checkpoint as tckpt
    info = build_aoi(str(tmp_path / "aoi"))
    argv = _aoi_argv(tmp_path, info, ["--n_devices", "2", *extra])
    assert port_train_main(argv, device="cpu") == 0
    # both ranks' standard output (rank 1's is the spawned process's)
    out = capfd.readouterr().out
    assert out.count("[val] epoch") == 1 and out.count("[kernels]") == 1
    assert "[mesh] 2 data-parallel rank(s), gloo on cpu" in out
    scaled = "--scale_global_batch" in extra
    assert ("[mesh] scaled global batch: 256 rays/step (2 devices), "
            "lr -> 2.000e-03\n" in out) == scaled
    run_dir = str(tmp_path / "logs" / "run")
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    losses = [r["train/loss"] for r in recs if "train/loss" in r]
    # one writer: each logged step once
    steps = [r["step"] for r in recs if "train/loss" in r]
    assert steps == sorted(set(steps)) and len(steps) >= 2
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    ck = tckpt.latest_checkpoint(str(tmp_path / "ckpts" / "run"))
    assert tckpt.checkpoint_step(ck) == 12
    last = val_epoch(ck)
    assert sorted(os.listdir(tmp_path / "ckpts" / "run")) == sorted(
        f"epoch={e}{x}" for e in range(last + 1)
        for x in (".npz", ".opt.npz"))
    val = [r for r in recs if any(k.startswith("val/") for k in r)][-1]
    # the single device's validation of the saved weights
    args = opts.postprocess(opts.train_parser().parse_args(_aoi_argv(
        tmp_path / "one", info)))
    cfg = opts.to_run_config(args, device="cpu")
    sat = dc.replace(opts.sat_config_from_opts(args),
                     mod_alt_bound=bool(args.mod_alt_bound))
    tr = Trainer(cfg, SatelliteDataset(sat, "train").store,
                 TrainerPaths(str(tmp_path / "one_l"),
                              str(tmp_path / "one_c"),
                              gt_dir=info["gt_dir"], aoi_id=info["aoi_id"]),
                 val_dataset=SatelliteDataset(sat, "val"), device="cpu")
    tr.eval_chunk = args.chunk
    tckpt.restore_params(tr.state.params, ck)
    one = tr.validate(epoch=last)
    for k, v in one.items():
        assert val[k] == v, (k, val[k], v)


def val_epoch(ck):
    """The epoch of checkpoint ck (epoch={n}.npz)."""
    return int(os.path.basename(ck).split("=")[1].split(".")[0])


def test_load_renderer_on_two_devices(tmp_path):
    """serve.load_renderer(n_devices=2): two replicas (on the CPU, both on
    it), each chunk's rays and draws split between them and rendered at
    the same time, against the single-device renderer (the JAX package's
    atol / rtol 1e-5, test_sharding.py:106)."""
    from brdfnerf_tpu_torch import serve as tserve
    from test_torch_port_serve import _write_jax_run
    from torch_port_common import make_rays
    run_dir, *_ = _write_jax_run(tmp_path)
    rays = _store(200, seed=8)["rays"]
    one = tserve.load_renderer(run_dir, 1, device="cpu")
    two = tserve.load_renderer(run_dir, 1, n_devices=2, device="cpu")
    assert one.replicas is None and len(two.replicas) == 2
    a, b = one.render_image({"rays": rays}), two.render_image({"rays": rays})
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    # a chunk that does not split over the replicas is refused
    with pytest.raises(ValueError, match="split"):
        dc.replace(two, chunk=95).render_image({"rays": make_rays(10)})


def test_more_devices_than_visible_are_refused(tmp_path, monkeypatch):
    """--n_devices above the visible CUDA devices is refused before the
    dataset is read (the JAX package checks only divisibility), with --tp
    too, and so is load_renderer's n_devices (serve.py:127-131); a
    tensor-parallel layout is refused by a step without its mesh."""
    from brdfnerf_tpu_torch import serve as tserve
    from brdfnerf_tpu_torch.cli.train import main as port_train_main
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = ["--root_dir", str(tmp_path / "missing"), "--exp_name", "e",
            "--logs_dir", str(tmp_path / "logs"), "--n_devices", "2"]
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        port_train_main(argv, device="cuda")
    assert not os.path.exists(tmp_path / "logs")
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        tserve.load_renderer(str(tmp_path / "run"), 1, n_devices=2,
                             device="cuda")
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        port_train_main(argv + ["--tp", "2"], device="cuda")
    assert not os.path.exists(tmp_path / "logs")
    with pytest.raises(ValueError, match="layout of the step's mesh"):
        tts.make_fused_train_step(None, None, None, None, None,
                                  state_shardings=object())


_FAILING_RANK = '''
import sys
import torch
from brdfnerf_tpu_torch.parallel import mesh as M


def late(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails in its loss")
    return float(mesh.sum(torch.ones(1)))


def never(mesh):
    return float(mesh.sum(torch.ones(1)))


if __name__ == "__main__":
    M.GRACE = 2.0
    if sys.argv[1] == "late":
        try:
            M.run_ranks(late, 2, sys.argv[2], "cpu")
        except RuntimeError as e:
            print("raised:", "".join(getattr(e, "__notes__", [])))
    else:
        # rank 1 cannot join (no CUDA here), so rank 0 waits in the
        # rendezvous until the watch ends the process
        M.run_ranks(never, 2, sys.argv[2], "cpu", devices=["cpu", "cuda:1"])
'''


@pytest.mark.parametrize("case", ["late", "early"])
def test_a_failed_rank_stops_rank_0_with_its_error(tmp_path, case):
    """A rank that fails stops rank 0 within seconds, with the failed
    rank's traceback, and not at the collectives' 60-minute timeout:
    raised as a note to rank 0's error where a gloo collective breaks
    off ('late'), printed as the process ends GRACE seconds on where
    rank 0 stays blocked in the rendezvous ('early')."""
    import subprocess
    import sys
    import time
    script = tmp_path / "ranks.py"
    script.write_text(_FAILING_RANK)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(script), case,
                           str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=120)
    seconds = time.perf_counter() - t0
    if case == "late":
        assert proc.returncode == 0, proc.stderr
        assert "raised: rank 1 failed" in proc.stdout, proc.stdout
        assert "rank 1 fails in its loss" in proc.stdout, proc.stdout
    else:
        assert proc.returncode == 1, proc.stderr
        assert "still blocked 2 s after rank 1 failed" in proc.stderr
        assert "cuda" in proc.stderr.lower()
    assert seconds < 60, seconds
