"""The port's tensor parallelism on the CPU (tests/test_tensor_parallel.py's
cases, against the one-device port and the JAX package's TP step).

The port runs one process a rank; a (data, model) mesh here is gloo ranks
on the CPU spawned through parallel/mesh.run_ranks (tools/tp_check.on_mesh:
the ranks import only the port).  The JAX side runs in this process on its
8-device CPU mesh (tests/conftest.py), tp_mesh(2, 4).  Each mesh the tests
need is spawned once (the module's fixtures), for every case it serves.

Bounds: a TP step against the JAX package's TP step is held as
tests/test_torch_port_dp.py holds the DP step against the JAX mesh step
(three steps each from the JAX state: metrics to rtol 5e-4, the
parameters to torch_port_common.three_fused_steps_match's rule, the share
of flipped elements raised by what the one-device step shows); the
normals under TP against one device to 1e-5, their loss's gradients to
2e-5 of the largest gradient of the tensor, or of 1e-3 of the largest of
all where that is more (the model group's sums in another order); the TP train CLI against the DP one as
test_trainer_tp_matches_dp holds the JAX Trainers (losses and PSNR to
rtol 5e-4; the render's mean |d rgb| below 2e-3).
"""

import dataclasses as dc
import json
import os

import numpy as np
import pytest
import torch

import jax

from brdfnerf_tpu import config as jconfig
from brdfnerf_tpu.parallel import tensor as jtensor
from brdfnerf_tpu.parallel import train_step as jts
from brdfnerf_tpu.utils.checkpoint import _flatten as jflatten

from brdfnerf_tpu_torch import config as tconfig
from brdfnerf_tpu_torch.parallel import tensor as ttensor
from brdfnerf_tpu_torch.parallel import train_step as tts
from brdfnerf_tpu_torch.tools import dp_check, tp_check
from brdfnerf_tpu_torch.utils.checkpoint import named_flat, params_to_flat

from torch_port_common import (FLAGSHIP_HEADS, SMALL, model_configs,
                               render_configs, render_draws)
from test_torch_port_dp import SCHED, _jax_start, _store

# (layers, skips): the reference's shape with one skip inside; a skip at
# an odd index and an odd layer count (the all-gathers: a column layer
# after a column layer, and a column layer ending the trunk); the 12-layer
# trunk tensor parallelism exists for, at a narrow width
TRUNKS = [(4, (2,)), (5, (3,)), (12, (4,))]
N_RAYS = 24


class _Axis:
    """A mesh stand-in with the model axis alone (cutting needs no
    process group)."""

    def __init__(self, n_model, m):
        self.n_model, self.model_rank = n_model, m
        self.shape = {"data": 2, "model": n_model}
        self.size = 2 * n_model


def _trunk(layers, skips):
    return dict(SMALL, layers=layers, skips=skips)


# ------------------------------------------------------------ the layout

@pytest.mark.parametrize("layers,skips", TRUNKS)
def test_layout_rule_and_blocks_match_the_jax_package(layers, skips):
    """trunk_spec against the JAX package's for every trunk leaf; on
    tp_mesh(2, 4) each JAX addressable shard of the state is the port's
    shard_flat block of the npz layout and, transposed, the port's own
    block of the parameter; Adam's moments are cut by the same rule
    (shard_state), the heads and the t table whole."""
    from jax.tree_util import DictKey, SequenceKey
    jm, tm = model_configs(**_trunk(layers, skips), **FLAGSHIP_HEADS)
    jt = jconfig.TrainConfig(lr=5e-4, batch_size=32)
    for i in range(layers):
        for kind in ("w", "b"):
            path = (DictKey("coarse"), DictKey("fc_net"), SequenceKey(i),
                    DictKey(kind))
            want = {jax.sharding.PartitionSpec(None, "model"): "column",
                    jax.sharding.PartitionSpec("model"): "column",
                    jax.sharding.PartitionSpec("model", None): "row",
                    jax.sharding.PartitionSpec(): "replicated"}[
                        jtensor.trunk_spec(path, skips)]
            assert ttensor.trunk_spec(i, kind, skips) == want, (i, kind)
            assert ttensor.spec_of(f"fine/fc_net/{i}/{kind}", skips) == want
    assert ttensor.spec_of("coarse/sigma_from_xyz/0/w", skips) == "replicated"

    jstate, _ = jts.create_train_state(jax.random.PRNGKey(0), jm, jt, 3)
    mesh = jtensor.tp_mesh(2, 4)
    sharded = {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
        leaf for path, leaf in jax.tree_util.tree_leaves_with_path(
            jtensor.shard_state(mesh, jstate.params, skips))}
    flat = {k: np.array(v) for k, v in jflatten(jstate.params).items()}
    blocks = [ttensor.shard_flat(flat, 4, m, skips) for m in range(4)]
    state, opt = tts.create_train_state(tm, tconfig.TrainConfig(lr=5e-4),
                                        3, flat=flat, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for p in named_flat(state.params).values():
        state.opt_state.state[p] = {
            "step": torch.tensor(3.0),
            "exp_avg": torch.randn(p.shape, generator=gen),
            "exp_avg_sq": torch.rand(p.shape, generator=gen)}
    whole = {k: {name: v.clone() for name, v in
                 state.opt_state.state[p].items()}
             for k, p in named_flat(state.params).items()}
    for key, arr in sharded.items():
        shards = sorted(arr.addressable_shards,
                        key=lambda s: tuple(i.start or 0 for i in s.index))
        unique = {tuple(i.start or 0 for i in s.index): np.asarray(s.data)
                  for s in shards}
        got = [b[key] for b in blocks]
        if ttensor.spec_of(key, skips) == "replicated":
            assert len(unique) == 1 and np.array_equal(got[0], flat[key])
            continue
        assert len(unique) == 4, key
        for m, (_, ref) in enumerate(sorted(unique.items())):
            assert got[m].shape == ref.shape and np.array_equal(
                got[m], ref), (key, m)
    for m in range(4):
        st, o = tts.create_train_state(tm, tconfig.TrainConfig(lr=5e-4), 3,
                                       flat=flat, device="cpu")
        for k, p in named_flat(st.params).items():
            st.opt_state.state[p] = {n: v.clone()
                                     for n, v in whole[k].items()}
        layout = ttensor.Layout(_Axis(4, m), tuple(skips))
        st = ttensor.shard_state(st, o, layout)
        assert st.params.coarse.tp is layout
        for k, p in named_flat(st.params).items():
            ref = blocks[m][k]
            got = p.detach().numpy()
            assert np.array_equal(got.T if k.endswith("/w") else got,
                                  ref), (k, m)
            mom = st.opt_state.state[p]
            for name in ("exp_avg", "exp_avg_sq"):
                assert mom[name].shape == p.shape, (k, name)
                assert torch.equal(mom[name], ttensor.cut(
                    k, whole[k][name], 4, m, skips)), (k, name)
            assert float(mom["step"]) == 3.0
    assert ttensor.model_axis_size(_Axis(4, 0)) == 4
    assert ttensor.data_axis_size(_Axis(4, 0)) == 2
    assert ttensor.model_axis_size(None) == 1


# ------------------------------------------------- the mesh runs, once

def _configs(layers, skips):
    kw = dict(_trunk(layers, skips), **FLAGSHIP_HEADS,
              compute_dtype="float32")
    jm, tm = model_configs(**kw)
    jr, tr = render_configs(n_samples=8, guided_samples=8, apply_brdf=True,
                            use_pallas=False, fused_trunk=False,
                            perturb=0.0)
    tkw = dict(lr=5e-4, batch_size=N_RAYS, ds_lambda=10.0,
               nr_reg_an_lambda=0.1, hs_lambda=0.5, nr_spv_lambda=0.05,
               nr_spv_type=3)
    return jm, tm, jr, tr, jconfig.TrainConfig(**tkw), tconfig.TrainConfig(
        **tkw)


def _jax_tp_steps(layers, skips):
    """Three steps of the JAX package's fused step on tp_mesh(2, 4), and
    the port's payload holding its start states and draws."""
    jm, tm, jr, tr, jt, tt = _configs(layers, skips)
    store = _store(64, seed=11)
    rng = np.random.RandomState(12)
    idxs = [rng.permutation(64)[:N_RAYS].astype(np.int32)
            for _ in range(3)]
    for idx in idxs:
        store["valid_depth"][idx[N_RAYS // 2:]] = 0
    mesh = jtensor.tp_mesh(2, 4)
    jstate, jopt = jts.create_train_state(jax.random.PRNGKey(0), jm, jt,
                                          steps_per_epoch=3)
    shs = jtensor.state_shardings(mesh, jstate, skips=skips)
    jstate = jtensor.shard_state(mesh, jstate, skips=skips)
    jstep = jts.make_fused_train_step(jm, jr, jt, jopt,
                                      jts.GateSchedule(**SCHED), mesh=mesh,
                                      state_shardings=shs)
    base_key = jax.random.PRNGKey(1)
    flat0 = {k: np.array(v) for k, v in jflatten(jstate.params).items()}
    starts, jmetrics, jparams, draws = [], [], [], []
    for i, idx in enumerate(idxs):
        starts.append(_jax_start(jstate))
        d = render_draws(jax.random.fold_in(base_key, i), jr, N_RAYS,
                         jr.sun_march_count(16))
        draws.append({k: v.numpy() for k, v in d.items()})
        jstate, m = jstep(jstate, store, idx, base_key)
        jmetrics.append({k: float(v) for k, v in m.items()})
        jparams.append({k: np.array(v)
                        for k, v in jflatten(jstate.params).items()})
    payload = dict(mcfg=tm, rcfg=tr, tcfg=tt, sched=SCHED, flat=flat0,
                   store=store, idx=idxs, draws=draws, states=starts,
                   record=True)
    return payload, jmetrics, jparams


def _normals_payload(layers, skips):
    from brdfnerf_tpu_torch.models.network import init_params
    _, tm, *_ = _configs(layers, skips)
    flat = params_to_flat(init_params(
        tm, torch.Generator().manual_seed(layers), device="cpu"))
    rng = np.random.RandomState(layers)
    return dict(mcfg=tm, flat=flat,
                xyz=rng.uniform(-1, 1, (40, 3)).astype(np.float32),
                cot=rng.normal(size=(40, 3)).astype(np.float32))


STEP_TRUNKS = TRUNKS[:2]


@pytest.fixture(scope="module")
def jax_steps():
    return {t: _jax_tp_steps(*t) for t in STEP_TRUNKS}


@pytest.fixture(scope="module")
def normal_payloads():
    return {t: _normals_payload(*t) for t in TRUNKS}


def _render_payload():
    from brdfnerf_tpu_torch.models.network import init_params
    from torch_port_common import make_rays
    _, tm = model_configs(**SMALL, **FLAGSHIP_HEADS)
    _, tr = render_configs(n_samples=8, guided_samples=8, apply_brdf=True,
                           use_pallas=True, fused_trunk=True)
    flat = params_to_flat(init_params(tm, torch.Generator().manual_seed(2),
                                      device="cpu"))
    return dict(mcfg=tm, rcfg=tr, flat=flat, rays=make_rays(64, seed=9))


def _store_payloads():
    """Two steps on a store sharded over the data axis of 2 (each rank
    of a model group holding its data rank's shard), and the replicated
    store replaying the same draws through global_indices."""
    from brdfnerf_tpu_torch.data import batcher as tbatch
    from test_torch_port_dp import _Shards
    store = _store(509, seed=7)
    tb = tbatch.ShardedRayBatcher(store, 64, _Shards(2), seed=3,
                                  place=False)
    locs = [tb.next_indices() for _ in range(2)]
    _, tm, _, tr, _, tt = _configs(*TRUNKS[0])
    tt = dc.replace(tt, batch_size=64)
    state, _ = tts.create_train_state(tm, tt, 3, seed=0, device="cpu")
    base = dict(mcfg=tm, rcfg=tr, tcfg=tt, sched=SCHED,
                flat=params_to_flat(state.params), store=store, idx=locs,
                seed=1)
    return [dict(base, sharded=True),
            dict(base, store=tb.padded_arrays(store),
                 idx=[tb.global_indices(loc).astype(np.int32)
                      for loc in locs])]


@pytest.fixture(scope="module")
def mesh_runs(jax_steps, normal_payloads):
    """{(n_data, n_model): rank 0's results}: on (2, 2) the three steps of
    each STEP_TRUNKS case, the normals of each TRUNKS case, a render and
    the sharded and replicated stores' steps, on (1, 2) the steps; one
    spawn a mesh."""
    runs = {}
    for shape, normals in (((2, 2), True), ((1, 2), False)):
        jobs = [("steps", jax_steps[t][0]) for t in STEP_TRUNKS]
        if normals:
            jobs += [("normals", normal_payloads[t]) for t in TRUNKS]
            jobs.append(("render", _render_payload()))
            jobs += [("steps", p) for p in _store_payloads()]
        runs[shape] = tp_check.on_mesh(jobs, *shape, "cpu")["results"]
    return runs


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
@pytest.mark.parametrize("trunk", STEP_TRUNKS)
def test_tp_steps_match_the_jax_tp_step(jax_steps, mesh_runs, shape, trunk):
    """Three fused steps on a (data, model) mesh of gloo ranks against the
    JAX package's fused step on tp_mesh(2, 4) with its state_shardings,
    each from the JAX state and on the draws of the JAX step's key for the
    global batch, with the valid-count normal supervision and one data
    block without valid depth.  Every rank holds its 1/2 of each trunk
    weight and of its Adam moments (a row layer's bias whole), and its
    trunk bytes are its share."""
    payload, jmetrics, jparams = jax_steps[trunk]
    got = mesh_runs[shape][STEP_TRUNKS.index(trunk)]
    one = dp_check.run_steps(None, payload, device="cpu")
    lr = payload["tcfg"].lr

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
            assert flipped.mean() <= own.mean() + 1e-3, (
                i, key, flipped.sum(), own.sum())
            assert d.max() <= 2 * lr, (i, key, d.max())
    layers, skips = trunk
    for name, (pshape, moments) in got["shapes"].items():
        key = name.replace(".", "/")
        axis = ttensor.cut_axis(key, skips)
        whole = one["shapes"][name][0]
        want = list(whole)
        if axis is not None:
            want[axis] //= 2
        assert pshape == tuple(want), (name, pshape, whole)
        assert moments == (pshape, pshape), (name, moments)
    assert got["trunk_bytes"] == tp_check.share_bytes(
        one["params"], 2, skips) < one["trunk_bytes"]


@pytest.mark.parametrize("trunk", TRUNKS)
def test_normals_and_their_gradient_under_tp(normal_payloads, mesh_runs,
                                             trunk):
    """The analytic normals (grad_x sigma through the trunk's blocks, each
    rank's part summed by copy's backward) and the gradient of a loss of
    them (the double backward through copy, reduce, gather and scatter)
    on the (2, 2) mesh against one device.  Without copy's all-reduce each
    rank's grad_x would be its block's part alone."""
    p = normal_payloads[trunk]
    got = mesh_runs[(2, 2)][len(STEP_TRUNKS) + TRUNKS.index(trunk)]
    one = tp_check.normals(None, p, device="cpu")
    np.testing.assert_allclose(got["normals"], one["normals"], atol=1e-5)
    assert set(got["grads"]) == set(one["grads"])
    # sigma's bias moves no normal: its gradient is rounding, held to the
    # floor of 1e-3 of the largest gradient
    top = max(float(np.abs(g).max()) for g in one["grads"].values())
    for k, ref in one["grads"].items():
        scale = max(float(np.abs(ref).max()), 1e-3 * top)
        np.testing.assert_allclose(got["grads"][k], ref, rtol=0,
                                   atol=2e-5 * scale, err_msg=k)


def test_tp_render_matches_one_device(mesh_runs):
    """make_render_step(mesh=) on the (2, 2) mesh (the JAX package's
    make_render_step(mesh=tp_mesh(...))): every rank of a model group
    renders the same rays with its blocks, K1-K5 off though the render
    config asks for them, against the one-device render of the whole
    weights (test_tp_render_matches_single_device: rtol 1e-4, atol
    1e-5)."""
    p = _render_payload()
    got = mesh_runs[(2, 2)][len(STEP_TRUNKS) + len(TRUNKS)]
    one = tp_check.render(None, dict(p, rcfg=ttensor.kernels_off(p["rcfg"])),
                          device="cpu")
    assert set(got) == set(one)
    for k in ("rgb_coarse", "depth_coarse", "weights_coarse"):
        np.testing.assert_allclose(got[k], one[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_tp_sharded_store_equals_the_replicated_store(mesh_runs):
    """Two steps on the (2, 2) mesh with the store sharded over its data
    axis (--sharded_store: the ranks of a model group hold one shard and
    draw the same local indices) against the replicated store replaying
    the same draws through global_indices, bit for bit
    (test_tp_fused_and_scan_loop_with_sharded_store's replay)."""
    sharded, replicated = mesh_runs[(2, 2)][-2:]
    assert sharded["loss"] == replicated["loss"]
    for k in replicated["params"]:
        assert np.array_equal(sharded["params"][k],
                              replicated["params"][k]), k


# --------------------------------------------------- the train CLI runs

def _aoi_argv(tmp_path, info, exp, extra=()):
    return ["--root_dir", info["root"], "--gt_dir", info["gt_dir"],
            "--aoi_id", info["aoi_id"], "--logs_dir", str(tmp_path / "logs"),
            "--ckpts_dir", str(tmp_path / "ckpts"), "--model",
            "spsbrdf-nerf", "--mapping", "--fc_feat", "64", "--fc_layers",
            "4", "--n_samples", "8", "--guided_samples", "8",
            "--batch_size", "256", "--ds_lambda", "10", "--lr", "1e-3",
            "--normal", "analystic", "--sun_v", "analystic", "--funcM", "1",
            "--funcF", "1", "--funcH", "1", "--brdf_on", "0",
            "--nr_reg_an_lambda", "0.1", "--eval_every_n_epochs", "0",
            "--max_train_steps", "12", "--exp_name", exp, *extra]


def _losses(tmp_path, exp):
    with open(tmp_path / "logs" / exp / "scalars.jsonl") as f:
        recs = [json.loads(ln) for ln in f]
    return {r["step"]: (r["train/loss"], r["train/psnr"]) for r in recs
            if "train/loss" in r}


def test_train_cli_tp_matches_dp(tmp_path, capfd):
    """The train CLI with --n_devices 4 --tp 2 (a (2, 2) mesh) and
    --scan_chunk 2 against --n_devices 4 (data parallel) on one AOI
    (test_trainer_tp_matches_dp): the logged losses and PSNR to rtol 5e-4;
    rank 0 alone logs, validates and writes whole weights and moments,
    which the JAX package's restore_params and restore_opt_state read; a
    resume from the TP run's first epoch on --n_devices 2 --tp 2 with
    --scale_global_batch 1 (a data axis of 1) continues its trajectory; the renders of the TP and DP weights after 8 steps
    differ by a mean |d rgb| below 2e-3."""
    from brdfnerf_tpu.cli import opts as jopts
    from brdfnerf_tpu.utils import checkpoint as jckpt
    from brdfnerf_tpu_torch.cli.train import main as port_train_main
    from brdfnerf_tpu_torch.data.synth_aoi import build_aoi
    from brdfnerf_tpu_torch.serve import load_renderer
    from brdfnerf_tpu_torch.utils import checkpoint as tckpt
    info = build_aoi(str(tmp_path / "aoi"))
    for exp, extra in (("tp", ["--n_devices", "4", "--tp", "2",
                               "--scan_chunk", "2"]),
                       ("dp", ["--n_devices", "4"])):
        argv = _aoi_argv(tmp_path, info, exp, extra)
        assert port_train_main(argv, device="cpu") == 0
        out = capfd.readouterr().out
        assert out.count("[val] epoch") == 1 and out.count("[kernels]") == 1
        if exp == "tp":
            assert "[kernels] none: tensor parallelism (--tp 2)" in out
            assert ("[mesh] 2 data-parallel rank(s) x 2 model-parallel, "
                    "gloo on cpu") in out
            assert ("[mesh] tensor parallelism: trunk sharded over 2 "
                    "'model' devices x 2 'data'") in out
    tp, dp = _losses(tmp_path, "tp"), _losses(tmp_path, "dp")
    assert sorted(tp) == sorted(dp) and 11 in tp
    np.testing.assert_allclose([tp[s] for s in sorted(tp)],
                               [dp[s] for s in sorted(dp)], rtol=5e-4)
    assert tp[11][1] > tp[0][1]            # PSNR (the gated terms add on)

    cks = str(tmp_path / "ckpts")
    ck_tp = tckpt.latest_checkpoint(os.path.join(cks, "tp"))
    ck_dp = tckpt.latest_checkpoint(os.path.join(cks, "dp"))
    assert os.path.basename(ck_tp) == "epoch=1.npz"
    assert tckpt.checkpoint_step(ck_tp) == 12
    # whole weights and moments in the JAX package's layouts
    jargs = jopts.postprocess(jopts.train_parser().parse_args(
        _aoi_argv(tmp_path, info, "tp")))
    jcfg = jopts.to_run_config(jargs)
    jstate, _ = jts.create_train_state(jax.random.PRNGKey(0), jcfg.model,
                                       jcfg.train, 8)
    restored = jckpt.restore_params(jstate.params, ck_tp)
    flat_tp, flat_dp = tckpt.load_flat(ck_tp), tckpt.load_flat(ck_dp)
    for k, v in jflatten(restored).items():
        assert np.array_equal(np.asarray(v), flat_tp[k]), k
    opt = jckpt.restore_opt_state(jstate.opt_state,
                                  ck_tp.replace(".npz", ".opt.npz"))
    assert int(opt[0].count) == 12
    mu = jflatten(opt[0].mu)
    assert mu["coarse/fc_net/1/w"].shape == (64, 64)
    assert np.abs(mu["coarse/fc_net/1/w"]).max() > 0

    # resume the TP run at its first epoch's end on a (1, 2) mesh, with
    # --scale_global_batch 1: the data axis (1) scales nothing
    ck0 = os.path.join(cks, "tp", "epoch=0.npz")
    start = tckpt.checkpoint_step(ck0)
    argv = _aoi_argv(tmp_path, info, "resumed", [
        "--n_devices", "2", "--tp", "2", "--ckpt_path", ck0,
        "--scale_global_batch", "1"])
    assert port_train_main(argv, device="cpu") == 0
    out = capfd.readouterr().out
    assert f"[resume] step {start} from {ck0}" in out
    assert "scaled global batch" not in out
    resumed = _losses(tmp_path, "resumed")
    assert sorted(resumed) == [s for s in sorted(tp) if s >= start]
    np.testing.assert_allclose([resumed[s] for s in sorted(resumed)],
                               [tp[s] for s in sorted(resumed)], rtol=5e-4)

    # the renders of the two runs' weights after 8 steps (epoch 0), the
    # JAX test's horizon: by step 12 the gated terms have set any two
    # valid runs apart (measured: one device, DP 2, DP 4, TP (1, 2) and
    # TP (2, 2) pairwise 6e-4 to 3.5e-3 there, 1.2e-4 to 5e-4 at step 8)
    rays = _val_rays(tmp_path, "tp")
    renders = [load_renderer(str(tmp_path / "logs" / exp), 0,
                             device="cpu").render_image({"rays": rays})
               for exp in ("tp", "dp")]
    d = np.abs(renders[0]["rgb_coarse"] - renders[1]["rgb_coarse"])
    assert np.isfinite(renders[0]["rgb_coarse"]).all()
    assert float(d.mean()) < 2e-3, float(d.mean())


def _val_rays(tmp_path, exp):
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.data.satellite import SatelliteDataset
    args = opts.load_opts(str(tmp_path / "logs" / exp))
    return SatelliteDataset(opts.sat_config_from_opts(args),
                            split="val").get_image(0)["rays"]


def test_train_cli_refuses_a_model_axis_that_does_not_split(tmp_path):
    """--tp 3 with --n_devices 4, and --tp 2 without --n_devices, are
    refused before the dataset is read or anything is written, with the
    JAX package's message."""
    from brdfnerf_tpu_torch.cli.train import main as port_train_main
    base = ["--root_dir", str(tmp_path / "missing"), "--exp_name", "e",
            "--logs_dir", str(tmp_path / "logs")]
    for extra, got in ((["--tp", "3", "--n_devices", "4"], "4"),
                       (["--tp", "2"], "0")):
        with pytest.raises(SystemExit, match=f"multiple of it \\(got "
                                             f"{got}\\)"):
            port_train_main(base + extra, device="cpu")
    assert not os.path.exists(tmp_path / "logs")


@pytest.mark.parametrize("width,layers", [(512, 8), (2048, 12)])
def test_kernels_line_names_tensor_parallelism(width, layers):
    """Under --tp 2 the [kernels] line says K1-K5 are off and why, on the
    card as on the CPU, at the flagship's 8 x 512 and at 12 x 2048 (which
    the fused and the layer-major kernels cover on one device); a
    tensor-parallel step's and
    render's configs take them off, and a kernel gate that meets a
    sharded trunk raises."""
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.cli.train import kernels_line
    from brdfnerf_tpu_torch.models.network import (apply_network_with_normals,
                                                   init_params)
    args = opts.postprocess(opts.train_parser().parse_args(
        ["--root_dir", "r", "--exp_name", "e", "--mapping", "--normal",
         "analystic", "--fc_feat", str(width), "--fc_layers", str(layers),
         "--compute_dtype", "bfloat16_all", "--n_devices", "2", "--tp",
         "2"]))
    cuda = torch.device("cuda")
    cfg = opts.to_run_config(args, device=cuda)
    for dev in (cuda, torch.device("cpu")):
        line = kernels_line(cfg, dev, tp=2)
        assert line.startswith("[kernels] none: tensor parallelism "
                               "(--tp 2)") and "K1-K5" in line, line
    one = kernels_line(cfg, cuda)
    assert "K2 + K3" in one, one       # one device: the fused kernels'
    assert ("layer-major" in one) == (width == 2048), one
    off = ttensor.kernels_off(cfg.render)
    assert not off.use_pallas and not off.fused_trunk
    _, tm = model_configs(**SMALL, normal="analystic")
    params = init_params(tm, torch.Generator().manual_seed(0), device="cpu")
    ttensor.shard_params(params, ttensor.Layout(_Axis(2, 0), tm.skips))
    with pytest.raises(ValueError, match="kernels_off"):
        apply_network_with_normals(params.coarse, tm,
                                   torch.zeros(4, 3), fused_trunk=True)
    # a tensor-parallel step handed a whole state refuses it
    mesh = _Axis(2, 0)
    step = tts.make_fused_train_step(
        tm, cfg.render, cfg.train, None, tts.GateSchedule(**SCHED),
        mesh=mesh, state_shardings=ttensor.Layout(mesh, tm.skips))
    state, _ = tts.create_train_state(tm, cfg.train, 3, device="cpu")
    with pytest.raises(ValueError, match="sharded state"):
        step(state, {}, torch.zeros(1, dtype=torch.int64), 0)
