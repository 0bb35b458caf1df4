"""The exact sine (fast_sin 0) and ReLU (siren 0) trunks in the kernels'
twins, against the JAX package's Pallas kernels in interpret mode.

The CUDA kernels K1-K5 are built once per activation (ops/cuda_build.ACTS,
csrc/trunk_common.cuh TRUNK_ACT); their plain twins take the
configuration's activation as the Pallas kernels do
(pallas_trunk_vjp._act_all: sin and w0 cos of w0 z; max(z, 0) and (z > 0)
with w0 ignored), the heads' hidden activations (w0 = 1) included.  Here,
on the CPU, at 8 x 64 (float32) and 4 x 64 (bfloat16_all) trunks on 200
points:
  * K1's plain and split twins, K2's (serving and saving zs/us), K3's,
    K4's and K5's twins against the Pallas kernels, at float32 (~1e-5 on
    the forwards, rtol 2e-3 with atol 2e-4 of the scale on gradients, as
    tests/test_torch_port_kernels.py) and at bfloat16_all (the bf16
    contract's rounding flips: close_but_flips);
  * the split emulations at float32 (every product as three bf16
    products) within 1e-4 relative L2 of the Pallas kernels;
  * one fused stage-2 step of the port against the JAX package's;
  * what the gates, the library keys and the train CLI's [kernels] line
    say of the newly covered configurations.
The kernels themselves are held to their twins on the card by
tools/act_check.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu.data import batcher as jbatch
from brdfnerf_tpu.ops import pallas_mlp as jk1, pallas_trunk_heads as jh
from brdfnerf_tpu.ops import pallas_trunk_vjp as jk2
from brdfnerf_tpu.parallel import train_step as jts
from brdfnerf_tpu.utils.checkpoint import _flatten as jflatten

from brdfnerf_tpu_torch.data import batcher as tbatch
from brdfnerf_tpu_torch.ops import cuda_build
from brdfnerf_tpu_torch.ops import fused_mlp as tk1
from brdfnerf_tpu_torch.ops import fused_trunk_heads as th
from brdfnerf_tpu_torch.ops import fused_trunk_vjp as tk2
from brdfnerf_tpu_torch.parallel import train_step as tts

from test_torch_port_kernels import (_cotangents, _grad_close, _inputs,
                                     _j2t, _scale, close_but_flips)
from test_torch_port_train import (N_RAYS, _carry_jax_state, draws_for,
                                   train_configs)
from torch_port_common import (FLAGSHIP_HEADS, SMALL, a, close, make_store,
                               model_configs, networks, render_configs, t)

ACTS = {"sin": dict(siren=True, fast_sin=False),
        "relu": dict(siren=False, fast_sin=True)}
# float32 on the reference's 8 x 64 shape (skip 4), bfloat16_all on 4 x 64
CASES = [("float32", 8, 4), ("bfloat16_all", 4, 2)]
SPLIT_BOUND = 1e-4
K5_NAMES = ("dw0", "db0", "dwm", "dbm", "dwst", "dwsb", "dbs", "dwsig",
            "dbsig", "dwf", "dbf", "dw1r", "db1r", "dw2r", "db2r", "dw1p",
            "db1p", "dw2p", "db2p")


def _configs(act, dtype, layers=4, skip=2):
    return model_configs(**dict(SMALL, layers=layers, skips=(skip,),
                                **ACTS[act]), **FLAGSHIP_HEADS,
                         compute_dtype=dtype)


def _od(dtype):
    return jnp.float32 if dtype == "float32" else jnp.bfloat16


def _rel(got, ref):
    g, r = a(got), a(ref)
    return float(np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30))


def _fwd_close(got, ref, dtype, what):
    if dtype == "float32":
        close(got, ref, atol=3e-4 * _scale(ref), rtol=3e-5, what=what)
    else:
        close_but_flips(got, ref, what)


@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("dtype,layers,skip", CASES)
def test_k1_split_twin_matches_pallas(act, dtype, layers, skip):
    """K1's arithmetic (f32 activations as bf16 hi and lo terms; at
    float32 the three products of split3_mm) at the configuration's
    activation, against pallas_mlp's kernel."""
    jcfg, tcfg = _configs(act, dtype, layers, skip)
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(200)
    s_ref, f_ref = jk1.fused_trunk_sigma(params, jcfg, enc, interpret=True)
    packed = tk1.pack_trunk_weights(net, tcfg, tk1.weight_dtype(tcfg))
    x = tk1.pad_rows_lanes(t(enc), 256, 128)
    s_got, f_got = tk1._trunk_sigma_split(packed, tcfg, x, True)
    assert _rel(s_got[:200], s_ref) <= SPLIT_BOUND
    assert _rel(f_got[:200], f_ref) <= SPLIT_BOUND
    s_pl, _ = tk1._trunk_sigma_plain(packed, tcfg, x, False)
    close(s_pl[:200], s_ref, atol=2e-5, rtol=2e-5, what="plain sigma")


@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("dtype,layers,skip", CASES)
def test_k2_k3_twins_match_pallas(act, dtype, layers, skip):
    """K2 saving zs/us, then K3 on the Pallas forward's zs/us, at the
    activation; at float32 also K2's and K3's split emulations."""
    jcfg, tcfg = _configs(act, dtype, layers, skip)
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(200)
    jp = jk1.pack_trunk_weights(params, jcfg, _od(dtype))
    ref = jk2._run_fwd(jcfg, jp, enc, interpret=True, want_zs=True)
    tp = tk1.pack_trunk_weights(net, tcfg, tk1.weight_dtype(tcfg))
    got = tk2._run_fwd(tcfg, tp, t(enc), want_zs=True)
    names = ("sigma", "feats", "gx", "zs", "us")
    for name, g, r in zip(names, got, ref):
        _fwd_close(g[:200], r[:200], dtype, name)
    x = tk1.pad_rows_lanes(t(enc), 256, 128)
    if dtype == "float32":
        split = tk2._trunk_fwd_grad_split(tp, tcfg, x, want_zs=True)
        for name, g, r in zip(names, split, ref):
            assert _rel(g[:200], r[:200]) <= SPLIT_BOUND, name
    zs, us = ref[3], ref[4]
    cs, cf, cg = _cotangents(200, 64)
    cf_dt = jnp.bfloat16 if dtype == "bfloat16_all" else jnp.float32
    ref = list(jk2._run_bwd(jcfg, jp, enc, jnp.asarray(cs),
                            jnp.asarray(cf).astype(cf_dt), jnp.asarray(cg),
                            zs, us, interpret=True))
    ref[7], ref[8] = ref[7][:, 0], ref[8][:1]
    sd = torch.bfloat16 if dtype == "bfloat16_all" else None
    args = (t(cs), _j2t(jnp.asarray(cf).astype(cf_dt), sd), t(cg),
            _j2t(zs, sd), _j2t(us, sd))
    got = tk2._run_bwd(tcfg, tp, t(enc), *args)
    for name, g, r in zip(K5_NAMES[:9], got, ref):
        _grad_close(g, r, dtype, name)
    if dtype == "float32":
        n_p = zs.shape[0]
        csp = torch.zeros(n_p)
        csp[:200] = args[0]
        split = tk2._trunk_bwd_split(
            tp, tcfg, x, csp, tk1.pad_rows_lanes(args[1], n_p, 64),
            tk1.pad_rows_lanes(args[2], n_p, 128), args[3], args[4])
        for name, g, r in zip(K5_NAMES[:9], split, ref):
            assert _rel(g, r) <= SPLIT_BOUND, name


@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("dtype,layers,skip", CASES)
def test_k4_k5_twins_match_pallas(act, dtype, layers, skip):
    """K4 saving zs and K5 on the Pallas forward's zs, the heads' hidden
    activations at the configuration's too; at float32 also their split
    emulations."""
    jcfg, tcfg = _configs(act, dtype, layers, skip)
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(200)
    jp = jk1.pack_trunk_weights(params, jcfg, _od(dtype))
    jhw = jh.pack_head_weights(params, jcfg, _od(dtype))
    wd = tk1.weight_dtype(tcfg)
    tp = tk1.pack_trunk_weights(net, tcfg, wd)
    thw = th.pack_head_weights(net, tcfg, wd)
    ref = jh._run_fwd_h(jcfg, jp, jhw, enc, interpret=True, want_zs=True)
    got = th._run_fwd_h(tcfg, tp, thw, t(enc), want_zs=True)
    for name, g, r in zip(("out", "gx", "zs"), got, ref):
        _fwd_close(g[:200], r[:200], dtype, name)
    x = tk1.pad_rows_lanes(t(enc), 256, 128)
    if dtype == "float32":
        split = th._trunk_heads_fwd_split(tp, thw, tcfg, x, want_zs=True)
        for name, g, r in zip(("out", "gx", "zs"), split, ref):
            assert _rel(g[:200], r[:200]) <= SPLIT_BOUND, name
    zs = ref[2]
    rng = np.random.RandomState(6)
    cot = rng.normal(size=(200, 8)).astype(np.float32)
    cot[:, 7] = 0.0
    cg = rng.normal(size=(200, 128)).astype(np.float32)
    ref = list(jh._run_bwd_h(jcfg, jp, jhw, enc, jnp.asarray(cot),
                             jnp.asarray(cg), zs, interpret=True))
    ref[7], ref[8] = ref[7][:, 0], ref[8][:1]
    sd = torch.bfloat16 if dtype == "bfloat16_all" else None
    got = th._run_bwd_h(tcfg, tp, thw, t(enc), t(cot), t(cg), _j2t(zs, sd))
    for name, g, r in zip(K5_NAMES, got, ref):
        _grad_close(g, r, dtype, name)
    if dtype == "float32":
        n_p = zs.shape[0]
        split = th._trunk_heads_bwd_split(
            tp, thw, tcfg, x, tk1.pad_rows_lanes(t(cot), n_p, 8),
            tk1.pad_rows_lanes(t(cg), n_p, 128), _j2t(zs))
        for name, g, r in zip(K5_NAMES, split, ref):
            assert _rel(g, r) <= SPLIT_BOUND, name


@pytest.mark.parametrize("act", list(ACTS))
def test_one_fused_stage2_step_matches_jax(act):
    """make_fused_train_step at the activation (stage 2: RPV heads, the
    fused trunk's twins, float32), one step from the JAX state on the JAX
    step's draws, against the JAX package's fused step: the step's
    metrics, and every parameter after the update (a gradient element
    within the tolerance of zero may take either sign, and Adam turns
    either sign into a step of about lr: test_three_fused_steps_match_jax)."""
    jm, tm = model_configs(**dict(SMALL, **ACTS[act]), **FLAGSHIP_HEADS,
                           compute_dtype="float32")
    jr, tr = render_configs(n_samples=8, guided_samples=8, apply_brdf=True,
                            use_pallas=True, fused_trunk=True, perturb=0.0)
    jt, tt = train_configs()
    store = make_store(64, seed=11)
    sched = dict(t_cos_irra=1e18, t_ds_drop=1e18, t_nrrg=-1.0,
                 steps_per_epoch=1, first_beta_epoch=0)
    jstate, jopt = jts.create_train_state(jax.random.PRNGKey(0), jm, jt,
                                          steps_per_epoch=2)
    jstep = jts.make_fused_train_step(jm, jr, jt, jopt,
                                      jts.GateSchedule(**sched))
    state, opt = tts.create_train_state(
        tm, tt, 2, flat=jflatten({"coarse": jstate.params["coarse"]}),
        device="cpu")
    step = tts.make_fused_train_step(tm, tr, tt, opt,
                                     tts.GateSchedule(**sched))
    jb = jbatch.DeviceRayBatcher(store, N_RAYS, seed=3)
    tb = tbatch.DeviceRayBatcher(store, N_RAYS, seed=3, device="cpu")
    base_key = jax.random.PRNGKey(1)
    idx = tb.next_index_tensor()
    jidx = jb.next_indices().astype(np.int32)
    _carry_jax_state(state, jstate)
    jstate, jm_ = jstep(jstate, jb.store, jnp.asarray(jidx), base_key)
    state, m = step(state, tb.store, idx, 0,
                    draws=draws_for(jax.random.fold_in(base_key, 0), jr))
    for k in ("loss", "psnr", "perc_bad_nr", "depth_std_mean"):
        close(m[k], jm_[k], atol=1e-6, rtol=5e-4, what=k)
    flat = jflatten(jstate.params)
    for name, p in state.params.named_parameters():
        ref = flat[name.replace(".", "/")]
        got = a(p.t() if name.endswith(".w") else p)
        d = np.abs(got - ref)
        scale = max(float(np.abs(ref).max()), 1e-3)
        flipped = d > 5e-4 * scale + 5e-4 * np.abs(ref)
        assert flipped.mean() <= 1e-3, (name, flipped.sum())
        assert d.max() <= 2 * tt.lr, (name, d.max())


# --------------------------------------------- gates, libraries, the CLI

@pytest.mark.parametrize("act", ["poly", "sin", "relu"])
@pytest.mark.parametrize("dtype", tk1.CUDA_DTYPES)
def test_gates_admit_every_activation(act, dtype):
    """cuda_kernels_cover and heads_kernel_supports hold for the flagship
    width at every activation and kernel dtype; act_of names the library;
    width 64 is covered too, and a width the fused kernels are not built
    for is covered at the next built width (kernel_cfg: 96 at 128,
    zero-padded), or past 512 by the layer-major family."""
    from brdfnerf_tpu_torch.config import ModelConfig
    from brdfnerf_tpu_torch.models.network import init_network
    kw = {"poly": dict(siren=True, fast_sin=True)}.get(act) or ACTS[act]
    cfg = ModelConfig(variant="spsbrdf-nerf", mapping=True,
                      compute_dtype=dtype, **kw, **FLAGSHIP_HEADS)
    assert tk1.act_of(cfg) == act
    assert tk1.cuda_kernels_cover(cfg)
    net = init_network(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert th.heads_kernel_supports(cfg, net, apply_brdf=True)
    import dataclasses as dc
    assert tk1.cuda_kernels_cover(dc.replace(cfg, feat=64))
    c96 = dc.replace(cfg, feat=96)
    assert tk1.cuda_kernels_cover(c96) and tk1.kernel_cfg(c96).feat == 128
    assert not tk1.layer_major(tk1.kernel_cfg(c96))
    assert tk1.layer_major(tk1.kernel_cfg(dc.replace(cfg, feat=768)))


@pytest.mark.parametrize("act,flag", [("poly", None), ("sin", "1"),
                                      ("relu", "2")])
def test_library_keys_build_each_activation_apart(act, flag):
    """One library per source and activation: the polynomial keeps the
    source's name and NVCC_FLAGS alone, the others add their -DTRUNK_ACT
    flag and hash it into their own path."""
    key = cuda_build.library_key("trunk_bwd", act)
    name, flags = cuda_build._source_flags(key)
    assert name == "trunk_bwd"
    if flag is None:
        assert key == "trunk_bwd" and flags == cuda_build.NVCC_FLAGS
    else:
        assert flags == cuda_build.NVCC_FLAGS + (f"-DTRUNK_ACT={flag}",)
    paths = {cuda_build.library_path(cuda_build.library_key("trunk_bwd", a_))
             for a_ in cuda_build.ACTS}
    assert len(paths) == 3
    with pytest.raises(ValueError):
        cuda_build.library_key("trunk_bwd", "tanh")


@pytest.mark.parametrize("argv,want", [
    (["--fast_sin", "0"], ["K1 (the sigma-only passes)", "K2 + K3",
                           "the exact sine"]),
    (["--siren", "0"], ["K1 (the sigma-only passes)", "K2 + K3", "ReLU"]),
    (["--siren", "0", "--compute_dtype", "bfloat16_all"],
     ["K2 + K3", "ReLU", "compute_dtype='bfloat16_all'"]),
    ([], ["K2 + K3", "the polynomial sine"]),
    (["--fc_feat", "96"], ["K1 (the sigma-only passes)", "K2 + K3",
                           "width 96 (K1-K3 run at 128, zero-padded)"]),
    (["--fc_feat", "64"], ["K1 (the sigma-only passes)", "K2 + K3",
                           "width 64"])])
def test_train_cli_kernels_line_per_activation(monkeypatch, argv, want):
    """The train CLI's [kernels] line on the card: K1-K3 at the exact sine
    and at ReLU, named with the activation, and at width 64; a width the
    kernels are not built for runs them at the next built width, and the
    line says so."""
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.cli.train import kernels_line
    monkeypatch.delenv("BRDFNERF_FUSED_HEADS", raising=False)
    args = opts.postprocess(opts.train_parser().parse_args(
        ["--root_dir", "r", "--exp_name", "e", "--mapping", "--normal",
         "analystic"] + argv))
    cuda = torch.device("cuda")
    line = kernels_line(opts.to_run_config(args, device=cuda), cuda)
    for w in want:
        assert w in line, (w, line)
    assert "siren=0" not in line and "fast_sin=0" not in line
