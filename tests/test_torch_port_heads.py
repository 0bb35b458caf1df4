"""The fused-heads path (BRDFNERF_FUSED_HEADS) of the port against the JAX
package: the plain twins of K4 and K5 (ops/fused_trunk_heads.py) against
the Pallas _fwd_kernel_h / _bwd_kernel_h in interpret mode, the network
forward and the parameter gradients through TrunkHeadsCore, the predicate
that selects the path, and the slice as a whole (the stage-2 loss and
gradients, and a render) with the switch set on both sides.

Tolerances are those of tests/test_torch_port_kernels.py:
  * float32: 3e-5 for the packed logits, 3e-4 of its scale for gx, and the
    gradient bounds of tests/test_pallas.py (atol 2e-4 * scale, rtol 2e-3);
  * bfloat16 / bfloat16_all: close_but_flips (max 1e-2, mean 3e-5 of the
    reference's scale; mean 3e-3 for a gradient, a sum over every point),
    since both sides round the same operands to bf16 and only summation
    order flips a rounding now and then.
The slice as a whole holds to tests/test_torch_port_train.py's bounds.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu.models import network as jnet
from brdfnerf_tpu.ops import pallas_mlp as jk1, pallas_trunk_heads as jh
from brdfnerf_tpu.ops.compositing import l2_normalize as jl2
from brdfnerf_tpu.parallel import train_step as jts
from brdfnerf_tpu.render import render as jrender

from brdfnerf_tpu_torch.models import network as tnet
from brdfnerf_tpu_torch.ops import fused_mlp as tk1
from brdfnerf_tpu_torch.ops import fused_trunk_heads as th
from brdfnerf_tpu_torch.ops import fused_trunk_vjp as tk2
from brdfnerf_tpu_torch.parallel import train_step as tts
from brdfnerf_tpu_torch.render import render as trender

from test_torch_port_kernels import (_grad_close, _inputs, _j2t, _scale,
                                     close_but_flips)
from test_torch_port_serve import close_slice
from test_torch_port_train import (GATES, N_RAYS, _grads_close, draws_for,
                                   setup, train_configs)
from torch_port_common import (SMALL, FLAGSHIP_HEADS, close, jax_batch,
                               make_rays, make_store, model_configs,
                               networks, t, torch_batch)

DTYPES = ["float32", "bfloat16", "bfloat16_all"]
SIZES = [(4, 2), (8, 4)]
SWITCH = "BRDFNERF_FUSED_HEADS"


def _configs(dtype="float32", layers=4, skip=2, **kw):
    return model_configs(**dict(SMALL, layers=layers, skips=(skip,)),
                         **dict(FLAGSHIP_HEADS, **kw), compute_dtype=dtype)


def _packs(params, net, jcfg, tcfg):
    od = jnp.bfloat16 if jcfg.compute_dtype != "float32" else jnp.float32
    wd = tk1.weight_dtype(tcfg)
    return (jk1.pack_trunk_weights(params, jcfg, od),
            jh.pack_head_weights(params, jcfg, od),
            tk1.pack_trunk_weights(net, tcfg, wd),
            th.pack_head_weights(net, tcfg, wd))


def _logit_cotangents(n, seed=6):
    """(n, 8) logit cotangents with column 7 zero, and (n, 128) c_g."""
    rng = np.random.RandomState(seed)
    cot = rng.normal(size=(n, 8)).astype(np.float32)
    cot[:, 7] = 0.0
    return cot, rng.normal(size=(n, 128)).astype(np.float32)


# ------------------------------------------------------------ the twins

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layers,skip", SIZES)
def test_k4_twin_matches_pallas(dtype, layers, skip):
    jcfg, tcfg = _configs(dtype, layers, skip)
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(200)
    jp, jhw, tp, thw = _packs(params, net, jcfg, tcfg)
    out_r, gx_r, zs_r = jh._run_fwd_h(jcfg, jp, jhw, enc, interpret=True,
                                      want_zs=True)
    res = th._run_fwd_h(tcfg, tp, thw, t(enc), want_zs=True)
    assert len(res) == 3                # zs alone: the backward rebuilds us
    out, gx, zs = res
    assert tuple(out.shape) == (200, 8) and tuple(gx.shape) == (200, 128)
    assert float(out[:, 7].abs().max()) == 0.0
    assert float(gx[:, 60:].abs().max()) == 0.0
    assert zs.dtype == (torch.bfloat16 if dtype == "bfloat16_all"
                        else torch.float32)
    assert tuple(zs.shape) == (256, layers * 64)     # rows padded to 64
    zs, zs_r = zs[:200], zs_r[:200]
    if dtype == "float32":
        close(out, out_r, atol=3e-5, rtol=3e-5, what="out")
        close(gx, gx_r, atol=3e-4 * _scale(gx_r), what="gx")
        close(zs, zs_r, atol=3e-4 * _scale(zs_r), rtol=3e-5, what="zs")
    else:
        for name, g, r in (("out", out, out_r), ("gx", gx, gx_r),
                           ("zs", zs, zs_r)):
            close_but_flips(g, r, name)
    # the no-grad path computes the same logits and gx
    for g, r in zip((out, gx), th._run_fwd_h(tcfg, tp, thw, t(enc))):
        assert torch.equal(g, r)


K5_NAMES = ("dw0", "db0", "dwm", "dbm", "dwst", "dwsb", "dbs", "dwsig",
            "dbsig", "dwf", "dbf", "dw1r", "db1r", "dw2r", "db2r", "dw1p",
            "db1p", "dw2p", "db2p")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layers,skip", SIZES)
def test_k5_twin_matches_pallas(dtype, layers, skip):
    """_run_bwd_h's twin against the Pallas _bwd_kernel_h on the same saved
    zs (the JAX forward's) and the same cotangents, every output."""
    jcfg, tcfg = _configs(dtype, layers, skip)
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(200)
    jp, jhw, tp, thw = _packs(params, net, jcfg, tcfg)
    _, _, zs = jh._run_fwd_h(jcfg, jp, jhw, enc, interpret=True,
                             want_zs=True)
    cot, cg = _logit_cotangents(200)
    ref = list(jh._run_bwd_h(jcfg, jp, jhw, enc, jnp.asarray(cot),
                             jnp.asarray(cg), zs, interpret=True))
    ref[7], ref[8] = ref[7][:, 0], ref[8][:1]
    sd = torch.bfloat16 if dtype == "bfloat16_all" else None
    got = th._run_bwd_h(tcfg, tp, thw, t(enc), t(cot), t(cg), _j2t(zs, sd))
    assert len(got) == len(ref) == len(K5_NAMES)
    for name, g, r in zip(K5_NAMES, got, ref):
        assert tuple(g.shape) == tuple(r.shape), name
        _grad_close(g, r, dtype, name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layers,skip", SIZES)
def test_uchain_is_the_chain_the_pallas_backward_rebuilds(dtype, layers,
                                                          skip):
    """uchain_plain (the b_th chain K5 rebuilds from zs before its sweep)
    against the same chain written out with the JAX package's own
    operations in _bwd_kernel_h's order, on the JAX forward's zs (the
    module's tolerances); and the twin's reverse sweep on those states
    against the sweep that rebuilds them as it runs (the Pallas kernel's
    form), to 1e-6 of the scale."""
    from brdfnerf_tpu.ops import pallas_trunk_vjp as jv
    jcfg, tcfg = _configs(dtype, layers, skip)
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(256)          # 4 whole tiles: zs unpadded
    jp, jhw, tp, thw = _packs(params, net, jcfg, tcfg)
    _, _, zs = jh._run_fwd_h(jcfg, jp, jhw, enc, interpret=True,
                             want_zs=True)
    od = jnp.bfloat16 if dtype != "float32" else jnp.float32
    feat = jcfg.feat
    zf = jnp.asarray(zs, jnp.float32)
    d1s, h = [], None
    for i in range(layers):
        h, d1, _ = jv._act_all(zf[:, i * feat:(i + 1) * feat],
                               30.0 if i == 0 else 1.0, True, True, False)
        d1s.append(d1)
    zsig = jv._mm(h, jp["w_sigma"], od) + jp["b_sigma"]
    lane0 = (jnp.arange(zsig.shape[1]) == 0).astype(jnp.float32)
    b_th = jv._mm_t(jax.nn.sigmoid(zsig) * lane0, jp["w_sigma"], od)
    ref = [None] * layers
    mid = layers - 3
    for i in range(layers - 1, -1, -1):
        ref[i] = b_th
        if i == 0:
            break
        b_tz = d1s[i] * b_th
        if i == skip:
            b_th = jv._mm_t(b_tz, jp["w_skip_bot"], od)
        else:
            b_th = jv._mm_t(b_tz, jp["w_mid"][mid], od)
            mid -= 1
    ref = jnp.concatenate(ref, axis=1)
    sd = torch.bfloat16 if dtype == "bfloat16_all" else None
    zs_t = _j2t(zs, sd)
    got = th.uchain_plain(tp, tcfg, zs_t)
    assert tuple(got.shape) == (256, layers * feat)
    if dtype == "float32":
        close(got, ref, atol=1e-6 * _scale(ref), rtol=1e-5, what="b_th chain")
    else:       # the bf16 roundings of b_tz flip now and then, as in K2
        close_but_flips(got, ref, "b_th chain")
    # the sweep on the rebuilt states is the sweep that rebuilds them
    cot, cg = _logit_cotangents(256)
    x, cg_t = tk1.pad_rows_lanes(t(enc), 256, 128), t(cg)
    hs, d1t, d2t, zsig_t, tzs, ths, _ = tk2._bwd_primal_tangent(tp, tcfg,
                                                                cg_t, zs_t)
    a_h = t(cot)[:, 1:2] * tp["w_sigma"][None, :]
    seed = tk2._mm_t(torch.sigmoid(zsig_t)[:, None], tp["w_sigma"][None, :],
                     tk1.weight_dtype(tcfg))
    inline = tk2._reverse_sweep(tp, tcfg, x, cg_t, hs, d1t, d2t, tzs, ths,
                                a_h, b_th=seed)
    given = tk2._reverse_sweep(tp, tcfg, x, cg_t, hs, d1t, d2t, tzs, ths,
                               a_h, bths=got.split(feat, 1))
    for g_, r_ in zip(given, inline):
        assert float((g_ - r_).abs().max()) <= 1e-6 * _scale(r_)


def test_uchain_from_kernel_reads_the_accumulator_layout():
    """K5's rebuilt chain lies in its sweep's tz layout (element j, e of
    consumer thread c of layer l of tile t at ((t L + l) 128 + 4 j + e) 256
    + c; thread c holds rows 16 w + q + 8 (e // 2), columns 256 wg + 8 j +
    2 p + e % 2 for c = 128 wg + 32 w + 4 q + p); uchain_from_kernel reads
    it back into (n, L * 512), every element once."""
    n, layers, f = 128, 2, tk1.FEAT
    want = torch.arange(n * layers * f, dtype=torch.float32).view(
        n, layers * f)
    tt, ll, jj, ee, cc = torch.meshgrid(
        torch.arange(n // 64), torch.arange(layers), torch.arange(32),
        torch.arange(4), torch.arange(256), indexing="ij")
    wg, w, q, p = cc // 128, (cc // 32) % 4, (cc // 4) % 8, cc % 4
    rows = tt * 64 + 16 * w + q + 8 * (ee // 2)
    cols = ll * f + 256 * wg + 8 * jj + 2 * p + ee % 2
    uc = want[rows.reshape(-1), cols.reshape(-1)]
    assert torch.equal(th.uchain_from_kernel(uc, n, layers), want)


def test_heads_backward_takes_no_u_chain():
    """The heads' backward takes zs alone, as the Pallas pair does: K5's
    checks and launch path have no u-chain input, and refuse zs that is not
    the bfloat16_all contract's bf16."""
    import inspect
    for fn in (th.check_bwd_h_inputs, th._trunk_heads_bwd_cuda,
               th._run_bwd_h):
        assert "us" not in inspect.signature(fn).parameters, fn
    _, net = networks(*_configs("bfloat16_all"))
    tcfg = net.cfg
    packed = tk1.pack_trunk_weights(net, tcfg, torch.bfloat16)
    hw = th.pack_head_weights(net, tcfg, torch.bfloat16)
    x, cot, cg = torch.zeros(64, 128), torch.zeros(64, 8), torch.zeros(64, 128)
    with pytest.raises(ValueError):
        th.check_bwd_h_inputs(tcfg, packed, hw, x, cot, cg,
                              torch.zeros(64, 4 * 64))


# ------------------------------------------------------- the network path

def _xyz_sun(n, seed=1):
    xyz, _ = _inputs(n, seed=seed)
    sun = np.tile(np.asarray([[0.3, 0.2, 0.93]], np.float32), (n, 1))
    return xyz, sun


@pytest.mark.parametrize("dtype", ["float32", "bfloat16_all"])
def test_apply_network_with_normals_fused_heads(dtype, monkeypatch):
    """The main pass with the switch on, key by key, against the JAX
    package's fused-heads path; the port's call reaches K4's twin and not
    K2's."""
    monkeypatch.setenv(SWITCH, "1")
    jcfg, tcfg = _configs(dtype)
    params, net = networks(jcfg, tcfg)
    xyz, sun = _xyz_sun(120)
    calls = []
    twin = th._trunk_heads_fwd_plain
    monkeypatch.setattr(th, "_trunk_heads_fwd_plain",
                        lambda *a_, **k_: calls.append(1) or twin(*a_, **k_))
    monkeypatch.setattr(tk2, "_trunk_fwd_grad_plain", _refuse)
    ref = jnet.apply_network_with_normals(
        params, jcfg, jnp.asarray(xyz), sun_d=jnp.asarray(sun),
        apply_brdf=True, fused_trunk=True)
    with torch.no_grad():
        got = tnet.apply_network_with_normals(
            net, tcfg, t(xyz), sun_d=t(sun), apply_brdf=True,
            fused_trunk=True)
    assert calls == [1]
    assert set(got) == set(ref) == {"sigma", "rgb", "rpv_k", "rpv_theta",
                                    "rpv_rhoc", "normal_an"}
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        if dtype == "float32":
            close(got[k], ref[k], atol=5e-5, rtol=5e-5, what=k)
        else:
            close_but_flips(got[k], ref[k], k)


def _refuse(*_a, **_k):
    raise AssertionError("this path must not run here")


def _cots(n, seed=2):
    rng = np.random.RandomState(seed)
    return {"sigma": rng.normal(size=n), "rgb": rng.normal(size=(n, 3)),
            "rpv_k": rng.normal(size=(n, 3)),
            "rpv_theta": rng.normal(size=(n, 3)),
            "rpv_rhoc": rng.normal(size=(n, 3)),
            "normal_an": rng.normal(size=(n, 3))}


def _port_grads(net, tcfg, xyz, sun, cots, fused=True):
    pars = list(net.parameters())
    with torch.enable_grad():
        out = tnet.apply_network_with_normals(
            net, tcfg, t(xyz), sun_d=t(sun), apply_brdf=True,
            fused_trunk=fused)
        loss = sum(torch.sum(t(c.astype(np.float32)) * out[k].float())
                   for k, c in cots.items())
        grads = torch.autograd.grad(loss, pars, allow_unused=True)
    return loss, dict(zip((n for n, _ in net.named_parameters()), grads))


@pytest.mark.parametrize("dtype,layers,skip",
                         [("float32", 4, 2), ("float32", 8, 4),
                          ("bfloat16", 4, 2), ("bfloat16_all", 8, 4)])
def test_trunk_heads_core_grads_match_jax_grad(dtype, layers, skip,
                                               monkeypatch):
    """The gradients of a loss touching every head output (sigma, rgb, the
    three RPV maps, the normal) through TrunkHeadsCore, against
    jax.value_and_grad of the JAX package's fused-heads path, for every w
    and b of the trunk and the heads (test_pallas.py:360-405)."""
    monkeypatch.setenv(SWITCH, "1")
    jcfg, tcfg = _configs(dtype, layers, skip)
    params, net = networks(jcfg, tcfg)
    xyz, sun = _xyz_sun(70)
    cots = _cots(70)

    def jloss(p):
        out = jnet.apply_network_with_normals(
            p, jcfg, jnp.asarray(xyz), sun_d=jnp.asarray(sun),
            apply_brdf=True, fused_trunk=True)
        return sum(jnp.sum(jnp.asarray(c, jnp.float32) * out[k])
                   for k, c in cots.items())

    v_ref, g_ref = jax.value_and_grad(jloss)(params)
    v_got, grads = _port_grads(net, tcfg, xyz, sun, cots)
    np.testing.assert_allclose(v_got.item(), float(v_ref), rtol=1e-4,
                               atol=1e-3)
    checked = 0
    for name, g in grads.items():
        head, i, wb = name.split(".")
        r = g_ref[head][int(i)][wb]
        assert g is not None, name
        g = g.t() if wb == "w" else g
        assert tuple(g.shape) == tuple(r.shape), name
        _grad_close(g, r, dtype, name)
        checked += 1
    assert checked == 2 * (layers + 1 + 1 + 2 + 6)


@pytest.mark.parametrize("layers,skip", SIZES)
def test_trunk_heads_core_grads_match_port_autograd(layers, skip,
                                                    monkeypatch):
    """TrunkHeadsCore against the port's own unfused double-backward
    autograd (fused_trunk off), f32."""
    monkeypatch.setenv(SWITCH, "1")
    jcfg, tcfg = _configs("float32", layers, skip)
    _, net = networks(jcfg, tcfg)
    xyz, sun = _xyz_sun(60, seed=3)
    cots = _cots(60, seed=4)
    _, fused = _port_grads(net, tcfg, xyz, sun, cots, fused=True)
    _, ref = _port_grads(net, tcfg, xyz, sun, cots, fused=False)
    assert set(fused) == set(ref) and len(fused) == 2 * (layers + 10)
    for name, gr in ref.items():
        scale = max(_scale(gr), 1e-3)
        close(fused[name], gr, atol=2e-4 * scale, rtol=2e-3, what=name)


def test_trunk_heads_core_none_cotangents_are_zeros():
    """Outputs the loss does not touch reach the backward as None and count
    as zero cotangents."""
    _, net = networks(*_configs())
    tcfg = net.cfg
    xyz, _ = _inputs(50)
    pars = tk2.trunk_params(net) + th.head_params(net)
    sigma = th.fused_trunk_heads_with_grad(net, tcfg, t(xyz))["sigma"]
    got = torch.autograd.grad(sigma.sum(), pars)
    res = th.fused_trunk_heads_with_grad(net, tcfg, t(xyz))
    ref = torch.autograd.grad(res["sigma"].sum() + 0.0 * res["normal_an"].sum(),
                              pars)
    for a_, b_ in zip(got, ref):
        assert torch.equal(a_, b_)


# ------------------------------------------------------------ the predicate

REFUSED = {"apply_brdf off": ({}, dict(apply_brdf=False)),
           "view dirs": (dict(input_viewdir=True), {}),
           "nr_lr": (dict(normal="analystic_learned"), dict(nr_lr=True)),
           "Hapke": (dict(func_m=False, func_f=False, func_h=0, hapke_b=True,
                          hapke_c=True), {}),
           "learned sun_v": (dict(sun_v="learned"), {})}


@pytest.mark.parametrize("case", ["flagship"] + sorted(REFUSED))
def test_heads_kernel_supports_agrees_with_jax(case):
    over, call = REFUSED.get(case, ({}, {}))
    jcfg, tcfg = model_configs(**dict(SMALL, **dict(FLAGSHIP_HEADS, **over)),
                               compute_dtype="bfloat16_all")
    params, net = networks(jcfg, tcfg)
    kw = dict(dict(apply_brdf=True), **call)
    dirs = np.zeros((4, 3), np.float32) if over.get("input_viewdir") else None
    ref = jh.heads_kernel_supports(
        jcfg, params, dirs=None if dirs is None else jnp.asarray(dirs), **kw)
    got = th.heads_kernel_supports(
        tcfg, net, dirs=None if dirs is None else t(dirs), **kw)
    assert got == ref == (case == "flagship")


# ------------------------------------------------------ the slice as a whole

def test_stage2_losses_match_jax_with_the_switch(monkeypatch):
    """Stage 2 through the fused-heads path: compute_losses' loss, terms
    and every parameter's gradient against jax.value_and_grad of the JAX
    package's, the switch set on both sides."""
    monkeypatch.setenv(SWITCH, "1")
    calls = []
    bwd = th._trunk_heads_bwd_plain
    monkeypatch.setattr(th, "_trunk_heads_bwd_plain",
                        lambda *a_, **k_: calls.append(1) or bwd(*a_, **k_))
    monkeypatch.setattr(tk2, "_trunk_bwd_plain", _refuse)
    jm, tm, jr, tr, params, net = setup()
    jt, tt = train_configs()
    s = make_store(N_RAYS, seed=5)
    key = jax.random.PRNGKey(9)
    jg = jts.TrainGates(**{k: jnp.asarray(v) for k, v in GATES.items()})
    (l_ref, (terms_ref, _)), g_ref = jax.value_and_grad(
        lambda p: jts.compute_losses(p, jm, jr, jt, jax_batch(s), key, jg),
        has_aux=True)({"coarse": params})
    loss, (terms, _) = tts.compute_losses(
        net, tm, tr, tt, torch_batch(s), tts.TrainGates(**GATES),
        draws=draws_for(key, jr))
    loss.backward()
    assert calls == [1]
    close(loss, l_ref, atol=0.0, rtol=1e-5, what="loss")
    assert set(terms) == set(terms_ref)
    for k in terms_ref:
        close(terms[k], terms_ref[k], atol=1e-7, rtol=1e-5, what=k)
    _grads_close(net, g_ref, "grad")


def test_stage1_with_the_switch_stays_on_k2_k3(monkeypatch):
    """Stage 1 (apply_brdf off) does not take the fused-heads path: the
    switch changes nothing, as in the JAX package."""
    monkeypatch.setenv(SWITCH, "1")
    monkeypatch.setattr(th, "_trunk_heads_fwd_plain", _refuse)
    monkeypatch.setattr(th, "_trunk_heads_bwd_plain", _refuse)
    _, tm, jr, tr, _, net = setup(apply_brdf=False)
    _, tt = train_configs()
    loss, _ = tts.compute_losses(
        net, tm, tr, tt, torch_batch(make_store(N_RAYS, seed=5)),
        tts.TrainGates(**GATES), draws=draws_for(jax.random.PRNGKey(9), jr))
    loss.backward()
    assert np.isfinite(loss.item())


def test_render_matches_jax_with_the_switch(monkeypatch):
    """A train=False render key by key against the JAX package's on the
    same draws, the switch set on both sides."""
    monkeypatch.setenv(SWITCH, "1")
    jm, tm, jr, tr, params, net = setup(perturb=0.0)
    n = 32
    rays = make_rays(n, seed=3)
    key = jax.random.PRNGKey(2)
    ref = jrender.render_rays(
        {"coarse": params}, jm, jr,
        jrender.RenderInputs(rays=jnp.asarray(rays),
                             cos_irra_on=jnp.asarray(False)), key)
    with torch.no_grad():
        got = trender.render_rays(
            net, tm, tr, trender.RenderInputs(
                rays=t(rays), cos_irra_on=torch.tensor(False)),
            draws=draws_for(key, jr, n))
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        close_slice(got[k], ref[k], n, k)


# ------------------------------------------------------------ no fallback

def test_cpu_tensors_take_the_twins(monkeypatch):
    """Forward and backward on CPU tensors run the twins and never reach
    the CUDA launch paths."""
    monkeypatch.setattr(th, "_trunk_heads_fwd_cuda", _refuse)
    monkeypatch.setattr(th, "_trunk_heads_bwd_cuda", _refuse)
    _, net = networks(*_configs("bfloat16_all"))
    xyz, _ = _inputs(70)
    launches = (th.TRUNK_HEADS_FWD.launches, th.TRUNK_HEADS_BWD.launches)
    res = th.fused_trunk_heads_with_grad(net, net.cfg, t(xyz))
    loss = sum(v.float().sum() for v in res.values())
    grads = torch.autograd.grad(loss, tk2.trunk_params(net)
                                + th.head_params(net))
    assert all(torch.isfinite(g).all() for g in grads)
    with torch.no_grad():
        assert th.fused_trunk_heads_with_grad(
            net, net.cfg, t(xyz))["rgb"].shape == (70, 3)
    assert (th.TRUNK_HEADS_FWD.launches,
            th.TRUNK_HEADS_BWD.launches) == launches


def test_kernel_paths_refuse_what_they_cannot_run():
    """K4's and K5's launch paths check their inputs and raise; they never
    hand the work to a twin."""
    _, net = networks(*_configs("bfloat16_all"))
    tcfg = net.cfg
    packed = tk1.pack_trunk_weights(net, tcfg, torch.bfloat16)
    hw = th.pack_head_weights(net, tcfg, torch.bfloat16)
    x = torch.zeros(64, 128)
    with pytest.raises(ValueError):       # a CPU tensor, width 64
        th._trunk_heads_fwd_cuda(packed, hw, tcfg, x)
    zs = torch.zeros(64, 4 * 512, dtype=torch.bfloat16)
    cot, cg = torch.zeros(64, 8), torch.zeros(64, 128)
    with pytest.raises(ValueError):
        th._trunk_heads_bwd_cuda(packed, hw, tcfg, x, cot, cg, zs)
    f512 = dc.replace(tcfg, feat=512)
    with pytest.raises(ValueError):       # heads of width 64
        th.check_head_weights(f512, hw, x)
    with pytest.raises(ValueError):
        th._trunk_heads_fwd_cuda(packed, hw, dc.replace(
            tcfg, compute_dtype="bfloat16"), x, want_zs=True)


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 192, 640])
def test_heads_kernels_match_twins_on_the_card(n):
    """K4 (with and without zs) and K5 against their twins on the card at
    the flagship width (8 x 512, skip 4) on 1, 3 and 10 tiles of 64 points
    (no multiple of a split or a wave), K5 on 5 draws of cotangents, each
    twice with bit-identical grads, at K3's bound of 1e-2 relative L2, and
    its rebuilt b_th chain against uchain_plain; chip_smoke.py makes the
    same checks at the main paths' shapes, where the bounds are
    explained."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from brdfnerf_tpu_torch.config import ModelConfig
    from brdfnerf_tpu_torch.ops.encoding import positional_encoding
    cfg = ModelConfig(variant="spsbrdf-nerf", siren=True, mapping=True,
                      compute_dtype="bfloat16_all", **FLAGSHIP_HEADS)
    g = torch.Generator(device="cuda").manual_seed(0)
    net = tnet.init_network(cfg, g, device="cuda")
    xyz = torch.rand(n, 3, device="cuda", generator=g) * 2 - 1
    enc = positional_encoding(xyz, 10, fast=True, pad_to=128)
    packed = tk1.pack_trunk_weights(net, cfg, torch.bfloat16)
    hw = th.pack_head_weights(net, cfg, torch.bfloat16)
    out_k, gx_k, zs = th._trunk_heads_fwd_cuda(packed, hw, cfg, enc,
                                               want_zs=True)
    out_s, gx_s, _ = th._trunk_heads_fwd_cuda(packed, hw, cfg, enc)
    out_p, gx_p, zs_p = th._trunk_heads_fwd_plain(packed, hw, cfg, enc,
                                                  want_zs=True)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_s) and torch.equal(gx_k, gx_s)
    for k_, p_ in ((out_k, out_p), (gx_k, gx_p), (zs, zs_p)):
        d = (k_.float() - p_.float()).abs()
        scale = float(p_.float().abs().max())
        assert float(d.max()) <= 5e-2 * scale
        assert float(d.mean()) <= 1e-3 * scale
    for draw in range(5):
        cot = torch.randn(n, 8, device="cuda", generator=g)
        cot[:, 7] = 0.0
        cg = torch.zeros(n, 128, device="cuda")
        cg[:, :60] = torch.randn(n, 60, device="cuda", generator=g)
        scratch = {}
        got = th._trunk_heads_bwd_cuda(packed, hw, cfg, enc, cot, cg, zs,
                                       scratch_out=scratch)
        again = th._trunk_heads_bwd_cuda(packed, hw, cfg, enc, cot, cg, zs)
        ref = th._trunk_heads_bwd_plain(packed, hw, cfg, enc, cot, cg, zs)
        uc = th.uchain_from_kernel(scratch["uc"], n, cfg.layers)
        uc_p = th.uchain_plain(packed, cfg, zs)
        torch.cuda.synchronize()
        assert float((uc - uc_p).norm() / uc_p.norm()) <= 1e-2   # as K2's us
        for name, k_, r_, a_ in zip(K5_NAMES, got, ref, again):
            assert torch.equal(k_, a_), name              # deterministic
            if name in ("dw2r", "dw2p"):
                k_, r_ = k_[:, :3], r_[:, :3]
            rel = float((k_ - r_).norm() / r_.norm().clamp_min(1e-12))
            assert rel <= 1e-2, (draw, name, rel)
