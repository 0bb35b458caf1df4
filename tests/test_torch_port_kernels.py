"""The plain twins of the port's two trunk kernels against the JAX
package's Pallas kernels (interpret mode on the CPU), and the network paths
that reach them.

K1 (ops/fused_mlp.py) mirrors pallas_mlp._trunk_kernel, K2
(ops/fused_trunk_vjp.py) mirrors pallas_trunk_vjp._fwd_kernel.

Tolerances:
  * float32: the bounds of tests/test_pallas.py (2e-5 / 3e-5; gx 3e-4
    relative to its scale).
  * K1 under bfloat16 / bfloat16_all: the Pallas kernel multiplies f32
    activations by bf16-rounded weights in f32, and so does the twin: only
    the summation order differs, so the f32 bounds hold.
  * K2 under bfloat16 / bfloat16_all: both round every product operand to
    bf16.  Summation order moves an f32 result by an ulp, which now and
    then flips the bf16 rounding of the next operand (a 2^-8 relative step
    of one element) and moves the points downstream of it.  So the max is
    held loosely and the mean tightly, both relative to the reference's
    scale: max 1e-2, mean 3e-5.  Measured here (8 layers, 200 points):
    sigma max 1.2e-7, gx max 1.0e-3 at scale 0.58 with mean 2.1e-6; through
    the encoding (fused_trunk_with_grad) one point of 150 moved sigma by
    1.8e-4.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu.ops.encoding import positional_encoding as jpe
from brdfnerf_tpu.ops import pallas_mlp as jk1, pallas_trunk_vjp as jk2
from brdfnerf_tpu.models import network as jnet

from brdfnerf_tpu_torch.ops import fused_mlp as tk1, fused_trunk_vjp as tk2
from brdfnerf_tpu_torch.models import network as tnet

from torch_port_common import (SMALL, FLAGSHIP_HEADS, a, close,
                               model_configs, networks, t)

DTYPES = ["float32", "bfloat16", "bfloat16_all"]


def _inputs(n=300, seed=1):
    xyz = np.random.RandomState(seed).uniform(-1, 1, (n, 3)).astype(
        np.float32)
    return xyz, jpe(jnp.asarray(xyz), 10, fast=True)


def _scale(ref):
    return max(float(np.max(np.abs(a(ref)))), 1e-6)


def close_but_flips(got, ref, what, max_rel=1e-2, mean_rel=3e-5):
    """bf16 parity: rare rounding flips bound the max loosely, the mean
    tightly (see the module docstring)."""
    d = np.abs(a(got) - a(ref))
    scale = _scale(ref)
    assert d.max() <= max_rel * scale, (what, d.max(), scale)
    assert d.mean() <= mean_rel * scale, (what, d.mean(), scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("siren,fast_sin", [(True, True), (True, False),
                                            (False, True)])
def test_k1_twin_matches_pallas(dtype, siren, fast_sin):
    kw = dict(SMALL, siren=siren, fast_sin=fast_sin, compute_dtype=dtype)
    jcfg, tcfg = model_configs(**kw)
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs()
    s_ref, f_ref = jk1.fused_trunk_sigma(params, jcfg, enc, interpret=True)
    s_got, f_got = tk1.fused_trunk_sigma(net, tcfg, t(enc))
    close(s_got, s_ref, atol=2e-5, rtol=2e-5, what="sigma")
    close(f_got, f_ref, atol=2e-5, rtol=2e-5, what="feats")


def test_k1_sigma_fn_unpadded_sizes():
    jcfg, tcfg = model_configs(**SMALL, compute_dtype="bfloat16_all")
    params, net = networks(jcfg, tcfg)
    for n in (1, 63, 65, 200):
        xyz, _ = _inputs(n, seed=n)
        got = tk1.fused_sigma_fn(net, tcfg, t(xyz))
        ref = jk1.fused_sigma_fn(params, jcfg, jnp.asarray(xyz),
                                 interpret=True)
        assert tuple(got.shape) == (n,)
        close(got, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layers,skip", [(4, 2), (8, 4)])
def test_k2_twin_matches_pallas(dtype, layers, skip):
    jcfg, tcfg = model_configs(**dict(SMALL, layers=layers, skips=(skip,),
                                      compute_dtype=dtype))
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(200)
    od = jnp.bfloat16 if dtype != "float32" else jnp.float32
    packed = jk1.pack_trunk_weights(params, jcfg, od)
    s_ref, f_ref, g_ref = jk2._run_fwd(jcfg, packed, enc, interpret=True)
    tpacked = tk1.pack_trunk_weights(net, tcfg, tk1.weight_dtype(tcfg))
    s_got, f_got, g_got = tk2._run_fwd(tcfg, tpacked, t(enc))
    assert f_got.dtype == (torch.bfloat16 if dtype == "bfloat16_all"
                           else torch.float32)
    assert tuple(g_got.shape) == g_ref.shape == (200, 128)
    assert float(g_got[:, 60:].abs().max()) == 0.0
    if dtype == "float32":
        close(s_got, s_ref, atol=3e-5, rtol=3e-5, what="sigma")
        close(f_got, f_ref, atol=3e-5, rtol=3e-5, what="feats")
        close(g_got, g_ref, atol=3e-4 * _scale(g_ref), what="gx")
    else:
        close_but_flips(s_got, s_ref, "sigma")
        close_but_flips(f_got, f_ref, "feats")
        close_but_flips(g_got, g_ref, "gx")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16_all"])
@pytest.mark.parametrize("mapping", [True, False])
def test_fused_trunk_with_grad(dtype, mapping):
    jcfg, tcfg = model_configs(**dict(SMALL, mapping=mapping,
                                      compute_dtype=dtype))
    params, net = networks(jcfg, tcfg)
    xyz, _ = _inputs(150)
    s_ref, f_ref, g_ref = jk2.fused_trunk_with_grad(params, jcfg,
                                                    jnp.asarray(xyz))
    s_got, f_got, g_got = tk2.fused_trunk_with_grad(net, tcfg, t(xyz))
    assert tuple(g_got.shape) == (150, 3)
    if dtype == "float32":
        close(s_got, s_ref, atol=3e-5, rtol=3e-5, what="sigma")
        close(f_got, f_ref, atol=3e-5, rtol=3e-5, what="feats")
        close(g_got, g_ref, atol=3e-4 * _scale(g_ref), what="grad")
    else:
        close_but_flips(s_got, s_ref, "sigma")
        close_but_flips(f_got, f_ref, "feats")
        close_but_flips(g_got, g_ref, "grad")


@pytest.mark.parametrize("fused", [True, False])
def test_apply_network_with_normals(fused):
    """The main pass of the spsbrdf inference, key by key, f32: the fused
    branch reaches K2's twin, the other one autograd."""
    jcfg, tcfg = model_configs(**SMALL, **FLAGSHIP_HEADS,
                               compute_dtype="float32")
    params, net = networks(jcfg, tcfg)
    xyz, _ = _inputs(120)
    sun = np.tile(np.asarray([[0.3, 0.2, 0.93]], np.float32), (120, 1))
    ref = jnet.apply_network_with_normals(
        params, jcfg, jnp.asarray(xyz), sun_d=jnp.asarray(sun),
        apply_brdf=True, fused_trunk=fused)
    got = tnet.apply_network_with_normals(
        net, tcfg, t(xyz), sun_d=t(sun), apply_brdf=True, fused_trunk=fused)
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k], atol=5e-5, rtol=5e-5, what=k)


def test_cpu_tensor_takes_the_twin(monkeypatch):
    """On CPU tensors the wrappers run the plain twins and never reach
    the CUDA launch path."""
    def refuse(*_a, **_k):
        raise AssertionError("the CUDA path ran on a CPU tensor")
    monkeypatch.setattr(tk1, "_trunk_sigma_cuda", refuse)
    monkeypatch.setattr(tk2, "_trunk_fwd_grad_cuda", refuse)
    jcfg, tcfg = model_configs(**SMALL, compute_dtype="bfloat16_all")
    _, net = networks(jcfg, tcfg)
    xyz, _ = _inputs(70)
    n1, n2 = tk1.TRUNK_SIGMA.launches, tk2.TRUNK_FWD_GRAD.launches
    assert tk1.fused_sigma_fn(net, tcfg, t(xyz)).shape == (70,)
    assert tk2.fused_trunk_with_grad(net, tcfg, t(xyz))[2].shape == (70, 3)
    assert (tk1.TRUNK_SIGMA.launches, tk2.TRUNK_FWD_GRAD.launches) == (n1,
                                                                       n2)


def test_kernel_path_refuses_what_it_cannot_run():
    """The launch path checks its inputs and raises; it never hands the
    work to the twin."""
    jcfg, tcfg = model_configs(**SMALL, compute_dtype="bfloat16_all")
    _, net = networks(jcfg, tcfg)
    packed = tk1.pack_trunk_weights(net, tcfg, torch.bfloat16)
    x = torch.zeros(64, 128)
    with pytest.raises(ValueError):       # a CPU tensor, width 64
        tk1._trunk_sigma_cuda(packed, tcfg, x, False)
    with pytest.raises(ValueError):
        tk2._trunk_fwd_grad_cuda(packed, tcfg, x)
    f32 = dc.replace(tcfg, compute_dtype="float32")
    with pytest.raises(ValueError):
        tk1.check_kernel_inputs(f32, packed, x)


@pytest.mark.cuda
def test_kernels_match_twins_on_the_card():
    """K1 and K2 against their twins on the card, at the flagship width
    (8 x 512, skip 4) on 640 points; chip_smoke.py makes the same check at
    the main path's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from brdfnerf_tpu_torch.config import ModelConfig
    cfg = ModelConfig(variant="spsbrdf-nerf", siren=True, mapping=True,
                      compute_dtype="bfloat16_all")
    g = torch.Generator(device="cuda").manual_seed(0)
    net = tnet.init_network(cfg, g, device="cuda")
    xyz = torch.rand(640, 3, device="cuda", generator=g) * 2 - 1
    from brdfnerf_tpu_torch.ops.encoding import positional_encoding
    enc = positional_encoding(xyz, 10, fast=True, pad_to=128)
    packed = tk1.pack_trunk_weights(net, cfg, torch.bfloat16)
    s_k, _ = tk1._trunk_sigma_cuda(packed, cfg, enc, False)
    s_p, _ = tk1._trunk_sigma_plain(packed, cfg, enc, False)
    torch.cuda.synchronize()
    scale = float(s_p.abs().max())     # chip_smoke.py's bounds
    assert float((s_k - s_p).abs().max()) <= 5e-5 * scale
    assert float((s_k - s_p).abs().mean()) <= 5e-6 * scale
    out_k = tk2._trunk_fwd_grad_cuda(packed, cfg, enc)
    out_p = tk2._trunk_fwd_grad_plain(packed, cfg, enc)
    torch.cuda.synchronize()
    for k_, p_ in zip(out_k, out_p):     # see chip_smoke.py's bounds
        d = (k_.float() - p_.float()).abs()
        scale = float(p_.float().abs().max())
        assert float(d.max()) <= 5e-2 * scale
        assert float(d.mean()) <= 1e-3 * scale


# ---------------------------------------------------------------- training
# K2 saving zs/us and K3 (the trunk's second-order backward).  Grads in f32
# hold to tests/test_pallas.py's gradient bounds (atol 2e-4 * scale, rtol
# 2e-3); in bf16 to close_but_flips with the max bound of K2's outputs and a
# mean bound of 3e-3: a grad is a sum over every point, so each rounding flip
# upstream moves all of it, and the sigma head's bias is one number, whose
# mean is its max.  Measured here (8 layers, relative to the reference's
# scale): K3's twin against the Pallas kernel on 200 points max 8.2e-4, mean
# 2.2e-4; TrunkCore against jax.grad on 90 points max 6.6e-4, and 2.3e-3 for
# the sigma bias.

def _j2t(x, dtype=None):
    """JAX array (bf16 included) -> CPU torch tensor of `dtype` (default
    f32), exact: bf16 values pass through f32."""
    v = torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))
    return v if dtype is None else v.to(dtype)


def _cotangents(n, feat, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=n).astype(np.float32),
            (rng.normal(size=(n, feat)) * 0.1).astype(np.float32),
            rng.normal(size=(n, 128)).astype(np.float32))


def _grad_close(got, ref, dtype, what):
    if dtype == "float32":
        scale = max(_scale(ref), 1e-3)
        close(got, ref, atol=2e-4 * scale, rtol=2e-3, what=what)
    else:
        close_but_flips(got, ref, what, mean_rel=3e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layers,skip", [(4, 2), (8, 4)])
def test_k2_saves_zs_us_like_pallas(dtype, layers, skip):
    jcfg, tcfg = model_configs(**dict(SMALL, layers=layers, skips=(skip,),
                                      compute_dtype=dtype))
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(200)
    od = jnp.bfloat16 if dtype != "float32" else jnp.float32
    packed = jk1.pack_trunk_weights(params, jcfg, od)
    ref = jk2._run_fwd(jcfg, packed, enc, interpret=True, want_zs=True)
    tpacked = tk1.pack_trunk_weights(net, tcfg, tk1.weight_dtype(tcfg))
    got = tk2._run_fwd(tcfg, tpacked, t(enc), want_zs=True)
    want_dt = torch.bfloat16 if dtype == "bfloat16_all" else torch.float32
    for name, g, r in zip(("zs", "us"), got[3:], ref[3:]):
        assert g.dtype == want_dt, name
        assert tuple(g.shape) == (256, layers * 64)      # rows padded to 64
        g, r = g[:200], r[:200]
        if dtype == "float32":
            close(g, r, atol=3e-4 * _scale(r), rtol=3e-5, what=name)
        else:
            close_but_flips(g, r, name)
    # the no-grad path is unchanged by want_zs
    for g, r in zip(got[:3], tk2._run_fwd(tcfg, tpacked, t(enc))):
        assert torch.equal(g, r)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layers,skip", [(4, 2), (8, 4)])
def test_k3_twin_matches_pallas(dtype, layers, skip):
    """_run_bwd's twin against the Pallas _bwd_kernel on the same saved
    zs/us (the JAX forward's) and the same cotangents."""
    jcfg, tcfg = model_configs(**dict(SMALL, layers=layers, skips=(skip,),
                                      compute_dtype=dtype))
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(200)
    od = jnp.bfloat16 if dtype != "float32" else jnp.float32
    packed = jk1.pack_trunk_weights(params, jcfg, od)
    _, _, _, zs, us = jk2._run_fwd(jcfg, packed, enc, interpret=True,
                                   want_zs=True)
    cs, cf, cg = _cotangents(200, 64)
    cf_dt = jnp.bfloat16 if dtype == "bfloat16_all" else jnp.float32
    ref = jk2._run_bwd(jcfg, packed, enc, jnp.asarray(cs),
                       jnp.asarray(cf).astype(cf_dt), jnp.asarray(cg), zs, us,
                       interpret=True)
    sd = torch.bfloat16 if dtype == "bfloat16_all" else None
    tpacked = tk1.pack_trunk_weights(net, tcfg, tk1.weight_dtype(tcfg))
    got = tk2._run_bwd(tcfg, tpacked, t(enc), t(cs),
                       _j2t(jnp.asarray(cf).astype(cf_dt), sd), t(cg),
                       _j2t(zs, sd), _j2t(us, sd))
    names = ("dw0", "db0", "dwm", "dbm", "dwst", "dwsb", "dbs", "dwsig",
             "dbsig")
    ref = list(ref)
    ref[7], ref[8] = ref[7][:, 0], ref[8][:1]
    for name, g, r in zip(names, got, ref):
        assert tuple(g.shape) == tuple(r.shape), name
        _grad_close(g, r, dtype, name)


def _trunk_loss(sigma, feats, g, cs, cf, cg):
    from brdfnerf_tpu_torch.ops.compositing import l2_normalize
    return (torch.sum(cs * sigma) + torch.sum(cf * feats.float())
            + torch.sum(cg * -l2_normalize(g)))


@pytest.mark.parametrize("dtype,layers,skip",
                         [("float32", 4, 2), ("float32", 8, 4),
                          ("bfloat16", 4, 2), ("bfloat16_all", 8, 4)])
def test_trunk_core_grads_match_jax_grad(dtype, layers, skip):
    """TrunkCore's gradients of a loss touching sigma, feats and the
    normalised normal, against jax.grad through the JAX package's
    fused_trunk_with_grad (its custom VJP, Pallas in interpret mode), for
    every w and b of the trunk and the sigma head."""
    from brdfnerf_tpu.ops.compositing import l2_normalize as jl2
    jcfg, tcfg = model_configs(**dict(SMALL, layers=layers, skips=(skip,),
                                      compute_dtype=dtype))
    params, net = networks(jcfg, tcfg)
    xyz, _ = _inputs(90)
    rng = np.random.RandomState(4)
    cs = rng.normal(size=90).astype(np.float32)
    cf = (rng.normal(size=(90, 64)) * 0.1).astype(np.float32)
    cg = rng.normal(size=(90, 3)).astype(np.float32)

    def jloss(p):
        s, f, g = jk2.fused_trunk_with_grad(p, jcfg, jnp.asarray(xyz))
        return (jnp.sum(cs * s) + jnp.sum(cf * f.astype(jnp.float32))
                + jnp.sum(cg * -jl2(g)))

    v_ref, g_ref = jax.value_and_grad(jloss)(params)
    s, f, g = tk2.fused_trunk_with_grad(net, tcfg, t(xyz))
    v_got = _trunk_loss(s, f, g, t(cs), t(cf), t(cg))
    pars = tk2.trunk_params(net)
    grads = torch.autograd.grad(v_got, pars)
    np.testing.assert_allclose(v_got.item(), float(v_ref), rtol=1e-4,
                               atol=1e-3)
    refs = []
    for layer in list(g_ref["fc_net"]) + [g_ref["sigma_from_xyz"][0]]:
        refs += [layer["w"].T, layer["b"]]
    assert len(grads) == len(refs) == 2 * layers + 2
    for i, (gg, r) in enumerate(zip(grads, refs)):
        assert tuple(gg.shape) == tuple(r.shape), i
        _grad_close(gg, r, dtype, f"param {i}")


@pytest.mark.parametrize("layers,skip", [(4, 2), (8, 4)])
def test_trunk_core_grads_match_port_autograd(layers, skip):
    """TrunkCore against the port's own unfused double-backward autograd
    (models.network with fused_trunk off), f32."""
    from brdfnerf_tpu_torch.ops.compositing import l2_normalize
    jcfg, tcfg = model_configs(**dict(SMALL, layers=layers, skips=(skip,),
                                      compute_dtype="float32"))
    _, net = networks(jcfg, tcfg)
    xyz, _ = _inputs(80)
    cs, cf, cg3 = (t(v) for v in _cotangents(80, 64, seed=8))
    cg = cg3[:, :3]

    def grads_of(fused):
        with torch.enable_grad():
            if fused:
                s, f, g = tk2.fused_trunk_with_grad(net, tcfg, t(xyz))
            else:
                x = t(xyz).requires_grad_(True)
                f = tnet._trunk_features(net, tcfg, x)
                s = tnet._head(net, tcfg, "sigma_from_xyz", f,
                               final="softplus")[..., 0]
                (g,) = torch.autograd.grad(s.sum(), x, create_graph=True)
            loss = (torch.sum(cs * s) + torch.sum(cf * f)
                    + torch.sum(cg * -l2_normalize(g)))
            return torch.autograd.grad(loss, tk2.trunk_params(net))

    for i, (gf, gr) in enumerate(zip(grads_of(True), grads_of(False))):
        scale = max(_scale(gr), 1e-3)
        close(gf, gr, atol=2e-4 * scale, rtol=2e-3, what=f"param {i}")


def test_trunk_core_none_cotangents_are_zeros():
    """Outputs the loss does not touch reach the backward as None and count
    as zero cotangents."""
    _, net = networks(*model_configs(**SMALL))
    tcfg = net.cfg
    xyz, _ = _inputs(50)
    s, f, g = tk2.fused_trunk_with_grad(net, tcfg, t(xyz))
    got = torch.autograd.grad(s.sum(), tk2.trunk_params(net))
    s, f, g = tk2.fused_trunk_with_grad(net, tcfg, t(xyz))
    ref = torch.autograd.grad(s.sum() + 0.0 * f.sum() + 0.0 * g.sum(),
                              tk2.trunk_params(net))
    for a_, b_ in zip(got, ref):
        assert torch.equal(a_, b_)


def test_training_on_cpu_tensors_takes_the_twins(monkeypatch):
    """With gradients on, CPU tensors run K2's and K3's twins and never
    reach the CUDA launch paths."""
    def refuse(*_a, **_k):
        raise AssertionError("the CUDA path ran on a CPU tensor")
    monkeypatch.setattr(tk2, "_trunk_fwd_grad_cuda", refuse)
    monkeypatch.setattr(tk2, "_trunk_bwd_cuda", refuse)
    _, net = networks(*model_configs(**SMALL, compute_dtype="bfloat16_all"))
    tcfg = net.cfg
    xyz, _ = _inputs(70)
    launches = (tk2.TRUNK_FWD_GRAD.launches, tk2.TRUNK_BWD.launches)
    s, f, g = tk2.fused_trunk_with_grad(net, tcfg, t(xyz))
    grads = torch.autograd.grad(s.sum() + f.float().sum() + g.sum(),
                                tk2.trunk_params(net))
    assert all(torch.isfinite(v).all() for v in grads)
    assert (tk2.TRUNK_FWD_GRAD.launches, tk2.TRUNK_BWD.launches) == launches


def test_backward_kernel_refuses_what_it_cannot_run():
    """K3's launch path checks its inputs and raises; K2 refuses to save
    zs/us outside the bfloat16_all contract."""
    _, net = networks(*model_configs(**SMALL, compute_dtype="bfloat16_all"))
    tcfg = net.cfg
    packed = tk1.pack_trunk_weights(net, tcfg, torch.bfloat16)
    x = torch.zeros(64, 128)
    zs = torch.zeros(64, 4 * 512, dtype=torch.bfloat16)
    args = (x, torch.zeros(64), torch.zeros(64, 512, dtype=torch.bfloat16),
            torch.zeros(64, 128), zs, zs)
    with pytest.raises(ValueError):       # CPU tensors, width 64
        tk2._trunk_bwd_cuda(packed, tcfg, *args)
    f512 = dc.replace(tcfg, feat=512, fast_sin=True)
    with pytest.raises(ValueError):       # the inputs lie on the CPU
        tk2.check_bwd_inputs(f512, dict(packed, w0=torch.zeros(
            512, 128, dtype=torch.bfloat16)), *args)
    with pytest.raises(ValueError):       # zs in f32
        tk2.check_bwd_inputs(f512, packed, x, args[1], args[2], args[3],
                             zs.float(), zs)
    with pytest.raises(ValueError):
        tk2._trunk_fwd_grad_cuda(packed, dc.replace(tcfg,
                                                    compute_dtype="bfloat16"),
                                 x, want_zs=True)


# ------------------------------------------ the weight-gradient split plan

@pytest.mark.parametrize("chunks,splits", [(1, 1), (2, 2), (20, 2), (20, 3),
                                           (4096, 11), (4096, 64),
                                           (2048, 5), (7, 7)])
def test_wgrad_slices_cover_every_chunk_once_in_order(chunks, splits):
    """The K slices of the weight-gradient kernel: contiguous, non-empty,
    in order, each chunk in exactly one, lengths within one of each
    other."""
    sl = tk2.wgrad_slices(chunks, splits)
    assert len(sl) == splits
    assert sl[0][0] == 0 and sl[-1][1] == chunks
    assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
    lengths = [c1 - c0 for c0, c1 in sl]
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
    covered = [c for c0, c1 in sl for c in range(c0, c1)]
    assert covered == list(range(chunks))


@pytest.mark.parametrize("layers", [4, 8])
def test_wgrad_tiles_cover_the_weight_grads(layers):
    """One 128 x 256 tile per block of every weight gradient the kernel
    writes: K3's dW_0, dW_mid, dW_skip (top and bottom), K5's dW_f and
    [dW_1r | dW_1p]."""
    f, lane, hid = tk2.FEAT, tk2.LANE, tk2.FEAT // 2
    shapes = ([(lane, f)] + [(f, f)] * (layers - 2) + [(lane, f), (f, f)])
    per = [(m // tk2.WGRAD_M) * (n // tk2.WGRAD_N) for m, n in shapes]
    heads = [(f, f), (f, 4 * hid)]
    per_h = [(m // tk2.WGRAD_M) * (n // tk2.WGRAD_N) for m, n in heads]
    assert tk2.wgrad_tiles(layers) == (sum(per), 0)
    assert tk2.wgrad_tiles(layers, True) == (sum(per), sum(per_h))


@pytest.mark.parametrize("n", [64, 192, 640, 65536, 131072])
@pytest.mark.parametrize("heads", [False, True])
def test_wgrad_splits_plan(n, heads):
    """Every slice holds at least one chunk of 64 points, no other plan of
    the model is faster, and at the training step's 131,072 points the
    plan is the one measured fastest on the H100's 132 SMs (PERF.md)."""
    st, sh = tk2.wgrad_splits(n, 8, heads, 132)
    ct, ch = 2 * n // tk2.WGRAD_CHUNK, n // tk2.WGRAD_CHUNK
    assert 1 <= st <= ct
    assert (1 <= sh <= ch) if heads else sh == 0
    tt, th = tk2.wgrad_tiles(8, heads)
    blocks = tt * st + th * sh
    if n == 131072:
        assert (st, sh) == ((9, 5) if heads else (2, 0)), (st, sh)
    # no other plan of the model is faster
    longest = max(-(-ct // st), -(-ch // sh) if sh else 0)
    cost = -(-blocks // 132) * (longest + tk2.WGRAD_TAIL)
    for s in range(1, min(ct, 64) + 1):
        if not heads:
            alt = -(-(tt * s) // 132) * (-(-ct // s) + tk2.WGRAD_TAIL)
            assert cost <= alt


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 192, 640])
def test_backward_kernels_match_twins_on_the_card(n):
    """K2 with zs/us and K3 against their twins on the card, at the
    flagship width (8 x 512, skip 4) on 1, 3 and 10 tiles of 64 points (no
    multiple of a split or a wave), K3 twice with bit-identical grads;
    chip_smoke.py makes the same check at the training step's shapes.
    K3's grads are sums over points, held by relative L2 error per tensor
    (chip_smoke.py states the measured values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from brdfnerf_tpu_torch.config import ModelConfig
    cfg = ModelConfig(variant="spsbrdf-nerf", siren=True, mapping=True,
                      compute_dtype="bfloat16_all")
    g = torch.Generator(device="cuda").manual_seed(0)
    net = tnet.init_network(cfg, g, device="cuda")
    xyz = torch.rand(n, 3, device="cuda", generator=g) * 2 - 1
    from brdfnerf_tpu_torch.ops.encoding import positional_encoding
    enc = positional_encoding(xyz, 10, fast=True, pad_to=128)
    packed = tk1.pack_trunk_weights(net, cfg, torch.bfloat16)
    out_k = tk2._trunk_fwd_grad_cuda(packed, cfg, enc, want_zs=True)
    out_p = tk2._trunk_fwd_grad_plain(packed, cfg, enc, want_zs=True)
    for k_, p_ in zip(out_k, out_p):
        d = (k_.float() - p_.float()).abs()
        scale = float(p_.float().abs().max())
        assert float(d.max()) <= 5e-2 * scale
        assert float(d.mean()) <= 1e-3 * scale
    cs = torch.randn(n, device="cuda", generator=g)
    cf = (torch.randn(n, 512, device="cuda", generator=g) * 0.1).to(
        torch.bfloat16)
    cg = torch.zeros(n, 128, device="cuda")
    cg[:, :60] = torch.randn(n, 60, device="cuda", generator=g)
    zs, us = out_p[3], out_p[4]
    got = tk2._trunk_bwd_cuda(packed, cfg, enc, cs, cf, cg, zs, us)
    again = tk2._trunk_bwd_cuda(packed, cfg, enc, cs, cf, cg, zs, us)
    ref = tk2._trunk_bwd_plain(packed, cfg, enc, cs, cf, cg, zs, us)
    torch.cuda.synchronize()
    for k_, r_, a_ in zip(got, ref, again):
        assert torch.equal(k_, a_)                    # deterministic
        rel = float((k_ - r_).norm() / r_.norm().clamp_min(1e-12))
        assert rel <= 1e-2, rel


# ------------------------------------- the forward kernels' plan, profile

def test_fwd_plan_scratch_covers_what_the_kernel_addresses():
    """K2's and K4's grid and act'(z) scratch: one block per SM, at most one
    per 64-point tile; each block holds a 64 x 512 f32 slot for every layer
    its reverse chain reads (K2 layers 0..L-2, K4 0..L-1)."""
    tile = tk2.TILE_N * tk2.FEAT
    cases = [(64, 8, False, 132, 1, 7), (192, 8, True, 132, 3, 8),
             (8384, 4, False, 132, 131, 3), (655360, 8, False, 132, 132, 7),
             (131072, 8, True, 132, 132, 8), (131072, 8, False, 114, 114, 7)]
    for n, layers, heads, sms, blocks, slots in cases:
        got = tk2.fwd_plan(n, layers, heads, sms)
        assert got == (blocks, blocks * slots * tile), (n, layers, heads)


def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_groups", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _csrc_kernels():
    """Every instantiation of every __global__ function in csrc/*.cu*, as
    (its profiler name, demangled, its mangled name lowered, its bool
    template arguments, the position of its HEADS argument or None)."""
    import itertools
    import os
    import re
    csrc = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "brdfnerf_tpu_torch", "csrc")
    pat = re.compile(r"(template\s*<([^>]*)>\s*)?__global__\s+void\s+"
                     r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    out = []
    for f in sorted(os.listdir(csrc)):
        if not f.endswith((".cu", ".cuh")):
            continue
        with open(os.path.join(csrc, f)) as fh:
            for m in pat.finditer(fh.read()):
                params = ([p.split()[-1] for p in m.group(2).split(",")]
                          if m.group(1) else [])
                n_bool = m.group(2).count("bool") if m.group(1) else 0
                heads = params.index("HEADS") if "HEADS" in params else None
                name = m.group(3)
                for args in itertools.product((False, True), repeat=n_bool):
                    targs = ", ".join(str(a).lower() for a in args)
                    demangled = (f"void trunk::{name}"
                                 + (f"<{targs}>" if args else "") + "(...)")
                    mangled = (f"_zn5trunk{len(name)}{name}"
                               + ("i" + "".join(f"lb{int(a)}e" for a in args)
                                  + "e" if args else "") + "ev")
                    out.append((demangled, mangled, args, heads))
    return out


_KERNELS = _csrc_kernels()


@pytest.mark.parametrize("demangled,mangled,args,heads", _KERNELS,
                         ids=[k[0] for k in _KERNELS])
def test_profile_groups_place_every_kernel(demangled, mangled, args, heads):
    """chip_smoke.py's profile sums device time by kernel group
    (chip_smoke.GROUPS); every kernel function of csrc/ must land in a
    group of its own kernel, by the profiler's demangled name and by the
    mangled one, never in "other" -- and an instantiation with HEADS (the
    template argument of that name) in K4's or K5's group, without in K2's
    or K3's."""
    cs = _chip_smoke()
    for name in (demangled, mangled):
        group = cs.kernel_group(name)
        assert group != "other", name
        if "trunk_" in name:
            k = group.split()[0]
            assert k in ("K1", "K2", "K3", "K4", "K5"), (name, group)
            if heads is not None:
                assert k in (("K4", "K5") if args[heads] else ("K2", "K3")), \
                    (name, group)


def test_profile_groups_find_the_kernels():
    """The source scan above sees every kernel of the port: K1's <SPLIT>,
    the forward template's <ZS, HEADS, ZF32, SPLIT>, the backward's sweep
    <HEADS, ZF32, SPLIT> and its weight-gradient and reduce kernels
    <HEADS>, K5's b_th chain <ZF32, SPLIT>, the layout check's (every
    combination of the bools, the ones no launch takes included), and the
    layer-major family's product <AK, BKM, FLUSH> (its int EPI not
    enumerated) and its seven epilogue kernels (K4's logits and K5's
    cotangent sums among them)."""
    names = {k[0].split("(")[0] for k in _KERNELS}
    assert {"void trunk::trunk_sigma_kernel<true>",
            "void trunk::trunk_fwd_grad_kernel<false, false, false, false>",
            "void trunk::trunk_fwd_grad_kernel<true, true, true, false>",
            "void trunk::trunk_fwd_grad_kernel<true, false, true, true>",
            "void trunk::trunk_fwd_grad_kernel<true, true, true, true>",
            "void trunk::trunk_bwd_sweep_kernel<true, true, false>",
            "void trunk::trunk_bwd_sweep_kernel<false, true, true>",
            "void trunk::trunk_bwd_sweep_kernel<true, true, true>",
            "void trunk::trunk_bwd_wgrad_kernel<false>",
            "void trunk::trunk_bwd_reduce_kernel<true>",
            "void trunk::trunk_heads_uchain_kernel<true, true>",
            "void trunk::sm90_check_kernel",
            "void trunk::layers_product_kernel<true, false, true>",
            "void trunk::layers_split_kernel",
            "void trunk::layers_colsum_kernel",
            "void trunk::layers_sigma_finish",
            "void trunk::layers_k2_seed",
            "void trunk::layers_k3_head",
            "void trunk::layers_heads_finish",
            "void trunk::layers_tile_rows"} <= names, names
    assert len(names) == 2 + 16 + 8 + 2 + 2 + 4 + 1 + 8 + 7
