"""K4/K5, the trunk + flagship heads pair, at the shapes the fused pair does
not take: a trunk width under 512 outside 64/128/256/512 (the fused pair
at the next one, zero-padded: width 96 at 128), a width past 512 (the
layer-major pair, ops/trunk_layers.py: 4 x 640) and an encoding over 128
lanes (the layer-major pair at any width: 22 frequencies, 132 lanes, at
4 x 128).

On the CPU the port's dispatch (fused_trunk_heads._run_fwd_h / _run_bwd_h
at fused_mlp.kernel_cfg's width, and TrunkHeadsCore through
fused_trunk_heads_with_grad) runs the plain twins on the zero-padded
packing the kernels take; here it is held against the JAX package's
Pallas _fwd_kernel_h / _bwd_kernel_h in interpret mode at the logical
shape, on numpy-seeded weights (the JAX init carried through the npz
layout) and inputs, at tests/test_torch_port_heads_widths.py's
tolerances: float32 3e-5 for the packed logits and 3e-4 of its scale for
gx and zs, the weight gradients by _grad_close; bfloat16_all
close_but_flips, the sigma head's bias gradient at 3e-3 of its terms' L2
norm (tools/f32_check.dbsig_scale).  The zero-padded packing against the
unpadded twins: 1e-6 relative L2, and every padded gradient entry exactly
0.  fused_trunk_heads_with_grad against the JAX package's, values and
parameter gradients at rtol 5e-4 (tests/test_torch_port_layers.py's
float32 bounds).  The kernels themselves are held to their twins on the
card by tools/width_check.py (check_layers) and chip_smoke.py (the
cuda-marked test below).
"""

import dataclasses as dc
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu.ops import pallas_mlp as jk1, pallas_trunk_heads as jh

from brdfnerf_tpu_torch.ops import fused_mlp as tk1
from brdfnerf_tpu_torch.ops import fused_trunk_heads as th
from brdfnerf_tpu_torch.ops import trunk_layers as tl
from brdfnerf_tpu_torch.tools.f32_check import dbsig_scale

from test_torch_port_heads import K5_NAMES
from test_torch_port_kernels import _grad_close, _j2t, _scale, close_but_flips
from torch_port_common import (FLAGSHIP_HEADS, a, close, model_configs,
                               networks, t)

# (width, layers, skip, encoding frequencies): the padded width, the wide
# shape, a 132-lane encoding
SHAPES = [(96, 4, 2, 10), (640, 4, 2, 10), (128, 4, 2, 22)]
IDS = ["96", "4x640", "132lanes"]
N = 100
GRAD_RTOL = 5e-4
# bfloat16_all: both sides round the same operands to bf16 and differ by
# the rounding flips of two summation orders, whose count grows with the
# width: at 4 x 640 the twin's and the Pallas kernel's gx each sat 1.77e-3
# of its scale (mean, the real lanes) from the float32 twin and 3.9e-5
# (mean, all lanes) from each other, past close_but_flips' 3e-5, set at
# widths up to FLIP_WIDTH (tests/test_torch_port_heads_widths.py); past it
# the per-point outputs' mean bound scales by F / FLIP_WIDTH, and the twin
# is held no further from the float32 twin than the Pallas kernel is
FLIP_WIDTH = 256
# the zero-padded packing against the unpadded twins, float32: only the
# summation order of the longer K differs (at 600 against 640 the K5
# twin's trunk gradients sat 0.7e-6 to 1.06e-6 apart, relative L2)
PAD_REL = 2e-6


def _configs(feat, layers, skip, freqs, dtype="float32"):
    return model_configs(variant="spsbrdf-nerf", siren=True, mapping=True,
                         layers=layers, feat=feat, skips=(skip,),
                         mapping_sizes=(freqs, 4), compute_dtype=dtype,
                         **FLAGSHIP_HEADS)


def _enc(n, freqs, seed=1):
    from brdfnerf_tpu.ops.encoding import positional_encoding as jpe
    xyz = np.random.RandomState(seed).uniform(-1, 1, (n, 3)).astype(
        np.float32)
    return xyz, jpe(jnp.asarray(xyz), freqs, fast=True)


def _cotangents(n, lanes, seed=6):
    """(n, 8) logit cotangents with column 7 zero, and (n, lanes) c_g with
    the encoding's padded lanes zero."""
    rng = np.random.RandomState(seed)
    cot = rng.normal(size=(n, 8)).astype(np.float32)
    cot[:, 7] = 0.0
    return cot, rng.normal(size=(n, lanes)).astype(np.float32)


def _kernel_packs(net, tcfg):
    """(kernel configuration, the trunk and the heads packed at its
    width, the packing the kernels take)."""
    kcfg = tk1.kernel_cfg(tcfg)
    wd = tk1.weight_dtype(tcfg)
    return (kcfg, tk1.pack_trunk_weights(net, kcfg, wd),
            th.pack_head_weights(net, kcfg, wd))


def _pad_layers(z, layers, fp):
    """(n, L F) -> (n, L Fp): each layer's block padded with zeros."""
    n = z.shape[0]
    out = torch.zeros(n, layers, fp, dtype=z.dtype)
    out[:, :, :z.shape[1] // layers] = z.reshape(n, layers, -1)
    return out.reshape(n, layers * fp)


def _logical_index(name, shape, feat, hp):
    """The logical entries of K5's output `name` (of `shape`) at a kernel
    width, as np.ix_ index arrays: the trunk's rows and columns up to
    `feat`, each head's first HID = feat / 2 hidden units in its hp-wide
    block, the second layers' 3 logit columns."""
    h = feat // 2
    f = np.arange(feat)
    blocks = np.concatenate([np.arange(i * hp, i * hp + h)
                             for i in range(3)])
    idx = {"dw0": (None, f), "db0": (f,), "dwm": (None, f, f),
           "dbm": (None, f), "dwst": (None, f), "dwsb": (f, f), "dbs": (f,),
           "dwsig": (f,), "dbsig": (None,), "dwf": (f, f), "dbf": (f,),
           "dw1r": (f, np.arange(h)), "db1r": (np.arange(h),),
           "dw2r": (np.arange(h), np.arange(3)), "db2r": (np.arange(3),),
           "dw1p": (f, blocks), "db1p": (blocks,),
           "dw2p": (blocks, np.arange(3)), "db2p": (np.arange(3),)}[name]
    return np.ix_(*[np.arange(n) if i is None else i
                    for n, i in zip(shape, idx)])


def _logical_k5(got, feat, hp):
    """K5's 19 outputs at a kernel width -> the logical shape
    (_logical_index's entries; the padded second layers' LANE columns of
    dw2r, db2r, dw2p and db2p kept, as the Pallas kernel returns them)."""
    out = []
    for name, g in zip(K5_NAMES, got):
        idx = list(_logical_index(name, g.shape, feat, hp))
        if name in ("dw2r", "dw2p", "db2r", "db2p"):
            idx[-1] = np.arange(g.shape[-1]).reshape(idx[-1].shape[:-1]
                                                     + (-1,))
        out.append(g[tuple(idx)])
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16_all"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_k4_k5_twins_at_kernel_packing_match_pallas(shape, dtype):
    """K4's twin (logits, gx, zs) through _run_fwd_h at the kernel width,
    sliced to the model's, against pallas_trunk_heads._run_fwd_h
    (interpret mode) at the logical shape; K5's twin through _run_bwd_h on
    the JAX forward's zs (zero-padded to the kernel width) and the same
    cotangents, every output sliced to the logical shape, against
    _run_bwd_h."""
    feat, layers, skip, freqs = shape
    jcfg, tcfg = _configs(feat, layers, skip, freqs, dtype)
    params, net = networks(jcfg, tcfg)
    _, enc = _enc(N, freqs)
    od = jnp.bfloat16 if dtype != "float32" else jnp.float32
    jp = jk1.pack_trunk_weights(params, jcfg, od)
    jhw = jh.pack_head_weights(params, jcfg, od)
    kcfg, tp, thw = _kernel_packs(net, tcfg)
    fp = kcfg.feat
    assert fp > feat or tk1.layer_major(kcfg)
    ein_p = -(-6 * freqs // 128) * 128
    out_r, gx_r, zs_r = jh._run_fwd_h(jcfg, jp, jhw, enc, interpret=True,
                                      want_zs=True)
    out, gx, zs = th._run_fwd_h(kcfg, tp, thw, t(enc), want_zs=True)
    assert tuple(out.shape) == (N, 8) and float(out[:, 7].abs().max()) == 0
    assert tuple(gx.shape) == (N, ein_p) == tuple(gx_r.shape)
    assert float(gx[:, 6 * freqs:].abs().max()) == 0.0
    rows = tk1.row_tile(kcfg)
    assert tuple(zs.shape) == (-(-N // rows) * rows, layers * fp)
    zl = zs[:N].reshape(N, layers, fp)
    if fp > feat:
        assert float(zl[:, :, feat:].abs().max()) == 0.0
    zl = zl[:, :, :feat].reshape(N, layers * feat)
    if dtype == "float32":
        close(out, out_r, atol=3e-5, rtol=3e-5, what="out")
        close(gx, gx_r, atol=3e-4 * _scale(gx_r), what="gx")
        close(zl, zs_r[:N], atol=3e-4 * _scale(zs_r), rtol=3e-5, what="zs")
    else:
        for name, g, r in (("out", out, out_r), ("gx", gx, gx_r),
                           ("zs", zl, zs_r[:N])):
            close_but_flips(g, r, name,
                            mean_rel=3e-5 * max(1.0, feat / FLIP_WIDTH))
        # the exact arithmetic: the float32 twin on the same weights
        c32 = dc.replace(kcfg, compute_dtype="float32")
        o32, g32 = th._run_fwd_h(
            c32, tk1.pack_trunk_weights(net, c32, torch.float32),
            th.pack_head_weights(net, c32, torch.float32), t(enc))
        for name, g, r, e in (("out", out, out_r, o32),
                              ("gx", gx, gx_r, g32)):
            mine = float((g - e).abs().mean())
            theirs = float(np.abs(a(r) - a(e)).mean())
            assert mine <= 1.02 * theirs, (name, mine, theirs)
    cot, cg = _cotangents(N, ein_p)
    cg[:, 6 * freqs:] = 0.0
    ref = list(jh._run_bwd_h(jcfg, jp, jhw, enc, jnp.asarray(cot),
                             jnp.asarray(cg), zs_r, interpret=True))
    ref[7], ref[8] = ref[7][:, 0], ref[8][:1]
    sd = torch.bfloat16 if dtype == "bfloat16_all" else None
    zs_t = _pad_layers(_j2t(zs_r, sd), layers, fp)
    got = th._run_bwd_h(kcfg, tp, thw, t(enc), t(cot), t(cg), zs_t)
    got = _logical_k5(got, feat, fp // 2)
    assert len(got) == len(ref) == len(K5_NAMES)
    for name, g, r in zip(K5_NAMES, got, ref):
        assert tuple(g.shape) == tuple(r.shape), name
        if name == "dbsig" and dtype != "float32":
            n_p = zs_t.shape[0]
            terms = dbsig_scale(tp, kcfg, tk1.pad_rows_lanes(
                t(cot)[:, :1], n_p, 1)[:, 0], tk1.pad_rows_lanes(
                    t(cg), n_p, ein_p), zs_t)
            assert abs(float(g[0]) - float(r[0])) <= 3e-3 * terms, (
                float(g[0]), float(r[0]), terms)
            continue
        _grad_close(g, r, dtype, name)


def _rel(got, ref):
    ref = ref.double()
    return float((got.double() - ref).norm() / ref.norm().clamp_min(1e-30))


@pytest.mark.parametrize("feat", [96, 600])
def test_padded_head_packing_matches_unpadded(feat):
    """The heads packed at kernel_cfg's width (96 at 128, the fused pair;
    600 at 640, the layer-major pair) hold each head's hidden units at the
    start of its HID_p-wide block with zeros around them (w1 = [w1r;
    w1p], w2r, w2p; the layer-major pair's w2 over the merged blocks), and
    give the unpadded twins' logits, gx, zs and logical gradients to 1e-6
    relative L2 (the logits, gx and zs; the gradients at PAD_REL), float32,
    with every padded gradient entry exactly 0."""
    _, cfg = _configs(feat, 4, 2, 10)
    from brdfnerf_tpu_torch.models.network import init_network
    net = init_network(cfg, torch.Generator().manual_seed(3), device="cpu")
    kcfg, pp, hwp = _kernel_packs(net, cfg)
    fp, hp, h = kcfg.feat, kcfg.feat // 2, feat // 2
    assert fp > feat and tk1.layer_major(kcfg) == (feat > 512)
    pu = tk1.pack_trunk_weights(net, cfg, torch.float32)
    hwu = th.pack_head_weights(net, cfg, torch.float32)
    # the blocks: head i's hidden units at rows [i HID_p, i HID_p + HID)
    w1 = hwp["w1"]
    assert tuple(w1.shape) == (4 * hp, fp)
    assert hwp["w1r"].data_ptr() == w1.data_ptr()
    assert hwp["w1p"].data_ptr() == w1[hp:].data_ptr()
    names = ("rgb_from_xyzdir",) + th.RPV_NAMES
    for i, name in enumerate(names):
        blk = w1[i * hp:(i + 1) * hp]
        assert torch.equal(blk[:h, :feat], net[name][0].w.detach())
        assert float(blk[h:].abs().max()) == 0.0
        assert float(blk[:, feat:].abs().max()) == 0.0
        assert torch.equal(hwp["b1"][i * hp:i * hp + h],
                           net[name][0].b.detach())
        assert float(hwp["b1"][i * hp + h:(i + 1) * hp].abs().max()) == 0.0
    assert torch.equal(hwp["w2r"][:3, :h], net["rgb_from_xyzdir"][1].w)
    assert float(hwp["w2r"][:, h:].abs().max()) == 0.0
    for i, name in enumerate(th.RPV_NAMES):
        row = hwp["w2p"][i]
        assert torch.equal(row[i * hp:i * hp + h], net[name][1].w[0])
        row = row.clone()
        row[i * hp:i * hp + h] = 0.0
        assert float(row.abs().max()) == 0.0
    if tk1.layer_major(kcfg):
        assert torch.equal(hwp["w2"][:3, :hp], hwp["w2r"][:3])
        assert torch.equal(hwp["w2"][3:, hp:], hwp["w2p"][:3])
        assert float(hwp["w2"][:3, hp:].abs().max()) == 0.0
        assert float(hwp["w2"][3:, :hp].abs().max()) == 0.0
    _, enc = _enc(256, 10, seed=2)
    x = t(enc)
    op = th._run_fwd_h(kcfg, pp, hwp, x, want_zs=True)
    ou = th._run_fwd_h(cfg, pu, hwu, x, want_zs=True)
    assert _rel(op[0], ou[0]) <= 1e-6 and _rel(op[1], ou[1]) <= 1e-6
    n_p = op[2].shape[0]
    zp = op[2].reshape(n_p, 4, fp)
    assert float(zp[:, :, feat:].abs().max()) == 0.0
    assert _rel(zp[:256, :, :feat], ou[2][:256].reshape(256, 4, feat)) <= 1e-6
    cot, cg = _cotangents(256, 128)
    cg[:, 60:] = 0.0
    gp = th._run_bwd_h(kcfg, pp, hwp, x, t(cot), t(cg), op[2])
    gu = th._run_bwd_h(cfg, pu, hwu, x, t(cot), t(cg), ou[2])
    logical = _logical_k5(gp, feat, hp)
    terms = dbsig_scale(pu, cfg, t(cot)[:, 0], t(cg), ou[2][:256])
    for name, g, r in zip(K5_NAMES, logical, gu):
        if name == "dbsig":
            assert float((g - r).abs().max()) <= 1e-6 * terms, name
        else:
            assert _rel(g, r) <= PAD_REL, name
    # every padded entry exactly 0: the logical entries zeroed, nothing left
    for name, g in zip(K5_NAMES, gp):
        pad = g.clone()
        pad[_logical_index(name, g.shape, feat, hp)] = 0.0
        assert float(pad.abs().max()) == 0.0, name
    # TrunkHeadsCore's grads are the unpadded ones, at the model's shapes
    grads = th._unpack_head_grads(cfg, gp[9:])
    assert [tuple(v.shape) for v in grads] == [
        tuple(p.shape) for p in th.head_params(net)]


@pytest.mark.parametrize("feat", [96, 640])
def test_fused_trunk_heads_with_grad_matches_jax(feat, monkeypatch):
    """fused_trunk_heads_with_grad (TrunkHeadsCore: K4's twin saving zs,
    K5's in the backward, at the kernel width) under a loss on every
    output, against jax.value_and_grad through the JAX package's
    fused_trunk_heads_with_grad (its custom VJP, Pallas in interpret mode),
    the value and every w and b of the trunk and the heads, float32, at
    rtol 5e-4."""
    from brdfnerf_tpu.ops.compositing import l2_normalize as jl2  # noqa
    jcfg, tcfg = _configs(feat, 4, 2, 10)
    params, net = networks(jcfg, tcfg)
    xyz, _ = _enc(48, 10)
    rng = np.random.RandomState(4)
    keys = ("sigma", "rgb", "rpv_k", "rpv_theta", "rpv_rhoc", "normal_an")
    cots = {k: rng.normal(size=(48,) if k == "sigma" else (48, 3)).astype(
        np.float32) for k in keys}

    def jloss(p):
        out = jh.fused_trunk_heads_with_grad(p, jcfg, jnp.asarray(xyz))
        return sum(jnp.sum(jnp.asarray(c) * out[k]) for k, c in cots.items())

    v_ref, g_ref = jax.value_and_grad(jloss)(params)
    out = th.fused_trunk_heads_with_grad(net, tcfg, t(xyz))
    v_got = sum(torch.sum(t(c) * out[k].float()) for k, c in cots.items())
    pars = dict(net.named_parameters())
    names = [n for n in pars if n.split(".")[0] in
             ("fc_net", "sigma_from_xyz") + th.HEAD_NAMES]
    grads = torch.autograd.grad(v_got, [pars[n] for n in names])
    np.testing.assert_allclose(v_got.item(), float(v_ref), rtol=GRAD_RTOL)
    assert len(names) == 2 * (4 + 1 + 1 + 2 + 6)
    for name, g in zip(names, grads):
        head, i, wb = name.split(".")
        r = a(g_ref[head][int(i)][wb])
        g = g.t() if wb == "w" else g
        assert tuple(g.shape) == tuple(r.shape), name
        close(g, r, atol=GRAD_RTOL * _scale(r), rtol=GRAD_RTOL, what=name)


# ------------------------------------------ gates, blocks, argument slots

@pytest.mark.parametrize("feat", [32, 96, 192, 384, 640, 768, 1024, 2048])
def test_heads_cover_where_the_trunk_kernels_do(feat):
    """cuda_kernels_cover, the one gate of K1-K5, holds at every width and
    encoding of tests/test_torch_port_layers.py's grid (every kernel dtype
    and activation) and refuses int8, and the heads' packing follows
    kernel_cfg's family: the fused pair's planes, or the layer-major
    pair's merged W_1 and W_2."""
    for freqs in (10, 21, 22, 42):
        for dtype in tk1.CUDA_DTYPES:
            for kw in (dict(siren=True, fast_sin=True),
                       dict(siren=True, fast_sin=False), dict(siren=False)):
                _, cfg = model_configs(
                    variant="spsbrdf-nerf", mapping=True, layers=8,
                    feat=feat, skips=(4,), mapping_sizes=(freqs, 4),
                    compute_dtype=dtype, **kw)
                assert tk1.cuda_kernels_cover(cfg)
                kc = tk1.kernel_cfg(cfg)
                assert th.head_plane_keys(kc) == (
                    th.LAYER_HEAD_PLANE_KEYS if tk1.layer_major(kc)
                    else th.HEAD_PLANE_KEYS)
    _, cfg = model_configs(variant="spsbrdf-nerf", mapping=True, layers=8,
                           feat=feat, skips=(4,), compute_dtype="int8")
    assert not tk1.cuda_kernels_cover(cfg)


def test_heads_point_blocks_fit_the_budget():
    """point_block keeps K4's and K5's scratch within BUDGET at the 12 x
    2048 trunk's main shapes (K4 serving a 655,360-point chunk, K4 saving
    zs and K5 at a 131,072-point step) at every dtype, in blocks of
    multiples of ROWS; K5's scratch holds K3's with the last layer's h, the
    rebuilt b_th chain in f32 and the heads' operands."""
    _, cfg = _configs(2048, 12, 4, 10, "bfloat16_all")
    kc = tk1.kernel_cfg(cfg)
    for kind, n in (("K4", 655360), ("K4", 131072), ("K5", 131072)):
        for dtype in tk1.CUDA_DTYPES:
            c = dc.replace(kc, compute_dtype=dtype)
            b = tl.point_block(kind, c, 128, n)
            assert b % tl.ROWS == 0 and 0 < b <= n, (kind, dtype, b)
            assert tl.scratch_bytes(kind, c, 128, b) <= tl.BUDGET
            if b < n:
                assert tl.scratch_bytes(kind, c, 128, b + tl.ROWS) > \
                    tl.BUDGET * 0.99, (kind, dtype, b)
    # K5 keeps every layer's b_th in f32 besides K3's state: more a point
    for dtype in tk1.CUDA_DTYPES:
        c = dc.replace(kc, compute_dtype=dtype)
        per = {k: tl.scratch_bytes(k, c, 128, 2 * tl.ROWS)
               - tl.scratch_bytes(k, c, 128, tl.ROWS) for k in ("K3", "K5")}
        assert per["K5"] - per["K3"] >= tl.ROWS * 12 * 2048 * 4
    s5 = tl.scratch_shapes("K5", kc, 128, 1024)
    assert s5["uc"] == ((1024, 12 * 2048), torch.float32)
    assert s5["hs"][0][0] == 12 and s5["cz1"][0][2] == 2 * 2048
    assert tl.scratch_shapes("K4", kc, 128, 1024)["hpart"][0] == (
        tl.LOGITS, 2 * 2048 // tl.ROWS, 1024)


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "dropped"])
def test_point_blocks_read_their_fault_side(fault, monkeypatch, capsys):
    """tools/width_check.point_blocks with the twins in the wrappers'
    place (its arithmetic on the CPU, 4 x 640 float32, 3 point blocks): a
    sound walk leaves no miss, and the walk that drops the last block,
    which it reads beside, sits over BLOCK_BOUND; a K5 that drops the last
    block of the points it is given is a miss."""
    from brdfnerf_tpu_torch.models.network import init_network
    from brdfnerf_tpu_torch.ops.encoding import positional_encoding
    from brdfnerf_tpu_torch.tools import width_check
    _, cfg = _configs(640, 4, 2, 10)
    net = init_network(cfg, torch.Generator().manual_seed(0), device="cpu")
    kcfg, packed, hw = _kernel_packs(net, cfg)
    n = 3 * tl.ROWS
    xyz, _ = _enc(n, 10)
    enc = positional_encoding(t(xyz), 10, fast=True, pad_to=tk1.LANE)
    cot, cg = (t(v) for v in _cotangents(n, tk1.LANE))
    cg[:, kcfg.xyz_in_dim:] = 0.0
    fwd = th._trunk_heads_fwd_plain(packed, hw, kcfg, enc, True)
    bwd = th._trunk_heads_bwd_plain(packed, hw, kcfg, enc, cot, cg, fwd[2])

    def k5(packed_, hw_, cfg_, x, cot_, cg_, zs, scratch_out=None):
        keep = slice(0, x.shape[0] - (tl.ROWS if fault else 0))
        return th._trunk_heads_bwd_plain(packed_, hw_, cfg_, x[keep],
                                         cot_[keep], cg_[keep], zs[keep])
    monkeypatch.setattr(th, "_trunk_heads_fwd_cuda",
                        th._trunk_heads_fwd_plain)
    monkeypatch.setattr(th, "_trunk_heads_bwd_cuda", k5)
    before = len(width_check.MISSES)
    try:
        width_check.point_blocks("4 x 640", packed, hw, kcfg, enc, cot, cg,
                                 fwd, bwd)
        misses = width_check.MISSES[before:]
    finally:
        del width_check.MISSES[before:]
    bound = width_check.BLOCK_BOUND * width_check.sum_length_scale(640)
    line = capsys.readouterr().out
    assert "3 point blocks: K4 bit for bit" in line, line
    dropped = float(re.search(r"last block dropped ([0-9.e+-]+)",
                              line).group(1))
    assert dropped > 100 * bound, line
    if fault:
        assert len(misses) == 1 and "point blocks" in misses[0], misses
    else:
        assert not misses, misses


def test_heads_argument_slots_match_the_source():
    """The entry points K4 and K5 take (tl_fwd_grad_heads, tl_bwd_heads)
    are in csrc/trunk_layers.cu, and the pointer slots they read (the
    cotangents, the packed logits, the heads' weights and gradients and
    their scratch) follow its enum in PTRS' order; every scratch buffer
    of K4 and K5 has its slot."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "brdfnerf_tpu_torch", "csrc",
        "trunk_layers.cu")
    with open(path) as fh:
        src = fh.read()
    for sym in ("tl_fwd_grad_heads", "tl_bwd_heads"):
        assert re.search(rf"int {sym}\(const long long\* P, const int\* D, "
                         r"void\* stream\)", src), sym
    assert (tl.TRUNK_HEADS_FWD_WIDE.symbol,
            tl.TRUNK_HEADS_BWD_WIDE.symbol) == ("tl_fwd_grad_heads",
                                                "tl_bwd_heads")
    enums = re.findall(r"enum\s*\{([^}]*)\}", src)
    ptrs = [e.strip() for e in enums[1].split(",") if e.strip()]
    assert ptrs[-1] == "N_PTR"
    slots = [c[2:].lower() for c in ptrs[:-1]]
    assert slots == list(tl.PTRS)
    new = ("cot", "out", "wf", "wf_lo", "bf", "w1", "w1_lo", "b1", "w2",
           "b2", "dwf", "dbf", "dw1", "dbw2", "db2", "hpart", "xf", "axf",
           "cz1", "cfh", "uc", "hcp", "b2p")
    assert tuple(tl.PTRS[-len(new):]) == new
    _, cfg = _configs(2048, 12, 4, 10, "float32")
    for kind in ("K4", "K5"):
        assert set(tl.scratch_shapes(kind, cfg, 128, 256)) <= set(tl.PTRS)
    assert re.search(r"constexpr int LOGITS = 6;", src) and tl.LOGITS == 6


def test_layer_major_heads_wrappers_refuse_what_they_cannot_run():
    """A CPU tensor, heads packed at another width, or a layer-major
    packing without the merged first layers raise ValueError in the
    layer-major K4/K5 wrappers (never a fallback to a twin); the dispatch
    sends a layer-major kernel configuration to them."""
    _, cfg = _configs(640, 4, 2, 10, "bfloat16_all")
    from brdfnerf_tpu_torch.models.network import init_network
    net = init_network(cfg, torch.Generator().manual_seed(0), device="cpu")
    kcfg, packed, hw = _kernel_packs(net, cfg)
    assert tk1.layer_major(kcfg) and "w2" in hw
    x = torch.zeros(128, 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tl.layers_fwd_grad_heads(packed, hw, kcfg, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        th._trunk_heads_fwd_cuda(packed, hw, kcfg, x, True)
    zs = torch.zeros(128, 4 * 640, dtype=torch.bfloat16)
    cot, cg = torch.zeros(128, 8), torch.zeros(128, 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        th._trunk_heads_bwd_cuda(packed, hw, kcfg, x, cot, cg, zs)
    wider = th.pack_head_weights(net, dc.replace(kcfg, feat=768),
                                 torch.bfloat16)
    with pytest.raises(ValueError, match="packed head"):
        th.check_head_weights(kcfg, wider, x)
    no_w2 = {k: v for k, v in hw.items() if k != "w2"}
    with pytest.raises(ValueError, match="packed head w2 is missing"):
        th.check_head_weights(kcfg, no_w2, x)


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_layer_heads_kernels_match_twins_on_the_card():
    """The layer-major K4 (serving and saving zs) and K5 at every dtype
    (12 x 2048 on 384 points; 4 x 768 at the exact sine and ReLU; 4 x 128
    and 8 x 128 with 144 lanes) and the zero-padded fused pair at width 96
    against their twins on the card, twice bit-identical, K4's sigma and
    gx bit for bit K2's, K5's rebuilt b_th chain against uchain_plain
    (tools/width_check.check_layers, the bounds of the width-512 rows
    times sum_length_scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from brdfnerf_tpu_torch.tools import act_check, width_check
    torch.backends.cuda.matmul.allow_tf32 = False
    del act_check.MISSES[:]
    report = width_check.check_layers((384,))
    assert not act_check.MISSES, act_check.MISSES
    assert any(k.startswith("K5") for k in report), sorted(report)
