"""K1-K3 at the shapes the fused CUDA kernels do not take: a trunk width
past 512 (the layer-major family, ops/trunk_layers.py), a width under 512
outside 64/128/256/512 (the fused family at the next one, zero-padded),
and an encoding over 128 lanes (the layer-major family at any width).

On the CPU the port's dispatch (fused_mlp.fused_trunk_sigma,
fused_trunk_vjp._run_fwd / _run_bwd at fused_mlp.kernel_cfg's width, and
TrunkCore through fused_trunk_with_grad) runs the plain twins on the
zero-padded packing the kernels take; here it is held against the JAX
package's Pallas kernels in interpret mode on numpy-seeded weights (the
JAX init carried through the npz layout) and inputs, at 4 x 640 (skip 2),
at widths 96 and 192, and with a 144-lane encoding (24 frequencies) at
4 x 128.  Tolerances (ROADMAP.md): the float32 forward (sigma, feats) at
1e-5 of the reference's scale; gradients (gx, us, the weight gradients)
at rtol 5e-4 with atol 5e-4 of each tensor's scale.  The zero-padded
packing against the unpadded twin: 1e-6 relative L2 (only the summation
order of a longer K differs), and every padded gradient entry exactly 0.
The kernels themselves are held to their twins on the card by
tools/width_check.py (check_layers) and chip_smoke.py (the cuda-marked
test below).
"""

import dataclasses as dc
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu.ops.encoding import positional_encoding as jpe
from brdfnerf_tpu.ops import pallas_mlp as jk1, pallas_trunk_vjp as jk2

from brdfnerf_tpu_torch.ops import fused_mlp as tk1
from brdfnerf_tpu_torch.ops import fused_trunk_heads as th
from brdfnerf_tpu_torch.ops import fused_trunk_vjp as tk2
from brdfnerf_tpu_torch.ops import trunk_layers as tl

from torch_port_common import a, close, model_configs, networks, t

# (width, layers, skip, encoding frequencies): the wide shape, the padded
# widths, a 144-lane encoding
SHAPES = [(640, 4, 2, 10), (96, 4, 2, 10), (192, 4, 2, 10),
          (128, 4, 2, 24)]
IDS = ["4x640", "96", "192", "144lanes"]
FWD_TOL = 1e-5
GRAD_RTOL = 5e-4
K3_NAMES = ("dw0", "db0", "dwm", "dbm", "dwst", "dwsb", "dbs", "dwsig",
            "dbsig")


def _configs(feat, layers, skip, freqs, dtype="float32"):
    return model_configs(variant="spsbrdf-nerf", siren=True, mapping=True,
                         layers=layers, feat=feat, skips=(skip,),
                         mapping_sizes=(freqs, 4), compute_dtype=dtype)


def _enc(n, freqs, seed=1):
    xyz = np.random.RandomState(seed).uniform(-1, 1, (n, 3)).astype(
        np.float32)
    return xyz, jpe(jnp.asarray(xyz), freqs, fast=True)


def _scale(ref):
    return max(float(np.max(np.abs(a(ref)))), 1e-6)


def _fwd_close(got, ref, what):
    close(got, ref, atol=FWD_TOL * _scale(ref), rtol=FWD_TOL, what=what)


def _grad_close(got, ref, what):
    close(got, ref, atol=GRAD_RTOL * _scale(ref), rtol=GRAD_RTOL, what=what)


def _kernel_pack(net, tcfg):
    """(kernel configuration, the packing the kernels take)."""
    kcfg = tk1.kernel_cfg(tcfg)
    return kcfg, tk1.pack_trunk_weights(net, kcfg, tk1.weight_dtype(tcfg))


def _layers(z, layers, f):
    """(n, L Fp) -> (n, L, f): each layer's logical columns."""
    return z.float().reshape(z.shape[0], layers, -1)[:, :, :f]


def _pad_layers(z, layers, fp):
    """(n, L F) -> (n, L Fp): each layer's block padded with zeros."""
    n = z.shape[0]
    out = torch.zeros(n, layers, fp, dtype=z.dtype)
    out[:, :, :z.shape[1] // layers] = z.reshape(n, layers, -1)
    return out.reshape(n, layers * fp)


@pytest.mark.parametrize("shape,dtype", [(s, "float32") for s in SHAPES]
                         + [(SHAPES[0], "bfloat16_all")],
                         ids=IDS + ["4x640-bfloat16_all"])
def test_k1_matches_pallas(shape, dtype):
    """K1 (sigma and feats) through fused_trunk_sigma at the kernel width
    against pallas_mlp.fused_trunk_sigma (interpret mode): both multiply
    f32 activations by the dtype's weights in f32, so the f32 bound holds
    at every dtype."""
    feat, layers, skip, freqs = shape
    jcfg, tcfg = _configs(feat, layers, skip, freqs, dtype)
    params, net = networks(jcfg, tcfg)
    _, enc = _enc(200, freqs)
    s_ref, f_ref = jk1.fused_trunk_sigma(params, jcfg, enc, interpret=True)
    s_got, f_got = tk1.fused_trunk_sigma(net, tcfg, t(enc))
    assert tuple(f_got.shape) == (200, feat)
    _fwd_close(s_got, s_ref, "sigma")
    _fwd_close(f_got, f_ref, "feats")


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_k2_matches_pallas(shape):
    """K2 (sigma, feats, gx, zs, us) through _run_fwd at the kernel width,
    sliced to the model's, against pallas_trunk_vjp._run_fwd (interpret
    mode), float32."""
    feat, layers, skip, freqs = shape
    jcfg, tcfg = _configs(feat, layers, skip, freqs)
    params, net = networks(jcfg, tcfg)
    _, enc = _enc(200, freqs)
    packed = jk1.pack_trunk_weights(params, jcfg, jnp.float32)
    ref = jk2._run_fwd(jcfg, packed, enc, interpret=True, want_zs=True)
    kcfg, tpacked = _kernel_pack(net, tcfg)
    got = tk2._run_fwd(kcfg, tpacked, t(enc), want_zs=True)
    ein_p = -(-6 * freqs // 128) * 128
    assert tuple(got[2].shape) == (200, ein_p) == ref[2].shape
    assert float(got[2][:, 6 * freqs:].abs().max()) == 0.0
    _fwd_close(got[0], ref[0], "sigma")
    _fwd_close(got[1][:, :feat], ref[1], "feats")
    _grad_close(got[2], ref[2], "gx")
    for name, g, r in zip(("zs", "us"), got[3:], ref[3:]):
        g = _layers(g[:200], layers, feat)
        r = t(r)[:200].reshape(200, layers, feat)
        (_fwd_close if name == "zs" else _grad_close)(g, r, name)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_k3_matches_pallas(shape):
    """K3 through _run_bwd at the kernel width (the JAX forward's zs/us
    and the cotangents zero-padded to it), sliced to the model's, against
    pallas_trunk_vjp._run_bwd (interpret mode) on the same inputs,
    float32."""
    feat, layers, skip, freqs = shape
    jcfg, tcfg = _configs(feat, layers, skip, freqs)
    params, net = networks(jcfg, tcfg)
    n, ein = 200, 6 * freqs
    _, enc = _enc(n, freqs)
    packed = jk1.pack_trunk_weights(params, jcfg, jnp.float32)
    _, _, _, zs, us = jk2._run_fwd(jcfg, packed, enc, interpret=True,
                                   want_zs=True)
    rng = np.random.RandomState(5)
    cs = rng.normal(size=n).astype(np.float32)
    cf = (rng.normal(size=(n, feat)) * 0.1).astype(np.float32)
    cg = rng.normal(size=(n, ein)).astype(np.float32)
    ref = jk2._run_bwd(jcfg, packed, enc, jnp.asarray(cs), jnp.asarray(cf),
                       jnp.asarray(cg), zs, us, interpret=True)
    kcfg, tpacked = _kernel_pack(net, tcfg)
    fp = kcfg.feat
    got = tk2._run_bwd(kcfg, tpacked, t(enc), t(cs), t(cf), t(cg),
                       _pad_layers(t(zs), layers, fp),
                       _pad_layers(t(us), layers, fp))
    ref = list(ref)
    ref[7], ref[8] = ref[7][:, 0], ref[8][:1]
    logical = (np.s_[:, :feat], np.s_[:feat], np.s_[:, :feat, :feat],
               np.s_[:, :feat], np.s_[:, :feat], np.s_[:feat, :feat],
               np.s_[:feat], np.s_[:feat], np.s_[:])
    for name, g, r, sl in zip(K3_NAMES, got, ref, logical):
        g = g[sl]
        assert tuple(g.shape) == tuple(r.shape), name
        _grad_close(g, r, name)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3]],
                         ids=[IDS[0], IDS[3]])
def test_trunk_core_grads_match_jax_grad(shape):
    """TrunkCore (K2 saving zs/us, K3 in its backward, at the kernel
    width) under a loss on sigma, feats and the normalised normal, against
    jax.grad through the JAX package's fused_trunk_with_grad (its custom
    VJP, Pallas in interpret mode), every w and b, float32."""
    from brdfnerf_tpu.ops.compositing import l2_normalize as jl2
    from brdfnerf_tpu_torch.ops.compositing import l2_normalize
    feat, layers, skip, freqs = shape
    jcfg, tcfg = _configs(feat, layers, skip, freqs)
    params, net = networks(jcfg, tcfg)
    xyz, _ = _enc(90, freqs)
    rng = np.random.RandomState(4)
    cs = rng.normal(size=90).astype(np.float32)
    cf = (rng.normal(size=(90, feat)) * 0.1).astype(np.float32)
    cg = rng.normal(size=(90, 3)).astype(np.float32)

    def jloss(p):
        s, f, g = jk2.fused_trunk_with_grad(p, jcfg, jnp.asarray(xyz))
        return (jnp.sum(cs * s) + jnp.sum(cf * f.astype(jnp.float32))
                + jnp.sum(cg * -jl2(g)))

    v_ref, g_ref = jax.value_and_grad(jloss)(params)
    s, f, g = tk2.fused_trunk_with_grad(net, tcfg, t(xyz))
    assert tuple(f.shape) == (90, feat)
    v_got = (torch.sum(t(cs) * s) + torch.sum(t(cf) * f.float())
             + torch.sum(t(cg) * -l2_normalize(g)))
    grads = torch.autograd.grad(v_got, tk2.trunk_params(net))
    np.testing.assert_allclose(v_got.item(), float(v_ref), rtol=GRAD_RTOL)
    refs = []
    for layer in list(g_ref["fc_net"]) + [g_ref["sigma_from_xyz"][0]]:
        refs += [layer["w"].T, layer["b"]]
    assert len(grads) == len(refs) == 2 * layers + 2
    for i, (gg, r) in enumerate(zip(grads, refs)):
        assert tuple(gg.shape) == tuple(r.shape), i
        _grad_close(gg, r, f"param {i}")


# ------------------------------------------------ the zero-padded packing

def _rel(got, ref):
    ref = ref.double()
    return float((got.double() - ref).norm() / ref.norm().clamp_min(1e-30))


@pytest.mark.parametrize("feat,layers,skip", [(96, 4, 2), (200, 4, 2),
                                              (600, 4, 2), (136, 8, 4)])
def test_padded_packing_matches_unpadded(feat, layers, skip):
    """The packing at kernel_cfg's width (96 and 200 for the fused family
    at 128 and 256, 600 and 136 for the layer-major at 640 and 256) gives
    the unpadded twins' sigma, feats, gx, zs, us and logical weight
    gradients to 1e-6 relative L2, float32, and every padded gradient
    entry (rows and columns past the width) is exactly 0."""
    _, cfg = _configs(feat, layers, skip, 10)
    from brdfnerf_tpu_torch.models.network import init_network
    net = init_network(cfg, torch.Generator().manual_seed(3), device="cpu")
    kcfg, pp = _kernel_pack(net, cfg)
    fp = kcfg.feat
    assert fp > feat and fp % 64 == 0
    pu = tk1.pack_trunk_weights(net, cfg, torch.float32)
    # the packing itself: the logical block, zeros around it
    assert tuple(pp["w_skip"].shape) == (fp, 128 + fp)
    assert torch.equal(pp["w0"][:feat], pu["w0"])
    assert float(pp["w0"][feat:].abs().max()) == 0.0
    assert float(pp["w_mid"][:, feat:].abs().max()) == 0.0
    assert float(pp["w_mid"][:, :, feat:].abs().max()) == 0.0
    _, enc = _enc(256, 10, seed=2)
    x = t(enc)
    out_p = tk2._run_fwd(kcfg, pp, x, want_zs=True)
    out_u = tk2._run_fwd(cfg, pu, x, want_zs=True)
    assert _rel(out_p[0], out_u[0]) <= 1e-6
    assert _rel(out_p[1][:, :feat], out_u[1]) <= 1e-6
    assert float(out_p[1][:, feat:].abs().max()) == 0.0
    assert _rel(out_p[2], out_u[2]) <= 1e-6
    n_p = out_p[3].shape[0]
    for i in (3, 4):
        assert _rel(_layers(out_p[i][:256], layers, feat),
                    out_u[i][:256].reshape(256, layers, feat)) <= 1e-6
        assert float(out_p[i].reshape(n_p, layers, fp)[:, :, feat:]
                     .abs().max()) == 0.0
    s1, _ = tk1.fused_trunk_sigma(net, cfg, x, want_feats=False)
    s0, _ = tk1._trunk_sigma_plain(pu, cfg, tk1.pad_rows_lanes(
        x, 256, pu["w0"].shape[1]), False)
    assert _rel(s1, s0) <= 1e-6
    rng = np.random.RandomState(6)
    cs = t(rng.normal(size=256).astype(np.float32))
    cf = t((rng.normal(size=(256, feat)) * 0.1).astype(np.float32))
    cg = torch.zeros(256, pu["w0"].shape[1])
    cg[:, :60] = t(rng.normal(size=(256, 60)).astype(np.float32))
    gp = tk2._run_bwd(kcfg, pp, x, cs, cf, cg, out_p[3], out_p[4])
    gu = tk2._run_bwd(cfg, pu, x, cs, cf, cg, out_u[3], out_u[4])
    logical = (np.s_[:, :feat], np.s_[:feat], np.s_[:, :feat, :feat],
               np.s_[:, :feat], np.s_[:, :feat], np.s_[:feat, :feat],
               np.s_[:feat], np.s_[:feat], np.s_[:])
    # the sigma head's bias gradient is one sum of terms of either sign:
    # held against its terms' L2 norm (f32_check.dbsig_scale), as the
    # kernel checks hold it
    from brdfnerf_tpu_torch.tools.f32_check import dbsig_scale
    terms = dbsig_scale(pu, cfg, cs, cg, out_u[3])
    for name, g, r, sl in zip(K3_NAMES, gp, gu, logical):
        if name == "dbsig":
            assert float((g - r).abs().max()) <= 1e-6 * terms, name
        else:
            assert _rel(g[sl], r) <= 1e-6, name
        pad = g.clone()
        pad[sl] = 0.0
        assert float(pad.abs().max()) == 0.0, name
    # TrunkCore's grads are the unpadded ones, at the model's shapes
    grads = tk2._unpack_grads(cfg, 60, gp)
    assert [tuple(v.shape) for v in grads] == [
        tuple(p.shape) for p in tk2.trunk_params(net)]


# ------------------------------------------ gates, plans, the [kernels] line

@pytest.mark.parametrize("feat", [32, 96, 192, 384, 640, 768, 1024, 2048])
@pytest.mark.parametrize("freqs", [10, 21, 22, 42])
def test_every_width_and_encoding_is_covered(feat, freqs):
    """Every width up to 2048 and every encoding up to 256 lanes that the
    JAX package's kernel_supports admits is covered at every kernel dtype
    and activation; kernel_cfg picks the fused family (a width of at most
    512 with at most 128 lanes, at the next built width) or the
    layer-major one (at the width rounded up to 128)."""
    for dtype in tk1.CUDA_DTYPES:
        for kw in (dict(siren=True, fast_sin=True),
                   dict(siren=True, fast_sin=False),
                   dict(siren=False)):
            jcfg, cfg = model_configs(
                variant="spsbrdf-nerf", mapping=True, layers=8, feat=feat,
                skips=(4,), mapping_sizes=(freqs, 4), compute_dtype=dtype,
                **kw)
            assert jk1.kernel_supports(jcfg) and tk1.kernel_supports(cfg)
            assert tk1.cuda_kernels_cover(cfg)
            kc = tk1.kernel_cfg(cfg)
            lanes = 6 * freqs
            assert cfg.xyz_in_dim == lanes
            fused = feat <= 512 and lanes <= 128
            assert tk1.layer_major(kc) == (not fused)
            if fused:
                assert kc.feat in tk1.CUDA_WIDTHS and kc.feat >= feat
                assert tk1.row_tile(kc) == tk1.TILE_N
            else:
                assert kc.feat == -(-feat // 128) * 128
                assert tk1.row_tile(kc) == tl.ROWS


def _line(argv, monkeypatch, heads=False, freqs=None):
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.cli.train import kernels_line
    if heads:
        monkeypatch.setenv("BRDFNERF_FUSED_HEADS", "1")
    else:
        monkeypatch.delenv("BRDFNERF_FUSED_HEADS", raising=False)
    args = opts.postprocess(opts.train_parser().parse_args(
        ["--root_dir", "r", "--exp_name", "e", "--mapping", "--normal",
         "analystic", "--funcM", "1", "--funcF", "1", "--funcH", "1",
         "--dim_RPV", "1", "--brdf_on", "0.5", "--compute_dtype",
         "bfloat16_all"] + argv))
    cuda = torch.device("cuda")
    cfg = opts.to_run_config(args, device=cuda)
    if freqs:
        cfg = dc.replace(cfg, model=dc.replace(cfg.model,
                                               mapping_sizes=(freqs, 4)))
    return kernels_line(cfg, cuda), kernels_line(cfg, cuda, train=False)


@pytest.mark.parametrize("argv,freqs,family,extra", [
    (["--fc_feat", "2048", "--fc_layers", "12"], None, "layer-major", ()),
    (["--fc_feat", "768"], None, "layer-major", ()),
    (["--fc_feat", "96"], None, "fused",
     ("K1-K3 run at 128, zero-padded",)),
    (["--fc_feat", "384"], None, "fused",
     ("K1-K3 run at 512, zero-padded",)),
    (["--fc_feat", "128"], 24, "layer-major", ("an encoding of 144 lanes",)),
])
def test_kernels_line_names_the_family(argv, freqs, family, extra,
                                       monkeypatch):
    """The [kernels] line names the family that runs K1-K3 at the width
    (and the width it runs at where the packing is padded, or the
    encoding's lanes), with K1 and K2 + K3 (K2 when serving); with
    BRDFNERF_FUSED_HEADS set, K4 + K5 in K2 + K3's place (K4 when serving)
    in the same family and at the same width."""
    line, serve_line = _line(argv, monkeypatch, freqs=freqs)
    assert line.startswith(f"[kernels] {family} CUDA kernels at width"), line
    for w in ("K1 (the sigma-only passes)", "K2 + K3") + extra:
        assert w in line, (w, line)
    assert "K2 (the trunk with its sigma gradient)" in serve_line
    line, serve_line = _line(argv, monkeypatch, heads=True, freqs=freqs)
    feat = int(argv[1])
    heads = (f"K4/K5 layer-major at {-(-feat // 128) * 128}"
             if family == "layer-major" else
             f"K4/K5 at {min(w for w in tk1.CUDA_WIDTHS if w >= feat)}, "
             "zero-padded")
    assert f"K4 + K5 in their place where the flagship head set runs " \
        f"(BRDFNERF_FUSED_HEADS; {heads})" in line, line
    assert f"K4 in its place where the flagship head set runs " \
        f"(BRDFNERF_FUSED_HEADS; {heads.replace('K4/K5', 'K4')})" \
        in serve_line, serve_line
    assert "stay on" not in line + serve_line


def test_point_blocks_fit_the_budget():
    """point_block keeps each launch's scratch within BUDGET: the 12 x 2048
    serving chunk (655,360 points) and training step (131,072) are walked
    in blocks of multiples of ROWS; a small call is one block."""
    _, cfg = _configs(2048, 12, 4, 10, "bfloat16_all")
    for kind, n in (("K1", 327680), ("K2", 655360), ("K2", 131072),
                    ("K3", 131072)):
        for dtype in tk1.CUDA_DTYPES:
            c = dc.replace(cfg, compute_dtype=dtype)
            b = tl.point_block(kind, c, 128, n)
            assert b % tl.ROWS == 0 and 0 < b <= n, (kind, dtype, b)
            assert tl.scratch_bytes(kind, c, 128, b) <= tl.BUDGET
            # the most that fits: one ROWS more would not
            if b < n:
                assert tl.scratch_bytes(kind, c, 128, b + tl.ROWS) > \
                    tl.BUDGET * 0.99, (kind, dtype, b)
    # K2 keeps every layer's act'(z): 59 GB at 655,360 points whole
    assert tl.scratch_bytes("K2", cfg, 128, 655360) > 50e9
    assert tl.point_block("K2", cfg, 128, 655360) < 655360
    _, small = _configs(640, 4, 2, 10)
    assert tl.point_block("K3", small, 128, 384) == 384
    # the weight gradients' split-K slices: WG_SLICE points' products each
    assert tl.wgrad_slices(cfg, 8192) == 2
    assert tl.wgrad_slices(dc.replace(cfg, compute_dtype="float32"),
                           8192) == 6


def test_argument_slots_match_the_source():
    """The two arrays the entry points take (PTRS, DIMS) follow the enums
    of csrc/trunk_layers.cu, and its tile and slice constants match
    ROWS and WG_SLICE."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "brdfnerf_tpu_torch", "csrc",
        "trunk_layers.cu")
    with open(path) as fh:
        src = fh.read()
    enums = re.findall(r"enum\s*\{([^}]*)\}", src)
    ptrs = [e.strip() for e in enums[1].split(",") if e.strip()]
    dims = [e.strip() for e in enums[2].split(",") if e.strip()]
    assert ptrs[-1] == "N_PTR" and dims[-1] == "N_DIM"
    assert len(ptrs) - 1 == len(tl.PTRS) and len(dims) - 1 == len(tl.DIMS)

    assert [c[2:].lower() for c in ptrs[:-1]] == list(tl.PTRS)
    assert [c[2:].lower() for c in dims[:-1]] == list(tl.DIMS)
    assert re.search(r"BM = 128, BN = 128", src) and tl.ROWS == 128
    assert re.search(r"WG_SLICE = 8192;", src) and tl.WG_SLICE == 8192


def test_product_mainloop_is_wgmma_fed_by_tma():
    """The layer-major product of csrc/trunk_layers.cu runs wgmma on tiles
    a TMA ring brings (sm90_common.cuh), with no mma.sync mainloop left:
    its float32 instantiations still fold the tensor cores' sum into the
    second f32 sum every 512 products, and the weight gradients' split-K
    slices are whole k-steps."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "brdfnerf_tpu_torch", "csrc",
        "trunk_layers.cu")
    with open(path) as fh:
        src = fh.read()
    code = re.sub(r"//[^\n]*", "", src)

    def const(name):
        m = re.search(rf"\b{name} = (\d+)[;,]", code)
        assert m, name
        return int(m.group(1))

    bk = const("BK")
    assert const("FLUSH_CHUNKS") * bk == 512
    assert const("WG_SLICE") % bk == 0
    assert re.search(r'#include "sm90_common.cuh"', code)
    assert "mma.sync" not in code and "ldmatrix" not in code
    assert "cp.async.cg" not in code
    assert "wgmma_n128" in code and "tma_load_2d" in code
    assert "map_2d" in code


def test_layer_major_wrappers_refuse_what_they_cannot_run():
    """A CPU tensor, rows off the tile, or a width off the tile raise
    ValueError in the layer-major wrappers (never a fallback to a twin);
    the dispatch sends a layer-major kernel configuration to them."""
    _, cfg = _configs(640, 4, 2, 10, "bfloat16_all")
    from brdfnerf_tpu_torch.models.network import init_network
    net = init_network(cfg, torch.Generator().manual_seed(0), device="cpu")
    kcfg, packed = _kernel_pack(net, cfg)
    assert tk1.layer_major(kcfg)
    x = torch.zeros(128, 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tl.layers_sigma(packed, kcfg, x, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk1._trunk_sigma_cuda(packed, kcfg, x, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk2._trunk_fwd_grad_cuda(packed, kcfg, x)
    with pytest.raises(ValueError, match="multiple of 128"):
        tk1.check_kernel_inputs(dc.replace(kcfg, feat=600), packed, x)
    with pytest.raises(ValueError, match="keeps no scratch"):
        tk2._trunk_bwd_cuda(packed, kcfg, x, None, None, None, None, None,
                            scratch_out={})


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_layer_kernels_match_twins_on_the_card():
    """Every layer-major instantiation (12 x 2048 on 128, 384 and 5,120
    points; 4 x 768 at the exact sine and ReLU; 4 x 128 and 8 x 128 with
    144 lanes, on 128 and 384) and the fused family at width 96 (at 128)
    against their twins on the card at every dtype, twice bit-identical
    (tools/width_check.check_layers, the bounds of the width-512 rows times
    sum_length_scale), the product's edge cases among them: a block of one
    row tile, fewer k-steps than ring stages (layer 0 at 128 lanes), the
    skip layer's segments, a weight gradient of several split-K slices
    with a ragged last one (12 x 2048 at 5,120 points); chip_smoke.py's
    `widths, layer-major` phase makes the same checks and drives the main
    paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from brdfnerf_tpu_torch.tools import act_check, width_check
    torch.backends.cuda.matmul.allow_tf32 = False
    del act_check.MISSES[:]
    width_check.check_layers((128, 384))
    width_check.check_layers((5120,),
                             configs=width_check.LAYER_CONFIGS[:1])
    assert not act_check.MISSES, act_check.MISSES
