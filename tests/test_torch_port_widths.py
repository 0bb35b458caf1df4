"""K1-K3 at the trunk widths 64, 128 and 256 (--fc_feat): their plain twins
and split emulations against the JAX package's Pallas kernels (interpret
mode on the CPU), the stage-2 step at 8 x 64 against the JAX package's,
and what the gates, the library keys, the plans and the train CLI's
[kernels] line say of each width.

The CUDA kernels are built per width (-DTRUNK_F, ops/cuda_build.
library_key); the twins take the width from the configuration, as the
Pallas kernels do.  Tolerances are tests/test_torch_port_kernels.py's: the
forwards at float32 and K1 at every dtype 2e-5 / 3e-5 (gx 3e-4 of its
scale), the bf16 contract's rounding flips (close_but_flips) elsewhere, the
weight gradients by _grad_close; the split emulations (the float32
kernels' arithmetic) within 1e-4 relative L2 of Pallas; the step's loss at
rtol 1e-5 and its gradients at rtol 5e-4 (atol 2e-4 of each tensor's
scale).  The kernels themselves are held to their twins on the card by
tools/width_check.py and chip_smoke.py (the cuda-marked tests below).
"""

import dataclasses as dc
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brdfnerf_tpu.ops import pallas_mlp as jk1, pallas_trunk_vjp as jk2
from brdfnerf_tpu.parallel import train_step as jts
from brdfnerf_tpu.utils.checkpoint import save_checkpoint as jsave

from brdfnerf_tpu_torch.ops import cuda_build
from brdfnerf_tpu_torch.ops import fused_mlp as tk1
from brdfnerf_tpu_torch.ops import fused_trunk_heads as th
from brdfnerf_tpu_torch.ops import fused_trunk_vjp as tk2
from brdfnerf_tpu_torch.parallel import train_step as tts
from brdfnerf_tpu_torch.utils.checkpoint import load_flat, params_from_flat

from test_torch_port_kernels import (_cotangents, _grad_close, _inputs,
                                     _j2t, _scale, close_but_flips)
from test_torch_port_train import GATES, N_RAYS, draws_for, train_configs
from torch_port_common import (FLAGSHIP_HEADS, SMALL, a, close, jax_batch,
                               make_store, model_configs, networks,
                               render_configs, t, torch_batch)

DTYPES = ["bfloat16_all", "float32", "bfloat16"]
# (width, layers, skip): 4 x 64 and 4 x 128 with the skip at 2, and the
# reference's depth at 8 x 64
SHAPES = [(64, 4, 2), (128, 4, 2), (64, 8, 4)]
SPLIT_BOUND = 1e-4
K3_NAMES = ("dw0", "db0", "dwm", "dbm", "dwst", "dwsb", "dbs", "dwsig",
            "dbsig")


def _configs(feat, layers, skip, dtype):
    return model_configs(**dict(SMALL, feat=feat, layers=layers,
                                skips=(skip,)), **FLAGSHIP_HEADS,
                         compute_dtype=dtype)


def _od(dtype):
    return jnp.float32 if dtype == "float32" else jnp.bfloat16


def _rel(got, ref):
    g, r = a(got), a(ref)
    return float(np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30))


def _weights_through_npz(tmp_path, jcfg, tcfg, seed=0):
    """JAX params from the JAX package's init, saved as the JAX package's
    flat npz checkpoint, and the port's Network loaded from that file."""
    params, _ = networks(jcfg, tcfg, seed)
    path = str(tmp_path / "epoch=1.npz")
    jsave(path, {"coarse": params}, step=0)
    return params, params_from_flat(load_flat(path), tcfg,
                                    device="cpu").coarse


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("feat,layers,skip", SHAPES)
def test_k1_twins_match_pallas_at_width(tmp_path, feat, layers, skip, dtype):
    """K1's plain twin and split emulation (the kernel's arithmetic: f32
    operands as bf16 hi + lo terms, three products with f32 weights)
    against the Pallas _trunk_kernel, on weights carried through the JAX
    package's npz."""
    jcfg, tcfg = _configs(feat, layers, skip, dtype)
    params, net = _weights_through_npz(tmp_path, jcfg, tcfg)
    assert tk1.cuda_kernels_cover(tcfg)
    _, enc = _inputs(200, seed=feat + layers)
    s_ref, f_ref = jk1.fused_trunk_sigma(params, jcfg, enc, interpret=True)
    s_got, f_got = tk1.fused_trunk_sigma(net, tcfg, t(enc))
    assert tuple(f_got.shape) == (200, feat)
    close(s_got, s_ref, atol=2e-5, rtol=2e-5, what="sigma")
    close(f_got, f_ref, atol=2e-5, rtol=2e-5, what="feats")
    packed = tk1.pack_trunk_weights(net, tcfg, tk1.weight_dtype(tcfg))
    x = tk1.pad_rows_lanes(t(enc), 256, 128)
    s_sp, f_sp = tk1._trunk_sigma_split(packed, tcfg, x, True)
    assert _rel(s_sp[:200], s_ref) <= SPLIT_BOUND
    assert _rel(f_sp[:200], f_ref) <= SPLIT_BOUND


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("feat,layers,skip", SHAPES)
def test_k2_twins_match_pallas_at_width(feat, layers, skip, dtype):
    """K2's twin, serving and saving zs/us, against the Pallas _fwd_kernel;
    at float32 also its split emulation."""
    jcfg, tcfg = _configs(feat, layers, skip, dtype)
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(200, seed=feat + layers + 1)
    jp = jk1.pack_trunk_weights(params, jcfg, _od(dtype))
    tp = tk1.pack_trunk_weights(net, tcfg, tk1.weight_dtype(tcfg))
    ref = jk2._run_fwd(jcfg, jp, enc, interpret=True, want_zs=True)
    got = tk2._run_fwd(tcfg, tp, t(enc), want_zs=True)
    shape, sd = tk2.saved_spec(tcfg, got[3].shape[0])
    assert shape == (256, layers * feat) and got[3].dtype == sd
    assert tuple(got[1].shape) == (200, feat)
    for name, g, r in zip(("sigma", "feats", "gx", "zs", "us"), got, ref):
        g, r = g[:200], r[:200]
        if dtype == "float32":
            tol = 3e-4 * _scale(r) if name in ("gx", "us") else 3e-5
            close(g, r, atol=tol, rtol=3e-5, what=name)
        else:
            close_but_flips(g, r, name)
    if dtype == "float32":
        x = tk1.pad_rows_lanes(t(enc), 256, 128)
        split = tk2._trunk_fwd_grad_split(tp, tcfg, x, want_zs=True)
        for name, g, r in zip(("sigma", "feats", "gx", "zs", "us"), split,
                              ref):
            assert _rel(g[:200], r[:200]) <= SPLIT_BOUND, name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("feat,layers,skip", SHAPES)
def test_k3_twin_matches_pallas_at_width(feat, layers, skip, dtype):
    """K3's twin on the Pallas forward's zs/us and the same cotangents
    against the Pallas _bwd_kernel; at float32 also its split emulation.
    Every gradient has the width's shape."""
    jcfg, tcfg = _configs(feat, layers, skip, dtype)
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(200, seed=feat + layers + 2)
    jp = jk1.pack_trunk_weights(params, jcfg, _od(dtype))
    _, _, _, zs, us = jk2._run_fwd(jcfg, jp, enc, interpret=True,
                                   want_zs=True)
    cs, cf, cg = _cotangents(200, feat, seed=feat)
    cf_dt = jnp.bfloat16 if dtype == "bfloat16_all" else jnp.float32
    ref = list(jk2._run_bwd(jcfg, jp, enc, jnp.asarray(cs),
                            jnp.asarray(cf).astype(cf_dt), jnp.asarray(cg),
                            zs, us, interpret=True))
    sd = torch.bfloat16 if dtype == "bfloat16_all" else None
    tp = tk1.pack_trunk_weights(net, tcfg, tk1.weight_dtype(tcfg))
    got = tk2._run_bwd(tcfg, tp, t(enc), t(cs),
                       _j2t(jnp.asarray(cf).astype(cf_dt), sd), t(cg),
                       _j2t(zs, sd), _j2t(us, sd))
    ref[7], ref[8] = ref[7][:, 0], ref[8][:1]
    shapes = [(128, feat), (feat,), (layers - 2, feat, feat),
              (layers - 2, feat), (128, feat), (feat, feat), (feat,),
              (feat,), (1,)]
    for name, g, r, shape in zip(K3_NAMES, got, ref, shapes):
        assert tuple(g.shape) == tuple(r.shape) == shape, name
        _grad_close(g, r, dtype, name)
    if dtype == "float32":
        n_p = zs.shape[0]
        pad = lambda v, w: tk1.pad_rows_lanes(t(v), n_p, w)   # noqa: E731
        csp = torch.zeros(n_p)
        csp[:200] = t(cs)
        split = tk2._trunk_bwd_split(tp, tcfg, pad(enc, 128), csp,
                                     pad(cf, feat), pad(cg, 128), t(zs),
                                     t(us))
        for name, g, r in zip(K3_NAMES, split, ref):
            assert _rel(g, r) <= SPLIT_BOUND, name


def test_stage2_step_matches_jax_at_8x64(tmp_path):
    """The stage-2 step's loss, every term and every parameter's gradient
    at 8 x 64 (skip 4) through the fused trunk's twins (TrunkCore: K2's and
    K3's), on weights carried through the JAX package's npz, against
    jax.value_and_grad of the JAX package's compute_losses through its
    Pallas kernels, on one batch, gates and draws."""
    jm, tm = model_configs(**dict(SMALL, layers=8, skips=(4,)),
                           **FLAGSHIP_HEADS, compute_dtype="float32")
    jr, tr = render_configs(n_samples=8, guided_samples=8, apply_brdf=True,
                            use_pallas=True, fused_trunk=True)
    params, net = _weights_through_npz(tmp_path, jm, tm)
    assert tk1.kernel_supports(tm) and tk1.cuda_kernels_cover(tm)
    jt, tt = train_configs()
    s = make_store(N_RAYS, seed=7)
    key = jax.random.PRNGKey(13)
    jg = jts.TrainGates(**{k: jnp.asarray(v) for k, v in GATES.items()})
    (l_ref, (terms_ref, _)), g_ref = jax.value_and_grad(
        lambda p: jts.compute_losses(p, jm, jr, jt, jax_batch(s), key, jg),
        has_aux=True)({"coarse": params})
    loss, (terms, _) = tts.compute_losses(
        net, tm, tr, tt, torch_batch(s), tts.TrainGates(**GATES),
        draws=draws_for(key, jr))
    loss.backward()
    close(loss, l_ref, atol=0.0, rtol=1e-5, what="loss")
    for k in terms_ref:
        close(terms[k], terms_ref[k], atol=1e-7, rtol=1e-5, what=k)
    from brdfnerf_tpu.utils.checkpoint import _flatten as jflatten
    flat = jflatten(g_ref)
    for name, p in net.named_parameters():
        ref = flat["coarse/" + name.replace(".", "/")]
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        g = g.t() if name.endswith(".w") else g
        scale = max(float(np.max(np.abs(ref))), 1e-3)
        close(g, ref, atol=2e-4 * scale, rtol=5e-4, what=name)


# ------------------------------------- gates, libraries, plans, the CLI

@pytest.mark.parametrize("feat", [32, 64, 96, 128, 192, 256, 512, 640,
                                  1024])
def test_cuda_kernels_cover_the_built_widths(feat):
    """K1-K3 take every width kernel_supports (the twins) takes: the fused
    family the widths it is built for (CUDA_WIDTHS) and, zero-padded, the
    widths under 512 at the next of them; the layer-major family the rest
    (ops/trunk_layers.py); K4/K5 take every width K1-K3 take, in the same
    family (cuda_kernels_cover is the one gate of K1-K5)."""
    _, cfg = _configs(feat, 8, 4, "bfloat16_all")
    assert tk1.kernel_supports(cfg)
    assert tk1.cuda_kernels_cover(cfg)
    kc = tk1.kernel_cfg(cfg)
    assert tk1.layer_major(kc) == (feat > 512)
    assert kc.feat == (min(w for w in (64, 128, 256, 512) if w >= feat)
                       if feat <= 512 else -(-feat // 128) * 128)


@pytest.mark.parametrize("feat", [64, 128, 256])
def test_check_kernel_inputs_takes_the_width(feat):
    """The wrappers' checks read the width from the configuration: the
    packed weights of another width, or a width not built, raise
    ValueError (never a fallback to the twin)."""
    _, cfg = _configs(feat, 8, 4, "bfloat16_all")
    _, other = _configs(2 * feat, 8, 4, "bfloat16_all")
    _, wide = _configs(96, 8, 4, "bfloat16_all")
    from brdfnerf_tpu_torch.models.network import init_network
    g = torch.Generator().manual_seed(0)
    packed = tk1.pack_trunk_weights(init_network(other, g, device="cpu"),
                                    other, torch.bfloat16)
    x = torch.zeros(64, 128)
    with pytest.raises(ValueError, match="packed w0"):
        tk1.check_kernel_inputs(cfg, packed, x)
    with pytest.raises(ValueError, match="width"):
        tk1.check_kernel_inputs(wide, packed, x)


@pytest.mark.parametrize("feat", [64, 128, 256, 512])
def test_library_keys_per_width(feat):
    """One library per source, activation and width: the 512 keys keep
    their names and NVCC_FLAGS, the others add -DTRUNK_F and hash it into
    their own paths."""
    key = cuda_build.library_key("trunk_bwd", "poly", feat)
    name, flags = cuda_build._source_flags(key)
    assert name == "trunk_bwd"
    if feat == 512:
        assert key == "trunk_bwd" == cuda_build.library_key("trunk_bwd")
        assert flags == cuda_build.NVCC_FLAGS
    else:
        assert key == f"trunk_bwd:f{feat}"
        assert flags == cuda_build.NVCC_FLAGS + (f"-DTRUNK_F={feat}",)
        relu = cuda_build.library_key("trunk_bwd", "relu", feat)
        assert relu == f"trunk_bwd:relu:f{feat}"
        assert cuda_build._source_flags(relu)[1][-2:] == (
            "-DTRUNK_ACT=2", f"-DTRUNK_F={feat}")
    paths = {cuda_build.library_path(cuda_build.library_key(
        "trunk_bwd", act, f)) for act in cuda_build.ACTS
        for f in cuda_build.WIDTHS}
    assert len(paths) == len(cuda_build.ACTS) * len(cuda_build.WIDTHS)
    for bad in (96, 1024):
        with pytest.raises(ValueError):
            cuda_build.library_key("trunk_bwd", "poly", bad)
    with pytest.raises(ValueError):
        cuda_build._source_flags("trunk_bwd:f512")


@pytest.mark.parametrize("feat", [64, 128, 256, 512])
@pytest.mark.parametrize("layers", [4, 8])
def test_wgrad_and_fwd_plans_cover_every_width(feat, layers):
    """The weight-gradient kernel's tiles (128 x min(F, 256), a width-64
    layer's 64 rows in one tile) cover every gradient with no tile to
    spare, never none (a floor of F / 128 would leave width 64's dW_0 and
    mids unwritten); its scratch holds a tile for every block; K2's
    act'(z) scratch holds a 64 x F f32 slot for every layer its chain
    reads."""
    wn = tk2.wgrad_n(feat)
    assert wn == min(feat, 256) and feat % wn == 0
    shapes = ([(128, feat)] + [(feat, feat)] * (layers - 2)
              + [(128, feat), (feat, feat)])
    tiles = [-(-m // tk2.WGRAD_M) * (n // wn) for m, n in shapes]
    assert all(k >= 1 for k in tiles)
    for (m, n), k in zip(shapes, tiles):
        assert k * tk2.WGRAD_M * wn >= m * n
        assert (k - 1) * tk2.WGRAD_M * wn < m * n
    tt, th_ = tk2.wgrad_tiles(layers, False, feat)
    assert (tt, th_) == (sum(tiles), 0)
    if feat == 512:
        assert tk2.wgrad_tiles(layers) == (tt, 0)
    st, _ = tk2.wgrad_splits(131072, layers, False, 132, False, feat)
    assert 1 <= st <= 2 * 131072 // tk2.WGRAD_CHUNK
    for n, sms in ((64, 132), (8448, 132), (131072, 114)):
        blocks, elems = tk2.fwd_plan(n, layers, False, sms, feat)
        assert blocks == min(n // 64, sms)
        assert elems == blocks * (layers - 1) * 64 * feat
    _, cfg = _configs(feat, layers, layers // 2, "bfloat16_all")
    assert tk2.saved_spec(cfg, 256) == ((256, layers * feat), torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("feat", [64, 128, 256, 512])
def test_trunk_work_counts_what_the_kernels_need(feat, dtype):
    """The one byte and FLOP count of every K1-K3 row of the kernels line
    (tools/width_check.trunk_work, chip_smoke.py's 512 rows too): x, gx
    and cg at the encoding's 60 f32 lanes, not the kernels' 128-lane
    padding; feats, zs, us and c_feats at 2 bytes at bfloat16_all, else
    4; the trunk's products at the real encoding width (36,416 MACs a
    point at 8 x 64, as PERF.md states)."""
    from brdfnerf_tpu_torch.config import ModelConfig
    from brdfnerf_tpu_torch.tools import width_check as wc
    cfg = ModelConfig(variant="spsbrdf-nerf", mapping=True,
                      compute_dtype=dtype, normal="analystic",
                      sun_v="analystic", func_m=True, func_f=True, func_h=1,
                      dim_rpv=1, layers=8, feat=feat, skips=(4,))
    f, ein, n, wb = feat, cfg.xyz_in_dim, 1000, 12345
    assert ein == 60
    ab = 2 if dtype == "bfloat16_all" else 4
    macs = ein * f + 6 * f * f + (ein + f) * f + f
    if feat == 64:
        assert macs == 36416
    assert wc.trunk_work("K1", cfg, n, wb) == (2.0 * macs * n,
                                               n * (240 + 4) + wb)
    k2_ops = 2.0 * (2 * macs - f) * n
    assert wc.trunk_work("K2", cfg, n, wb) == (
        k2_ops, n * (240 + 4 + f * ab + 240) + wb)
    assert wc.trunk_work("K2zs", cfg, n, wb) == (
        k2_ops, n * (240 + 4 + f * ab + 240 + 16 * f * ab) + wb)
    grads = 2 * ein * f + 7 * f * f + 8 * f + f + 1
    assert wc.trunk_work("K3", cfg, n, wb) == (
        2.0 * (3 * macs + 7 * f * f) * n,
        n * (16 * f * ab + f * ab + 2 * 240 + 4) + wb + 4 * grads)
    # the bound is the longer of the two times; K2 at 8 x 64 is bound by
    # its bytes (K1 there sits at the balance of the two)
    t_ops, t_bytes = (x / p for x, p in zip(
        wc.trunk_work("K2", cfg, n, wb), wc.PEAKS["sxm"]))
    ms, by = wc.bound_ms(*wc.trunk_work("K2", cfg, n, wb), wc.PEAKS["sxm"])
    assert ms == pytest.approx(max(t_ops, t_bytes) * 1e3)
    assert by == ("operations" if t_ops >= t_bytes else "bytes")
    if feat == 64:
        assert by == "bytes"


def test_done_check_ulp_moves_each_weight_one_ulp(tmp_path):
    """done_check --ulp's perturbation: every float32 element of the
    stage-1 checkpoint one ulp up or down (both directions drawn), other
    arrays untouched, the same draw for the same seed."""
    from brdfnerf_tpu_torch.tools import done_check
    rng = np.random.RandomState(0)
    src = str(tmp_path / "s1.npz")
    np.savez(src, w=rng.randn(40, 30).astype(np.float32),
             b=np.zeros(30, np.float32), step=np.asarray(7))
    done_check.ulp_moved(src, str(tmp_path / "a.npz"), 3)
    done_check.ulp_moved(src, str(tmp_path / "b.npz"), 3)
    with np.load(src) as z0, np.load(str(tmp_path / "a.npz")) as za, \
            np.load(str(tmp_path / "b.npz")) as zb:
        for k in ("w", "b"):
            up = np.nextafter(z0[k], np.float32(np.inf))
            down = np.nextafter(z0[k], np.float32(-np.inf))
            assert za[k].dtype == np.float32
            assert np.all((za[k] == up) | (za[k] == down))
            assert (za[k] == up).any() and (za[k] == down).any()
            assert np.array_equal(za[k], zb[k])
        assert za["step"] == 7 and za["step"].dtype == z0["step"].dtype


def _kernels_line(argv, monkeypatch, heads=False):
    from brdfnerf_tpu_torch.cli import opts
    from brdfnerf_tpu_torch.cli.train import kernels_line
    if heads:
        monkeypatch.setenv("BRDFNERF_FUSED_HEADS", "1")
    else:
        monkeypatch.delenv("BRDFNERF_FUSED_HEADS", raising=False)
    args = opts.postprocess(opts.train_parser().parse_args(
        ["--root_dir", "r", "--exp_name", "e", "--mapping", "--normal",
         "analystic", "--compute_dtype", "bfloat16_all"] + argv))
    cuda = torch.device("cuda")
    cfg = opts.to_run_config(args, device=cuda)
    return cfg, kernels_line(cfg, cuda), kernels_line(cfg, cuda, train=False)


@pytest.mark.parametrize("feat", [64, 128, 256, 96, 1024])
def test_kernels_line_at_each_width(feat, monkeypatch):
    """On the card the train CLI turns K1-K3 on at every width and names
    it with the family that runs it: the fused kernels at the widths they
    are built for, and zero-padded at the next one below 512 (96 at 128);
    the layer-major kernels past 512 (1024)."""
    cfg, line, serve_line = _kernels_line(["--fc_feat", str(feat)],
                                          monkeypatch)
    assert cfg.render.use_pallas and cfg.render.fused_trunk
    for w in ("K1 (the sigma-only passes)", "K2 + K3", f"width {feat}"):
        assert w in line, (w, line)
    assert "K2 (the trunk with its sigma gradient)" in serve_line
    family = "layer-major" if feat > 512 else "fused"
    assert line.startswith(f"[kernels] {family} CUDA kernels"), line
    assert ("zero-padded" in line) == (feat == 96), line
    assert "none" not in line and "not one of" not in line


def test_fused_heads_gate_at_width_64(monkeypatch):
    """With BRDFNERF_FUSED_HEADS set at width 64, K4/K5 (built for every
    width K1-K3 take) are taken on the card: the [kernels] line names
    K4 + K5 (K4 when serving), and K4's and K5's weight checks take the
    width's heads and refuse another width's and a width the kernels do
    not run a model at (96: the kernels run it at 128); on the CPU the
    heads' twins take it too."""
    cfg, line, serve_line = _kernels_line(
        ["--fc_feat", "64", "--funcM", "1", "--funcF", "1", "--funcH", "1",
         "--dim_RPV", "1"], monkeypatch, heads=True)
    assert "K2 + K3 (the differentiated trunk" in line
    assert "K4 + K5 in their place" in line
    assert "K4 in its place" in serve_line
    assert "run in torch" not in line + serve_line
    m = cfg.model
    from brdfnerf_tpu_torch.models.network import init_network
    net = init_network(m, torch.Generator().manual_seed(0), device="cpu")
    assert th.heads_kernel_supports(m, net, apply_brdf=True)
    assert tk1.cuda_kernels_cover(m)
    hw = th.pack_head_weights(net, m, torch.bfloat16)
    th.check_head_weights(m, hw, torch.zeros(64, 128))
    with pytest.raises(ValueError, match="packed head wf"):
        th.check_head_weights(dc.replace(m, feat=128), hw,
                              torch.zeros(64, 128))
    with pytest.raises(ValueError, match="packed at the width the kernels "
                                         "run"):
        th.check_head_weights(dc.replace(m, feat=96), hw,
                              torch.zeros(64, 128))
    # the CPU twins of the head block take width 64
    xyz = torch.rand(64, 3) * 2 - 1
    out = th.fused_trunk_heads_with_grad(net, m, xyz)
    assert all(torch.isfinite(v).all() for v in out.values())


# ----------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("feat,layers,skip", [(64, 8, 4), (128, 8, 4),
                                              (256, 8, 4), (64, 4, 2)])
def test_width_kernels_match_twins_on_the_card(feat, layers, skip):
    """K1-K3 built at the width against their twins on the card at every
    dtype, each twice bit-identical (tools/width_check.check_width, the
    bounds of the width-512 rows), on 192 points; chip_smoke.py's widths
    phase makes the same checks and drives the main paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from brdfnerf_tpu_torch.tools import act_check, width_check
    torch.backends.cuda.matmul.allow_tf32 = False
    del act_check.MISSES[:]
    width_check.check_width(feat, layers, skip, "poly", 192)
    assert not act_check.MISSES, act_check.MISSES


@pytest.mark.cuda
def test_width_64_step_launches_k1_k2_k3_on_the_card(monkeypatch):
    """At width 64 a stage-2 step launches K1 2 / K2 1 / K3 1 and K4/K5
    none, with BRDFNERF_FUSED_HEADS unset and set."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from brdfnerf_tpu_torch import config as tconfig
    tm = tconfig.ModelConfig(**dict(SMALL, layers=8, skips=(4,)),
                             **FLAGSHIP_HEADS, compute_dtype="bfloat16_all")
    tr = tconfig.RenderConfig(n_samples=64, guided_samples=64,
                              apply_brdf=True, use_pallas=True,
                              fused_trunk=True)
    _, tt = train_configs(batch_size=256)
    kernels = (tk1.TRUNK_SIGMA, tk2.TRUNK_FWD_GRAD, tk2.TRUNK_BWD,
               th.TRUNK_HEADS_FWD, th.TRUNK_HEADS_BWD)
    store = {k: v.cuda() for k, v in torch_batch(make_store(256)).items()}
    for heads in (False, True):
        if heads:
            monkeypatch.setenv("BRDFNERF_FUSED_HEADS", "1")
        state, opt = tts.create_train_state(tm, tt, 1, device="cuda")
        step = tts.make_fused_train_step(
            tm, tr, tt, opt, tts.GateSchedule(1e18, 1e18, -1.0, 1, 0))
        for k in kernels:
            k.launches = 0
        state, m = step(state, store, torch.arange(256, device="cuda"), 0)
        assert np.isfinite(float(m["loss"]))
        assert [k.launches for k in kernels] == [2, 1, 1, 0, 0]
    assert os.environ.get("BRDFNERF_FUSED_HEADS") == "1"
