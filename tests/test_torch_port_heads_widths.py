"""K4/K5, the fused trunk + heads pair, at the trunk widths 128 and 256
(width 64 is tests/test_torch_port_heads.py's), and the width-dependent
layouts that K5's kernels write and ops/fused_trunk_heads.py reads, at
every width of CUDA_WIDTHS.

The plain twins of K4 and K5 are held against the JAX package's Pallas
_fwd_kernel_h / _bwd_kernel_h in interpret mode at 4 layers with the skip
at 2 on 100 points, at tests/test_torch_port_heads.py's tolerances:
float32 3e-5 for the packed logits and 3e-4 of its scale for gx and zs,
the weight gradients by _grad_close; bfloat16_all close_but_flips (both
sides round the same operands to bf16; summation order flips a rounding
now and then), except that the sigma head's bias gradient, one sum of
terms of either sign that cancel further at the wider widths, is held at
bfloat16_all to 3e-3 of its terms' L2 norm (tools/f32_check.dbsig_scale,
the measure the card's checks use) rather than of the sum.  The layout
checks are exact.  The kernels themselves are held to their twins on the
card by tools/width_check.py and chip_smoke.py's widths phase (the
cuda-marked test below).
"""

import dataclasses as dc

import pytest
import torch

import jax.numpy as jnp

from brdfnerf_tpu.ops import pallas_trunk_heads as jh

from brdfnerf_tpu_torch.ops import fused_mlp as tk1
from brdfnerf_tpu_torch.ops import fused_trunk_heads as th
from brdfnerf_tpu_torch.tools.f32_check import dbsig_scale

from test_torch_port_heads import K5_NAMES, _logit_cotangents, _packs
from test_torch_port_kernels import (_grad_close, _inputs, _j2t, _scale,
                                     close_but_flips)
from torch_port_common import (FLAGSHIP_HEADS, SMALL, close, model_configs,
                               networks, t)

N = 100


def _configs(feat, dtype):
    return model_configs(**dict(SMALL, feat=feat), **FLAGSHIP_HEADS,
                         compute_dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16_all"])
@pytest.mark.parametrize("feat", [128, 256])
def test_k4_k5_twins_match_pallas_at_width(feat, dtype):
    """K4's twin (logits, gx, zs) against _run_fwd_h, and K5's twin against
    _run_bwd_h on the JAX forward's zs and the same cotangents, every
    output, at trunk width `feat`."""
    jcfg, tcfg = _configs(feat, dtype)
    params, net = networks(jcfg, tcfg)
    _, enc = _inputs(N)
    jp, jhw, tp, thw = _packs(params, net, jcfg, tcfg)
    out_r, gx_r, zs_r = jh._run_fwd_h(jcfg, jp, jhw, enc, interpret=True,
                                      want_zs=True)
    out, gx, zs = th._run_fwd_h(tcfg, tp, thw, t(enc), want_zs=True)
    assert tuple(out.shape) == (N, 8) and float(out[:, 7].abs().max()) == 0
    assert tuple(zs.shape) == (-(-N // 64) * 64, 4 * feat)   # padded rows
    if dtype == "float32":
        close(out, out_r, atol=3e-5, rtol=3e-5, what="out")
        close(gx, gx_r, atol=3e-4 * _scale(gx_r), what="gx")
        close(zs[:N], zs_r[:N], atol=3e-4 * _scale(zs_r), rtol=3e-5,
              what="zs")
    else:
        for name, g, r in (("out", out, out_r), ("gx", gx, gx_r),
                           ("zs", zs[:N], zs_r[:N])):
            close_but_flips(g, r, name)
    cot, cg = _logit_cotangents(N)
    ref = list(jh._run_bwd_h(jcfg, jp, jhw, enc, jnp.asarray(cot),
                             jnp.asarray(cg), zs_r, interpret=True))
    ref[7], ref[8] = ref[7][:, 0], ref[8][:1]
    sd = torch.bfloat16 if dtype == "bfloat16_all" else None
    zs_t = _j2t(zs_r, sd)
    got = th._run_bwd_h(tcfg, tp, thw, t(enc), t(cot), t(cg), zs_t)
    assert len(got) == len(ref) == len(K5_NAMES)
    for name, g, r in zip(K5_NAMES, got, ref):
        assert tuple(g.shape) == tuple(r.shape), name
        if name == "dbsig" and dtype != "float32":
            n_p = zs_t.shape[0]
            terms = dbsig_scale(tp, tcfg, tk1.pad_rows_lanes(
                t(cot)[:, :1], n_p, 1)[:, 0], tk1.pad_rows_lanes(
                    t(cg), n_p, tk1.LANE), zs_t)
            assert abs(float(g[0]) - float(r[0])) <= 3e-3 * terms, (
                float(g[0]), float(r[0]), terms)
            continue
        _grad_close(g, r, dtype, name)


# ------------------------------------------------ the kernels' layouts

@pytest.mark.parametrize("feat", tk1.CUDA_WIDTHS)
def test_head_part_layout_reads_back_at_width(feat):
    """head_part(F) is csrc/trunk_bwd.cuh's HEAD_PART (db_f F, db_1 4 HID,
    dW_2 3 x 4 HID, db_2 8); head_part_grads reads per-tile partials laid
    out so (each column a distinct value, summed over 3 tiles) into the
    reduce kernel's outputs, and _unpack_head_grads hands every head
    parameter exactly its columns."""
    hid, layers, tiles = feat // 2, 3, 3
    assert th.head_part(feat) == feat + 4 * hid + 12 * hid + 8
    trunk = (layers + 1) * feat
    cols = trunk + th.head_part(feat)
    part = torch.arange(tiles * cols, dtype=torch.float64).view(tiles, cols)
    s = part.sum(0)[trunk:]                   # the head columns' sums
    dbf, db1, dw2r, db2r, dw2p, db2p = th.head_part_grads(part, layers, feat)
    f, h = feat, hid
    dw1 = torch.randn(f, 4 * h, dtype=torch.float64)
    outs = (torch.randn(f, f, dtype=torch.float64), dbf, dw1[:, :h],
            db1[:h], dw2r, db2r, dw1[:, h:], db1[h:], dw2p, db2p)
    cfg = dc.replace(_configs(64, "float32")[1], feat=feat)
    g = th._unpack_head_grads(cfg, outs)
    # [feats_from_xyz w, b], [rgb w1, b1, w2, b2], then per RPV head
    # [w1, b1, w2, b2]: 16 tensors in head_params' order
    assert len(g) == 2 + 4 + 4 * 3
    assert torch.equal(g[1], s[:f])                          # db_f
    assert torch.equal(g[3], s[f:f + h])                     # db_1r
    dw2 = s[f + 4 * h:f + 16 * h].view(3, 4 * h)             # [c, k]
    assert torch.equal(g[4], dw2[:, :h])                     # W_2r (3, H)
    assert torch.equal(g[5], s[f + 16 * h:f + 16 * h + 3])   # db_2r
    for i in range(3):
        k0 = (i + 1) * h
        assert torch.equal(g[6 + 4 * i + 1], s[f + k0:f + k0 + h])  # db_1
        # the block-diagonal second layer: logit column i over head i's
        # hidden units
        assert torch.equal(g[6 + 4 * i + 2], dw2[i:i + 1, k0:k0 + h])
        assert torch.equal(g[6 + 4 * i + 3],
                           s[f + 16 * h + 3 + i:f + 16 * h + 4 + i])
    assert float(dw2r[:, 3:].abs().max()) == 0.0
    assert float(dw2p[:, 3:].abs().max()) == 0.0
    assert torch.equal(db2r[3:], torch.zeros(tk1.LANE - 3, dtype=db2r.dtype))


@pytest.mark.parametrize("feat", tk1.CUDA_WIDTHS)
def test_uchain_from_kernel_reads_the_layout_at_width(feat):
    """K5's rebuilt chain at width F lies in the sweep's tz layout
    (element j < F / 16, e of consumer thread c of layer l of tile t at
    ((t L + l) F / 4 + 4 j + e) 256 + c; thread c = 128 wg + 32 w + 4 q + p
    holds rows 16 w + q + 8 (e // 2), columns F / 2 wg + 8 j + 2 p + e % 2);
    uchain_from_kernel reads it back into (n, L F), every element once."""
    n, layers, f = 128, 2, feat
    want = torch.arange(n * layers * f, dtype=torch.float32).view(
        n, layers * f)
    tt, ll, jj, ee, cc = torch.meshgrid(
        torch.arange(n // 64), torch.arange(layers), torch.arange(f // 16),
        torch.arange(4), torch.arange(256), indexing="ij")
    wg, w, q, p = cc // 128, (cc // 32) % 4, (cc // 4) % 8, cc % 4
    rows = tt * 64 + 16 * w + q + 8 * (ee // 2)
    cols = ll * f + (f // 2) * wg + 8 * jj + 2 * p + ee % 2
    uc = want[rows.reshape(-1), cols.reshape(-1)]
    assert torch.equal(th.uchain_from_kernel(uc, n, layers, feat), want)


@pytest.mark.parametrize("feat", [64, 128, 256, 512, 96, 1024])
def test_head_weights_checked_at_each_width(feat):
    """K4/K5 take every width K1-K3 take (cuda_kernels_cover, the one gate
    of K1-K5: 96 and 1024 too); check_head_weights takes the heads packed at the
    width the kernels run the model at (kernel_cfg: 96 at 128, zero-padded;
    1024 layer-major, with the merged first layers and the second layers
    over them), refuses another width's, and refuses a configuration that
    is not a kernel configuration (width 96 itself), whatever the
    heads."""
    _, cfg = _configs(feat, "bfloat16_all")
    assert tk1.cuda_kernels_cover(cfg)
    kcfg = tk1.kernel_cfg(cfg)
    assert kcfg.feat == (128 if feat == 96 else feat)
    g = torch.Generator().manual_seed(0)
    from brdfnerf_tpu_torch.models.network import init_network
    hw = th.pack_head_weights(init_network(cfg, g, device="cpu"), kcfg,
                              torch.bfloat16)
    assert ("w2" in hw) == (feat > 512)
    x = torch.zeros(128, 128)
    th.check_head_weights(kcfg, hw, x)
    other = 128 if kcfg.feat != 128 else 64
    with pytest.raises(ValueError, match="packed head wf"):
        th.check_head_weights(dc.replace(kcfg, feat=other), hw, x)
    if kcfg.feat != feat:
        with pytest.raises(ValueError, match="packed at the width the "
                                             "kernels run"):
            th.check_head_weights(cfg, hw, x)


def _line_at(argv, monkeypatch, freqs):
    """The train CLI's and the serving [kernels] lines with the switch set
    (tests/test_torch_port_widths._kernels_line), with `freqs` encoding
    frequencies (the Python API's; the CLIs keep 10) where given."""
    from test_torch_port_widths import _kernels_line
    cfg, line, serve_line = _kernels_line(argv, monkeypatch, heads=True)
    if freqs:
        from brdfnerf_tpu_torch.cli.train import kernels_line
        cfg = dc.replace(cfg, model=dc.replace(cfg.model,
                                               mapping_sizes=(freqs, 4)))
        cuda = torch.device("cuda")
        line = kernels_line(cfg, cuda)
        serve_line = kernels_line(cfg, cuda, train=False)
    return line, serve_line


@pytest.mark.parametrize("argv,freqs,brdf_on,runs,heads", [
    pytest.param(["--fc_feat", "128"], 0, "0", False, None, id="0-False"),
    pytest.param(["--fc_feat", "128"], 0, "0.5", True, "K4/K5 fused at 128",
                 id="0.5-True"),
    pytest.param(["--fc_feat", "96"], 0, "0.5", True,
                 "K4/K5 at 128, zero-padded", id="96-0.5-True"),
    pytest.param(["--fc_feat", "2048", "--fc_layers", "12"], 0, "0.5", True,
                 "K4/K5 layer-major at 2048", id="2048-0.5-True"),
    pytest.param(["--fc_feat", "128"], 24, "0.5", True,
                 "K4/K5 layer-major at 128", id="144lanes-0.5-True"),
])
def test_kernels_line_with_the_switch_at_width(argv, freqs, brdf_on, runs,
                                               heads, monkeypatch):
    """With BRDFNERF_FUSED_HEADS set the train CLI's [kernels] line names
    K4 + K5 (K4 when serving) and the family and width they run at (the
    fused pair at 128; width 96 at 128, zero-padded; the layer-major pair
    at 12 x 2048 and with a 144-lane encoding) where the RPV heads run
    without theta (--brdf_on 0.5), and says why the heads stay on K2 + K3
    where theta runs (--brdf_on 0, heads_kernel_supports' apply_theta)."""
    line, serve_line = _line_at(
        argv + ["--funcM", "1", "--funcF", "1", "--funcH", "1",
                "--brdf_on", brdf_on], monkeypatch, freqs)
    assert f"width {argv[1]}" in line
    assert ("K4 + K5 in their place" in line) == runs
    assert ("K4 in its place" in serve_line) == runs
    if runs:
        assert ("K4 + K5 in their place where the flagship head set runs "
                f"(BRDFNERF_FUSED_HEADS; {heads})") in line, line
        assert ("K4 in its place where the flagship head set runs "
                f"(BRDFNERF_FUSED_HEADS; {heads.replace('K4/K5', 'K4')})"
                ) in serve_line, serve_line
        assert "stay on" not in line + serve_line
        assert "K5" not in serve_line
    else:
        for ln, pair in ((line, "K2 + K3"), (serve_line, "K2")):
            assert ("K4/K5 take RPV without theta (--brdf_on 0.5 or more), "
                    f"so the heads stay on {pair}") in ln, ln


@pytest.mark.parametrize("dtype", ["bfloat16_all", "float32"])
@pytest.mark.parametrize("feat", tk1.CUDA_WIDTHS)
def test_trunk_work_counts_the_heads(feat, dtype):
    """tools/width_check.trunk_work's K4, K4zs and K5 rows: K2's work plus
    the heads' 3 F^2 + 3 F multiply-adds a point (K4; 12,480 at 64,
    787,968 at 512, as csrc/trunk_heads_fwd.cu states), K4 saving zs alone;
    K5 K3's work with the logit cotangents for c_feats and no us, plus the
    heads' backward and the rebuilt u chain (23,449,600 FLOP a point at
    8 x 512, csrc/trunk_heads_bwd.cu)."""
    from brdfnerf_tpu_torch.config import ModelConfig
    from brdfnerf_tpu_torch.tools import width_check as wc
    cfg = ModelConfig(variant="spsbrdf-nerf", mapping=True,
                      compute_dtype=dtype, normal="analystic",
                      sun_v="analystic", func_m=True, func_f=True, func_h=1,
                      dim_rpv=1, layers=8, feat=feat, skips=(4,))
    f, h, n, wb, hb = feat, feat // 2, 1000, 12345, 678
    ab = 2 if dtype == "bfloat16_all" else 4
    heads = 3 * f * f + 3 * f
    assert wc.head_macs(cfg) == heads
    assert heads == {64: 12480, 512: 787968}.get(f, heads)
    k2_ops, _ = wc.trunk_work("K2", cfg, n, wb)
    k3_ops, k3_bytes = wc.trunk_work("K3", cfg, n, wb)
    assert wc.trunk_work("K4", cfg, n, wb, hb) == (
        k2_ops + 2.0 * heads * n, n * (240 + 32 + 240) + wb + hb)
    assert wc.trunk_work("K4zs", cfg, n, wb, hb) == (
        k2_ops + 2.0 * heads * n,
        n * (240 + 32 + 240 + 8 * f * ab) + wb + hb)
    k5_ops, k5_bytes = wc.trunk_work("K5", cfg, n, wb, hb)
    back = 3 * f * f + 3 * f * 4 * h + 12 * h + 3 * h + 3 * h
    assert k5_ops == k3_ops + 2.0 * (back + 7 * f * f) * n
    head_grads = f * f + f + f * 4 * h + 4 * h + 12 * h + 6
    # no us and no c_feats; the 8 logit cotangents and the heads' weights
    # and grads
    assert k5_bytes == (k3_bytes - n * (8 * f * ab + f * ab) + n * 32 + hb
                        + 4 * head_grads)
    if f == 512:
        assert (k5_ops / n, wc.trunk_work("K4", cfg, 1, 0)[0]) == (
            23449600, 9162752)


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("feat", [64, 128, 256])
def test_heads_kernels_match_twins_on_the_card_at_width(feat):
    """test_heads_kernels_match_twins_on_the_card's checks at trunk width
    `feat` (8 layers, skip 4) on 192 points: K4 serving and saving zs, and
    K5, each twice bit-identical and held to its twin at every dtype, K4's
    sigma and gx bit for bit K2's, K5's rebuilt b_th chain and head
    partials (tools/width_check.check_width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from brdfnerf_tpu_torch.tools import act_check, width_check
    del act_check.MISSES[:]
    width_check.check_width(feat, 8, 4, "poly", 192)
    assert not act_check.MISSES, act_check.MISSES
