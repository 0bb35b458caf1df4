"""K1-K5 at the trunk widths 64, 128 and 256 (--fc_feat) on the card, held
against their plain twins, and timed at the main paths' shapes; and K1-K5
at the shapes the fused kernels do not take (the layer-major family and
the zero-padded widths).

    python3 -m brdfnerf_tpu_torch.tools.width_check [points ...]
    python3 -m brdfnerf_tpu_torch.tools.width_check --times [F ...]
    python3 -m brdfnerf_tpu_torch.tools.width_check --layers [points ...]

For each configuration of CONFIGS (widths 64, 128 and 256 at 8 layers
with the skip at 4, and width 64 at 4 layers with the skip at 2, the
flagship's RPV heads, weights from seed 0), at each size (default 192
and 8,448: a ragged wave of 3 tiles, and one tile for each of the H100's
132 SMs), at every compute dtype the kernels take with the polynomial
sine, and at width 64 also with the exact sine and ReLU: K1 with and
without feats, K2 serving and saving zs/us, K3, K4 serving and saving
zs, and K5 (on K4's zs), each launched twice with bit-identical outputs
and held to its twin by relative L2 over each output tensor, at the
bounds of the width-512 rows (tools/act_check.py, tools/f32_check.py):
  * bfloat16_all and bfloat16: the twin of the same dtype at
    act_check.BF16_BOUND (K1 at K1_BOUND), the sigma head's bias gradient
    at that bound of its terms' L2 norm, ReLU's kinked outputs at
    RELU_KINKED_BOUND;
  * float32: the exact-f32 twin at f32_check.F32_BOUND, and CLOSER times
    closer than the bfloat16_all kernel on the same inputs (K4/K5:
    HEADS_CLOSER, and their split twins at F32_BOUND too; at the exact
    sine and ReLU the 512 rows' act_check bounds, without the ratio);
  * K4's sigma and gx bit for bit K2's, its padded logit column and gx
    lanes 0, K5's rebuilt b_th chain within UCHAIN_BOUND of uchain_plain
    and its reduced head grads within PART_BOUND of the sums of its
    per-tile partials (fused_trunk_heads.head_part_grads).
--times does the same for every instantiation at its main path's shape
(kernel_rows and heads_rows: K1 at 327,680 points, K2 and K4 at 655,360,
K2 saving zs/us, K3, K4 saving zs and K5 at 131,072, where each
persistent block runs several tiles), at the widths given (default 64,
128 and 256), and times it beside its twin and the torch.matmul chain of
the same products, with its bound (trunk_work, bound_ms).  This is the
one command line for the widths' checks and times; chip_smoke.py's
`widths` phase runs both (check_all, kernel_rows, heads_rows).
--layers runs check_width for every configuration of LAYER_CONFIGS (the
12 x 2048 trunk; 4 x 768 at the exact sine and ReLU; a 144-lane encoding
at 4 x 128 and 8 x 128; width 96, which the fused kernels run at 128) at
each size (default LAYER_SIZES: 128, 384, 4,096 and 5,120 points, which
reach the layer-major product's edge cases): K1-K5 at
fused_mlp.kernel_cfg's width (the layer-major K4 and K5 past 512 and
over 128 lanes, the fused pair on heads packed zero-padded at 128 for
width 96), at the bounds above
times sum_length_scale (past width 512 every product sums more terms);
the layer-major K5's rebuilt chain is its last point block's rows
against uchain_plain, and its reduced [db_1; dW_2] against the sum of
its column partials.  --times F with F past 512 makes the layer-major
rows (layer_rows: 12 layers, skip 4; K1-K5).  chip_smoke.py's `widths,
layer-major` phase runs both (check_layers, layer_rows).
Prints the card's name and power limit first and a JSON summary last;
exits 1 where a check missed its bound.
"""

from __future__ import annotations

import dataclasses as dc
import json
import sys

import torch

from ..ops import fused_mlp as k1
from ..ops import fused_trunk_heads as k4
from ..ops import fused_trunk_vjp as k2
from .act_check import (ACT_CONFIGS, BF16_BOUND, K1_BOUND, MISSES, _hold,
                        bound_of)
from .f32_check import (CLOSER, F32_BOUND, HEADS_CLOSER, K3_NAMES,
                        K5_NAMES, cotangents, dbsig_scale, hold_f32, points,
                        rel_l2, same_twice)
from .kernel_times import _time as timed

# (width, layers, skip layer) of the configurations checked
CONFIGS = ((64, 8, 4), (128, 8, 4), (256, 8, 4), (64, 4, 2))
# the widths K1-K3 take besides the flagship's 512
WIDTHS = (64, 128, 256)
DTYPES = ("bfloat16_all", "float32", "bfloat16")
ACTS = {"poly": {"siren": True, "fast_sin": True}, **ACT_CONFIGS}
SIZES = (192, 8448)
# K5's rebuilt b_th chain against uchain_plain (K2's us bound: the same
# bf16 operands, f32 sums in another order)
UCHAIN_BOUND = 1e-2
# K5's reduced head grads against the sum of its per-tile partials
PART_BOUND = 1e-5
# the layer-major K5 walked in 128-point blocks against one block (times
# sum_length_scale): its weight gradients are the same products summed in
# another order, and one block sums them in the tensor cores' f32
# accumulator, whose error grows with its K (the points).  Sound, at
# 12 x 2048 on 4,096 points, 32 blocks sat 1.19e-5 from one block on an
# H100 80GB HBM3 at 700 W.  A walk that drops one block's sum (the
# mildest fault of the walk; a block that overwrites the sum gives ~1)
# sits ~0.19 from it: sqrt(1/32) of gradients whose points' terms are
# uncorrelated (the twins on the CPU at 4 x 768 and 6 x 640, 4,096
# points: 0.193 and 0.189).  point_blocks reads that fault on the card
# every run and holds it over the bound.
BLOCK_BOUND = 1e-4
# the H100's dense peaks: (bf16 tensor-core FLOP/s, HBM bytes/s)
PEAKS = {"sxm": (989e12, 3.35e12), "pcie": (756e12, 2.0e12)}


def peaks_of(kind: str):
    """PEAKS of the card named `kind` (torch.cuda.get_device_name)."""
    return PEAKS["pcie" if "pcie" in kind.lower() else "sxm"]


def bound_ms(flops, nbytes, peaks):
    """(the least milliseconds for `flops` and `nbytes` at `peaks`, "bytes"
    or "operations": whichever takes longer)."""
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def trunk_macs(cfg, ein):
    """Multiply-adds per point of the trunk + sigma head, at the real
    (unpadded) encoding width."""
    f, layers = cfg.feat, cfg.layers
    return ein * f + (layers - 2) * f * f + (ein + f) * f + f


def head_macs(cfg):
    """Multiply-adds per point of K4's head block at cfg's width F, HID =
    F / 2: W_f, the first layers (rgb and the merged RPV, 4 HID wide), the
    second layers (3 columns each): 3 F^2 + 3 F."""
    f, hid = cfg.feat, cfg.feat // 2
    return f * f + f * 4 * hid + 3 * hid + 3 * hid


def trunk_work(kern: str, cfg, n: int, wbytes: int, hbytes: int = 0):
    """(FLOPs, bytes) that K1, K2, K2zs (K2 saving zs/us), K3, K4, K4zs
    (K4 saving zs) or K5 needs at n points of cfg's trunk, at any width:
    the products at the encoding's real width, each input read once and
    each output written once.  x, gx and cg count at the encoding's
    cfg.xyz_in_dim f32 lanes (not the kernels' 128-lane padding, which
    they neither need nor fill); sigma and K3's c_sigma in f32; feats, zs,
    us and K3's c_feats at 2 bytes at bfloat16_all, else 4 (f32 saved
    state); K4's packed logits and K5's logit cotangents 8 f32; the trunk
    weights' `wbytes` and the heads' `hbytes` once; the f32 weight
    gradients at their real shapes.  K4 is K2's work plus the heads'
    (head_macs); K5 is K3's with the logit cotangents in place of c_feats
    and no us, plus the heads' recompute and backward and the rebuilt u
    chain (L - 1 products of F x F)."""
    ein, f, layers = cfg.xyz_in_dim, cfg.feat, cfg.layers
    hid = f // 2
    macs = trunk_macs(cfg, ein)
    xb = ein * 4
    ab = 2 if cfg.compute_dtype == "bfloat16_all" else 4
    zbytes = 2 * layers * f * ab                     # zs and us, a point
    if kern == "K1":
        return 2.0 * macs * n, n * (xb + 4) + wbytes
    if kern in ("K2", "K2zs"):
        saved = zbytes if kern == "K2zs" else 0
        return (2.0 * (2 * macs - f) * n,
                n * (xb + 4 + f * ab + xb + saved) + wbytes)
    if kern in ("K4", "K4zs"):
        saved = layers * f * ab if kern == "K4zs" else 0
        return (2.0 * (2 * macs - f + head_macs(cfg)) * n,
                n * (xb + 8 * 4 + xb + saved) + wbytes + hbytes)
    # the tangent forward (macs), the a chain (L - 1 products of F x F),
    # the outer products of every layer's dW over (primal, tangent)
    grad_elems = (2 * ein * f + (layers - 1) * f * f + layers * f + f + 1)
    k3_flops = 2.0 * (3 * macs + (layers - 1) * f * f) * n
    if kern == "K3":
        return (k3_flops, n * (zbytes + f * ab + 2 * xb + 4) + wbytes
                + 4 * grad_elems)
    assert kern == "K5", kern
    # the heads' backward: the recompute of xf and z1, a_xf = c_z1 W_1,
    # a_xf W_f, the outer products of dW_f and dW_1, dW_2 over all 4 HID
    # hidden units and 3 columns, and c_z2 W_2
    heads = 3 * f * f + 3 * f * 4 * hid + 4 * hid * 3 + hid * 3 + 3 * hid
    head_grads = f * f + f + f * 4 * hid + 4 * hid + 3 * 4 * hid + 6
    return (k3_flops + 2.0 * (heads + (layers - 1) * f * f) * n,
            n * (layers * f * ab + 2 * xb + 4 + 8 * 4) + wbytes + hbytes
            + 4 * (grad_elems + head_grads))


def matmul_chains(packed, mcfg, lane):
    """The trunk's products as torch.matmul calls in the packed weights'
    dtype, nothing else (the kernels' yardsticks): chain_fwd(x) -> (h,
    zsig), chain_k2(x) -> gx (chain_fwd, then the reverse chain), and
    chain_k3(cg, azb, hth, xtb): the tangent chain, the a chain and each
    layer's dW as [h; th]^T [a_z; b_tz] over both halves of K (azb, hth:
    (2 n, F); xtb: [x; cg])."""
    mids = list(packed["w_mid"])
    w0, wskip = packed["w0"], packed["w_skip"]
    wsig = packed["w_sigma"].to(w0.dtype)[:, None]

    def chain_fwd(x):
        h = x @ w0.t()
        m = 0
        for i in range(1, mcfg.layers):
            if i == mcfg.skips[0]:
                h = torch.cat([x, h], 1) @ wskip.t()
            else:
                h = h @ mids[m].t()
                m += 1
        return h, h @ wsig

    def chain_k2(x):
        g, _ = chain_fwd(x)
        m = len(mids) - 1
        gx = None
        for i in range(mcfg.layers - 1, 0, -1):
            if i == mcfg.skips[0]:
                gx = g @ wskip[:, :lane]
                g = g @ wskip[:, lane:]
            else:
                g = g @ mids[m]
                m -= 1
        return gx + g @ w0

    def chain_k3(cg, azb, hth, xtb):
        chain_fwd(cg)                               # the tangent chain
        a = azb[:cg.shape[0]]
        m = len(mids) - 1
        for i in range(mcfg.layers - 1, 0, -1):     # the a chain
            if i == mcfg.skips[0]:
                a = a @ wskip[:, lane:]
            else:
                a = a @ mids[m]
                m -= 1
        for i in range(mcfg.layers):                # the weight grads
            if i in (0, mcfg.skips[0]):
                xtb.t() @ azb
            if i > 0:
                hth.t() @ azb

    return chain_fwd, chain_k2, chain_k3


def width_model(feat: int, layers: int = 8, skip: int = 4,
                compute_dtype: str = "bfloat16_all", act: str = "poly",
                seed: int = 0, freqs: int = 0):
    """(ModelConfig, network) of spsbrdf-nerf with the flagship's heads at
    trunk width `feat`, `layers` layers with the skip at `skip`, the
    activation `act` (poly, sin, relu), `freqs` encoding frequencies (0:
    the default 10, 60 lanes), its weights from `seed`, on the card."""
    from ..config import ModelConfig
    from ..models.network import init_network
    enc = {"mapping_sizes": (freqs, 4)} if freqs else {}
    cfg = ModelConfig(variant="spsbrdf-nerf", mapping=True,
                      compute_dtype=compute_dtype, normal="analystic",
                      sun_v="analystic", func_m=True, func_f=True, func_h=1,
                      dim_rpv=1, layers=layers, feat=feat, skips=(skip,),
                      **ACTS[act], **enc)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, init_network(cfg, g, device="cuda")


def sum_length_scale(feat: int) -> float:
    """The factor on the width-512 rows' bounds at trunk width `feat`: 1 up
    to 512; past it every trunk product sums K = feat terms, whose
    rounding error grows like sqrt(K) ulp, so sqrt(feat / 512) (2 at the
    12 x 2048 trunk, whose K2 at bfloat16_all measured gx 1.18e-2 from its
    twin on an H100 at 700 W, 4,096 and 16,384 points, against the 512
    rows' 1e-2; at float32, with the accumulator flushed every 512
    products, 4.7e-5 against 1e-4)."""
    return max(1.0, (feat / 512) ** 0.5)


def held(kern, label, names, got, again, ref, dtype, act, report, b16=None,
         sum_scale=None, split=None, feat: int = 512):
    """Two launches' outputs `got` and `again` bit-identical, and held to
    the twin's `ref` at the module docstring's bounds for `dtype` (b16:
    the bfloat16_all kernel's outputs on the same inputs, for float32;
    split: K4's or K5's split twin's outputs), times sum_length_scale(feat)
    at the trunk width the kernel runs at."""
    same_twice(f"{kern} {label}", got, again)
    heads = kern[:2] in ("K4", "K5")
    s = sum_length_scale(feat)
    if dtype == "float32" and not (heads and act != "poly"):
        # past width 512 (the layer-major family), ReLU's kinked outputs
        # (act_check.bound_of: what an act' flip at z ~ 0 reaches) at
        # act_check's bound: on an H100 at 700 W the 4 x 768 ReLU trunk's
        # float32 gx sat 1.384e-3 from its exact twin; every other output,
        # and every output at width 512 and under, at F32_BOUND and the
        # ratio
        kinked = [i for i, nm in enumerate(names)
                  if feat > k1.FEAT
                  and bound_of(act, kern[:2], nm, F32_BOUND) > F32_BOUND]
        if kinked:
            _hold(f"{kern} {label} (ReLU's kinked outputs)",
                  [names[i] for i in kinked], [got[i] for i in kinked],
                  [ref[i] for i in kinked],
                  {names[i]: s * bound_of(act, kern[:2], names[i], F32_BOUND)
                   for i in kinked}, report)
        keep = [i for i in range(len(names)) if i not in kinked]
        hold_f32(f"{kern} {label}", [names[i] for i in keep],
                 [got[i] for i in keep], [b16[i] for i in keep],
                 [ref[i] for i in keep], report,
                 HEADS_CLOSER if heads else CLOSER,
                 None if split is None else [split[i] for i in keep],
                 sum_scale, s * F32_BOUND)
    else:
        b = (F32_BOUND if dtype == "float32" else
             K1_BOUND if kern.startswith("K1") else BF16_BOUND)
        _hold(f"{kern} {label}", names, got, ref,
              {nm: s * bound_of(act, kern[:2], nm, b) for nm in names},
              report, sum_scale)


def family_tag(cfg) -> str:
    """How K1-K5 run a model: "width F" where the fused kernels are built
    for it, else with the width and family they run it at
    (fused_mlp.kernel_cfg)."""
    kc = k1.kernel_cfg(cfg)
    fam = "layer-major" if k1.layer_major(kc) else "fused"
    tag = f"width {cfg.feat}"
    if kc.feat != cfg.feat or fam != "fused":
        tag += f" ({fam} at width {kc.feat})"
    if cfg.xyz_in_dim > k1.LANE:
        tag += f", {cfg.xyz_in_dim} lanes"
    return tag


def check_width(feat: int, layers: int, skip: int, act: str, n: int,
                seed: int = 0, report=None, freqs: int = 0):
    """K1 (with and without feats), K2 (serving, saving zs/us), K3, K4
    (serving, saving zs) and K5 of the configuration at `act` (`freqs` as
    width_model) and every dtype of DTYPES on n points, as the module
    docstring says; each at fused_mlp.kernel_cfg's width (zero-padded
    where it is not the model's), the fused or the layer-major family;
    returns the report dict."""
    report = {} if report is None else report
    cfg16, net = width_model(feat, layers, skip, "bfloat16_all", act, seed,
                             freqs)
    assert k1.cuda_kernels_cover(cfg16) and k1.act_of(cfg16) == act
    cfg16, logical = k1.kernel_cfg(cfg16), cfg16
    p16 = k1.pack_trunk_weights(net, cfg16, torch.bfloat16)
    hw16 = k4.pack_head_weights(net, cfg16, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    enc = points(cfg16, n, gen)
    tag = (f"{family_tag(logical)}, {layers} layers, skip {skip}, {act}, "
           f"{n} points")
    for dtype in DTYPES:
        cfg = dc.replace(cfg16, compute_dtype=dtype)
        packed = k1.pack_trunk_weights(net, cfg, k1.weight_dtype(cfg))
        sd = k2._saved_dtype(cfg)
        f32 = dtype == "float32"
        label = f"{tag}, {dtype}"
        for feats in (False, True):
            k = 1 + feats
            got = k1._trunk_sigma_cuda(packed, cfg, enc, feats)[:k]
            held(f"K1 (feats {feats})", label, ("sigma", "feats")[:k], got,
                 k1._trunk_sigma_cuda(packed, cfg, enc, feats)[:k],
                 k1._trunk_sigma_plain(packed, cfg, enc, feats)[:k], dtype,
                 act, report,
                 k1._trunk_sigma_cuda(p16, cfg16, enc, feats)[:k],
                 feat=cfg.feat)
        for want_zs in (False, True):
            names = ("sigma", "feats", "gx", "zs", "us")[:3 + 2 * want_zs]
            got = k2._trunk_fwd_grad_cuda(packed, cfg, enc, want_zs)
            assert got[2][:, cfg.xyz_in_dim:].abs().max().item() == 0.0
            held(f"K2 (zs/us {want_zs})", label, names, got,
                 k2._trunk_fwd_grad_cuda(packed, cfg, enc, want_zs),
                 k2._trunk_fwd_grad_plain(packed, cfg, enc, want_zs), dtype,
                 act, report,
                 k2._trunk_fwd_grad_cuda(p16, cfg16, enc, want_zs),
                 feat=cfg.feat)
            if not want_zs:
                k2_serving = got
        zs, us = got[3], got[4]
        assert zs.dtype == us.dtype == sd
        assert zs.shape == (n, layers * cfg.feat)
        cs, cf, cg = cotangents(cfg, n, gen, sd)
        bf = torch.bfloat16
        held("K3", label, K3_NAMES,
             k2._trunk_bwd_cuda(packed, cfg, enc, cs, cf, cg, zs, us),
             k2._trunk_bwd_cuda(packed, cfg, enc, cs, cf, cg, zs, us),
             k2._trunk_bwd_plain(packed, cfg, enc, cs, cf, cg, zs, us),
             dtype, act, report,
             k2._trunk_bwd_cuda(p16, cfg16, enc, cs, cf.to(bf), cg,
                                zs.to(bf), us.to(bf)) if f32 else None,
             dbsig_scale(packed, cfg, cs, cg, zs), feat=cfg.feat)
        check_heads(label, net, cfg, packed, p16, hw16, cfg16, enc, cg,
                    k2_serving, gen, act, report)
    return report


def check_heads(label, net, cfg, packed, p16, hw16, cfg16, enc, cg,
                k2_serving, gen, act, report):
    """K4 serving and saving zs, and K5 on K4's zs, at cfg's dtype and
    width on the points `enc`, as the module docstring says (k2_serving:
    K2's serving outputs on them; p16, hw16, cfg16: the bfloat16_all
    weights and configuration, for float32's ratio)."""
    n, f32 = enc.shape[0], cfg.compute_dtype == "float32"
    wide = k1.layer_major(cfg)
    hw = k4.pack_head_weights(net, cfg, k1.weight_dtype(cfg))
    for want_zs in (False, True):
        k = 2 + want_zs

        def fwd(p=packed, h=hw, c=cfg):
            return k4._trunk_heads_fwd_cuda(p, h, c, enc, want_zs)[:k]
        got = fwd()
        held(f"K4 (zs {want_zs})", label, ("out", "gx", "zs")[:k], got,
             fwd(), k4._trunk_heads_fwd_plain(packed, hw, cfg, enc,
                                              want_zs)[:k],
             cfg.compute_dtype, act, report,
             fwd(p16, hw16, cfg16) if f32 else None,
             split=k4._trunk_heads_fwd_split(packed, hw, cfg, enc,
                                             want_zs)[:k] if f32 else None,
             feat=cfg.feat)
        # K4 runs K2's trunk and chain with the same arithmetic
        assert torch.equal(got[0][:, 0], k2_serving[0]), (label, "K4 sigma")
        assert torch.equal(got[1], k2_serving[2]), (label, "K4 gx")
        assert got[0][:, 7].abs().max().item() == 0.0, (label, "K4 pad")
        assert got[1][:, cfg.xyz_in_dim:].abs().max().item() == 0.0
    fwd, zs = got, got[2]
    cot = torch.randn(n, k4.HEAD_COLS, device="cuda", generator=gen)
    cot[:, 7] = 0.0
    scratch = {}
    got = k4._trunk_heads_bwd_cuda(packed, hw, cfg, enc, cot, cg, zs,
                                   scratch_out=scratch)
    if wide:
        # the layer-major K5 keeps its last point block's chain, (block, L
        # F) f32 rows (n points: one block)
        assert scratch["block"] == n, scratch["block"]
        uc = scratch["uc"]
    else:
        uc = k4.uchain_from_kernel(scratch["uc"], n, cfg.layers, cfg.feat)
    e = rel_l2(uc, k4.uchain_plain(packed, cfg, zs))
    print(f"  K5 {label}: rebuilt b_th chain {e:.3e} relative L2 against "
          f"uchain_plain", flush=True)
    if not e <= sum_length_scale(cfg.feat) * UCHAIN_BOUND:
        MISSES.append(f"K5 {label} b_th chain: {e:.3e} > "
                      f"{sum_length_scale(cfg.feat) * UCHAIN_BOUND:g}")
    if wide:
        # [db_1; dW_2] against the sum of the column partials over the row
        # tiles ([tile][4][2 F]), the same f32 sums in another order
        s_ = scratch["hcp"].sum(0)
        have = (torch.cat([got[12], got[16]]),
                torch.cat([got[13][:, :3], got[17][:, :3]]).t())
        want = (s_[0], s_[1:])
    else:
        # the reduce kernel's head columns read the sweep's per-tile
        # partials in their layout (head_part): the same f32 sums in
        # another order
        want = k4.head_part_grads(scratch["part"], cfg.layers, cfg.feat)
        have = (got[10], torch.cat([got[12], got[16]]), got[13], got[14],
                got[17], got[18])
    e = max(rel_l2(h_, w_) for h_, w_ in zip(have, want))
    if not e <= PART_BOUND:
        MISSES.append(f"K5 {label} head partials: {e:.3e} > {PART_BOUND:g}")
    del scratch
    held("K5", label, K5_NAMES, got,
         k4._trunk_heads_bwd_cuda(packed, hw, cfg, enc, cot, cg, zs),
         k4._trunk_heads_bwd_plain(packed, hw, cfg, enc, cot, cg, zs),
         cfg.compute_dtype, act, report,
         k4._trunk_heads_bwd_cuda(p16, hw16, cfg16, enc, cot, cg,
                                  zs.to(torch.bfloat16)) if f32 else None,
         dbsig_scale(packed, cfg, cot[:, 0], cg, zs),
         k4._trunk_heads_bwd_split(packed, hw, cfg, enc, cot, cg, zs)
         if f32 else None, feat=cfg.feat)
    if wide:
        point_blocks(label, packed, hw, cfg, enc, cot, cg, fwd, got)


def point_blocks(label, packed, hw, cfg, enc, cot, cg, fwd, bwd):
    """The layer-major K4 and K5 walked over the points in blocks of
    trunk_layers.ROWS (a scratch budget that fits one block): K4's
    per-point outputs bit for bit those of the launch `fwd` (one block
    here), K5's gradients, sums over the blocks in order, within
    BLOCK_BOUND times sum_length_scale of `bwd`'s (the sigma head's bias
    gradient of its terms' L2 norm).  The check's fault side: K5 walked
    over all points but the last block (what a walk that drops that
    block's sum gives) must sit over the bound."""
    from ..ops import trunk_layers as tl
    if enc.shape[0] <= tl.ROWS:
        # one row tile is one point block whatever the budget: no walk
        print(f"  K4/K5 {label}: one point block, no walk to hold",
              flush=True)
        return
    budget, e = tl.BUDGET, enc.shape[1]
    drop = slice(0, enc.shape[0] - tl.ROWS)
    try:
        tl.BUDGET = tl.scratch_bytes("K4", cfg, e, tl.ROWS)
        got = k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc, True)
        tl.BUDGET = tl.scratch_bytes("K5", cfg, e, tl.ROWS)
        grads = k4._trunk_heads_bwd_cuda(packed, hw, cfg, enc, cot, cg,
                                         fwd[2])
        dropped = k4._trunk_heads_bwd_cuda(packed, hw, cfg, enc[drop],
                                           cot[drop], cg[drop], fwd[2][drop])
    finally:
        tl.BUDGET = budget
    same = all(torch.equal(a, b) for a, b in zip(got, fwd))
    # the sigma head's bias gradient, one sum of terms of either sign, on
    # its terms' L2 norm (as `held` holds it)
    i = K5_NAMES.index("dbsig")
    scale = dbsig_scale(packed, cfg, cot[:, 0], cg, fwd[2])

    def gap(have):
        return max([rel_l2(a, b) for j, (a, b) in enumerate(zip(have, bwd))
                    if j != i]
                   + [(have[i] - bwd[i]).abs().max().item() / scale])
    err, fault = gap(grads), gap(dropped)
    bound = BLOCK_BOUND * sum_length_scale(cfg.feat)
    print(f"  K4/K5 {label}, {enc.shape[0] // tl.ROWS} point blocks: K4 "
          f"{'bit for bit' if same else 'DIFFERS'}, K5 {err:.3e} relative "
          f"L2 from one block (bound {bound:g}; the last block dropped "
          f"{fault:.3e})", flush=True)
    if not same:
        MISSES.append(f"K4 {label}: point blocks change its outputs")
    if not err <= bound:
        MISSES.append(f"K5 {label} point blocks: {err:.3e} > {bound:g}")
    if not fault > bound:
        MISSES.append(f"K5 {label} point blocks: a dropped block "
                      f"{fault:.3e} within the bound {bound:g}")


# the layer-major family (ops/trunk_layers.py) and the padded widths:
# (width, layers, skip, activation, encoding frequencies; 0 the default
# 10): the 12 x 2048 trunk that tensor parallelism exists for; 4 x 768
# (skip 2) at the exact sine and at ReLU; a 144-lane encoding (24
# frequencies) at 4 x 128 and at 8 x 128 (skip 4, the flagship's depth:
# chip_smoke.py's 144-lane request and steps); and width 96, which the
# fused family runs at 128
LAYER_CONFIGS = ((2048, 12, 4, "poly", 0), (768, 4, 2, "sin", 0),
                 (768, 4, 2, "relu", 0), (128, 4, 2, "poly", 24),
                 (128, 8, 4, "poly", 24), (96, 8, 4, "poly", 0))
# their point counts: multiples of the layer-major tile (128), one block
# of the padded fused family's 64-point tiles and a few thousand; with the
# product's edge cases: 128 points (a block of one row tile) and 5,120 (a
# weight gradient of K = 10,240 at bfloat16_all, split-K slices of 8,192
# and a ragged 2,048; at float32 30,720, three of 8,192 and 6,144).
# Every size holds the products of fewer k-steps than ring stages (layer 0
# at 128 lanes: two of 64) and the skip layer's two segments (float32's
# six).
LAYER_SIZES = (128, 384, 4096, 5120)


def check_layers(sizes=LAYER_SIZES, report=None, configs=LAYER_CONFIGS):
    """check_width for every configuration of LAYER_CONFIGS at every size:
    the layer-major K1-K5 (and at width 96 the fused ones at 128) held to
    their twins at the bounds of the width-512 rows, twice bit-identical."""
    report = {} if report is None else report
    for n in sizes:
        for feat, layers, skip, act, freqs in configs:
            check_width(feat, layers, skip, act, n, report=report,
                        freqs=freqs)
    return report


def check_all(sizes=SIZES, report=None):
    """check_width for every configuration and size at the polynomial sine,
    and at width 64 (8 layers) at the exact sine and ReLU."""
    report = {} if report is None else report
    for n in sizes:
        for feat, layers, skip in CONFIGS:
            check_width(feat, layers, skip, "poly", n, report=report)
        for act in ACT_CONFIGS:
            check_width(64, 8, 4, act, n, report=report)
    return report


# the main paths' point counts (chip_smoke.py: 64 samples a ray, 5,120-ray
# chunks, 1,024-ray training batches)
N_SERVE_PASS, N_SERVE_MAIN, N_TRAIN_MAIN = 327680, 655360, 131072


# the kernels JSON line's name, source and Pallas kernel of each row kind,
# and the outputs held to the twin
ROW_KINDS = {
    "K1": ("trunk_sigma", "trunk_sigma.cu", "pallas_mlp.py:114",
           ("sigma",)),
    "K2": ("trunk_fwd_grad", "trunk_fwd_grad.cu", "pallas_trunk_vjp.py:205",
           ("sigma", "feats", "gx")),
    "K2zs": ("trunk_fwd_grad (saving zs/us)", "trunk_fwd_grad.cu",
             "pallas_trunk_vjp.py:205",
             ("sigma", "feats", "gx", "zs", "us")),
    "K3": ("trunk_bwd", "trunk_bwd.cu", "pallas_trunk_vjp.py:240", K3_NAMES),
    "K4": ("trunk_heads_fwd", "trunk_heads_fwd.cu",
           "pallas_trunk_heads.py:154", ("out", "gx")),
    "K4zs": ("trunk_heads_fwd (saving zs)", "trunk_heads_fwd.cu",
             "pallas_trunk_heads.py:154", ("out", "gx", "zs")),
    "K5": ("trunk_heads_bwd", "trunk_heads_bwd.cu",
           "pallas_trunk_heads.py:185", K5_NAMES),
}


def timed_row(rows, kern, cfg, n, work, peaks, fn, twin, library, report,
              b16=None, sum_scale=None, kinds=None, reps=(10, 1, 5),
              held_rows=None, twin_time=None):
    """Row "<kern> <dtype> f<feat>" of the kernels JSON line: fn (the
    kernel) launched twice bit-identical and held to `twin` at
    check_width's bounds (`held`; b16, sum_scale as there), timed beside
    its twin and `library` (the torch.matmul chain of the same products;
    `reps` calls of each after one; reps[1] 0: the twin, which takes
    seconds at the layer-major rows' shapes, timed on one call, the one
    held against the kernel where it runs on every point), with the bound
    of `work` = (FLOPs,
    bytes) at `peaks` (at float32 also the bound of three products for
    each) and the largest difference from the twin.  kinds: the row
    kinds' names and sources (ROW_KINDS; LAYER_ROW_KINDS for the
    layer-major family).  held_rows: hold only the first held_rows points
    of a kernel whose outputs are per point (`twin` computes those, and
    `twin_time` the twin on every point, timed in its place)."""
    dtype, feat = cfg.compute_dtype, cfg.feat
    name, source, replaces, outs = (kinds or ROW_KINDS)[kern]
    key = f"{kern} {dtype} f{feat}"
    label = f"width {feat}, {dtype}, {n} points (main shape)"
    # one launch's outputs at a time beside `got` (the 12 x 2048 rows' f32
    # zs/us are 12.9 GB each): the second launch compared and dropped
    # before the bfloat16_all kernel's and the twin's outputs are made
    got, again = fn(), fn()
    same_twice(f"{kern} {label}", got, again)
    del again

    def rows_of(out):
        if held_rows is None:
            return out
        return tuple(None if v is None else v[:held_rows].clone()
                     for v in out)
    got = rows_of(got)
    if held_rows is not None:
        label += f", the first {held_rows} held"
    b = None if b16 is None else rows_of(b16())
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    ref = twin()
    e1.record()
    torch.cuda.synchronize()
    if reps[1]:
        plain_ms = timed(twin if twin_time is None else twin_time, reps[1])
    elif twin_time is None:
        plain_ms = e0.elapsed_time(e1)
    else:
        e0.record()
        twin_time()
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
    held(kern, label, outs, got, got, ref, dtype, "poly", report, b,
         sum_scale, feat=feat)
    err = max((g_.float() - r_.float()).abs().max().item()
              for g_, r_ in zip(got, ref) if g_ is not None)
    del got, ref, b
    r = {"name": f"{name} [width {feat}, {dtype}]", "route": "cuda",
         "source": "brdfnerf_tpu_torch/csrc/" + source,
         "replaces": "brdfnerf_tpu/ops/" + replaces, "width": feat,
         "dtype": dtype, "points": n, "max_abs_err": err,
         "ms": timed(fn, reps[0]), "plain_ms": plain_ms,
         "library_ms": timed(library, reps[2])}
    r["bound_ms"], r["bound_by"] = bound_ms(*work, peaks)
    if dtype == "float32":
        r["bound_split_ms"], _ = bound_ms(3 * work[0], work[1], peaks)
    rows[key] = r
    print(f"  {key}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} by "
          f"{r['bound_by']}, twin {r['plain_ms']:.1f}, matmul chain "
          f"{r['library_ms']:.3f}) at {n} points; largest |kernel - "
          f"twin| {err:.3e}", flush=True)


def weight_bytes(w: dict, planes) -> int:
    """The bytes of the packed weights `w` a kernel reads (at float32 the
    hi and lo planes, `planes`' keys, in the f32 weights' bytes)."""
    return sum(v.numel() * v.element_size() for k, v in w.items()
               if k not in planes)


def kernel_rows(rows: dict, feat: int, peaks, seed: int = 0, report=None):
    """Rows of the kernels JSON line for K1-K3 at width `feat` (8 layers,
    skip 4), keyed "<K1|K2|K2zs|K3> <dtype> f<feat>": each instantiation at
    its main shape (K1 at N_SERVE_PASS points, K2 at N_SERVE_MAIN, K2
    saving zs/us and K3 at N_TRAIN_MAIN; at bfloat16 only the last two,
    whose f32 zs/us set them apart), as timed_row makes it, beside the
    chain of torch.matmul calls of the same products in the weights' dtype
    (matmul_chains), its bound from the work and traffic these inputs need
    (trunk_work).  Launches are the main path's, filled in by the caller."""
    from ..ops.fused_mlp import LANE
    report = {} if report is None else report
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    cfg16, net = width_model(feat, seed=seed)
    p16 = k1.pack_trunk_weights(net, cfg16, torch.bfloat16)
    bf = torch.bfloat16
    for dtype in DTYPES:
        cfg = dc.replace(cfg16, compute_dtype=dtype)
        packed = k1.pack_trunk_weights(net, cfg, k1.weight_dtype(cfg))
        wbytes = weight_bytes(packed, k1.PLANE_KEYS.values())
        chain_fwd, chain_k2, chain_k3 = matmul_chains(packed, cfg, LANE)

        def row(kern, fn, twin, library, n, b16=None, sum_scale=None):
            timed_row(rows, kern, cfg, n, trunk_work(kern, cfg, n, wbytes),
                      peaks, fn, twin, library, report, b16, sum_scale)

        # the chains' operands in the weights' dtype
        ob = torch.float32 if dtype == "float32" else torch.bfloat16
        f32 = dtype == "float32"
        if dtype != "bfloat16":
            n = N_SERVE_PASS
            enc = points(cfg, n, gen)
            if f32:
                chain1 = lambda: chain_fwd(enc)                # noqa: E731
            else:
                # K1's fidelity: the hi and the lo chain, summed
                hi, lo = k1.split_bf16(enc)
                chain1 = (lambda: chain_fwd(hi)[0]             # noqa: E731
                          + chain_fwd(lo)[0])
            row("K1",
                lambda: k1._trunk_sigma_cuda(packed, cfg, enc, False)[:1],
                lambda: k1._trunk_sigma_plain(packed, cfg, enc, False)[:1],
                chain1, n,
                (lambda: k1._trunk_sigma_cuda(p16, cfg16, enc, False)[:1])
                if f32 else None)
            n = N_SERVE_MAIN
            enc = points(cfg, n, gen)
            gx = k2._trunk_fwd_grad_cuda(packed, cfg, enc)[2]
            assert gx[:, cfg.xyz_in_dim:].abs().max().item() == 0.0
            del gx
            encb = enc.to(ob)
            row("K2", lambda: k2._trunk_fwd_grad_cuda(packed, cfg, enc),
                lambda: k2._trunk_fwd_grad_plain(packed, cfg, enc),
                lambda: chain_k2(encb), n,
                (lambda: k2._trunk_fwd_grad_cuda(p16, cfg16, enc))
                if f32 else None)
        n = N_TRAIN_MAIN
        enc = points(cfg, n, gen)
        encb = enc.to(ob)
        row("K2zs", lambda: k2._trunk_fwd_grad_cuda(packed, cfg, enc, True),
            lambda: k2._trunk_fwd_grad_plain(packed, cfg, enc, True),
            lambda: chain_k2(encb), n,
            (lambda: k2._trunk_fwd_grad_cuda(p16, cfg16, enc, True))
            if f32 else None)
        zs, us = k2._trunk_fwd_grad_cuda(packed, cfg, enc, True)[3:]
        cs, cf, cg = cotangents(cfg, n, gen, k2._saved_dtype(cfg))
        hth = torch.randn(2 * n, feat, device="cuda", generator=gen).to(ob)
        azb = torch.randn(2 * n, feat, device="cuda", generator=gen).to(ob)
        xtb = torch.cat([enc, cg], 0).to(ob)
        cgb = cg.to(ob)
        row("K3", lambda: k2._trunk_bwd_cuda(packed, cfg, enc, cs, cf, cg,
                                             zs, us),
            lambda: k2._trunk_bwd_plain(packed, cfg, enc, cs, cf, cg, zs,
                                        us),
            lambda: chain_k3(cgb, azb, hth, xtb), n,
            (lambda: k2._trunk_bwd_cuda(p16, cfg16, enc, cs, cf.to(bf), cg,
                                        zs.to(bf), us.to(bf)))
            if f32 else None,
            dbsig_scale(packed, cfg, cs, cg, zs))
        del enc, encb, zs, us, cs, cf, cg, hth, azb, xtb, cgb
    return rows


# the layer-major rows' names and sources (layer_rows), as ROW_KINDS
LAYER_ROW_KINDS = {
    k: (f"trunk_layers {k[:2]}" + {"K2zs": " (saving zs/us)",
                                   "K4zs": " (saving zs)"}.get(k, ""),
        "trunk_layers.cu", v[2], v[3])
    for k, v in ROW_KINDS.items()}
# the head weights the layer-major K4 and K5 read (pack_head_weights at a
# layer-major width: W_f, the merged first layers, the second layers over
# them, and their biases)
LAYER_HEAD_KEYS = ("wf", "bf", "w1", "b1", "w2", "b2")
# the twins' point chunk at the layer-major rows' shapes (the 12 x 2048
# twin of K2 holds ~0.4 MB a point, of K3 ~0.6 MB: a few GB a chunk), and
# the points at which a per-point row is held to its twin (the kernel runs
# at the main shape: its float32 zs and us are 12.9 GB each)
TWIN_CHUNK = 8192
TWIN_ROWS = 16384


def chunked_twin(fn, n: int, *rows, chunk: int = TWIN_CHUNK, summed=False,
                 keep=True):
    """fn over `rows` (tensors of n rows) in chunks of `chunk` points: with
    `summed` (a weight gradient, a sum over the points) the outputs added
    in order; without, (with `keep`) concatenated, or (keep=False) dropped,
    for the twin's time at a shape whose outputs are not kept whole.  The
    twin of a kernel whose main shape does not fit the twin's
    intermediates whole."""
    out = []
    for i in range(0, n, chunk):
        part = fn(*(r[i:i + chunk] for r in rows))
        if summed:
            out = list(part) if not out else [o + p_ for o, p_ in
                                               zip(out, part)]
        elif keep:
            out.append(part)
        del part
    if summed or not keep:
        return tuple(out)
    return tuple(None if v[0] is None else torch.cat(v)
                 for v in zip(*out))


def layer_rows(rows: dict, peaks, feat: int = 2048, layers: int = 12,
               skip: int = 4, dtypes=DTYPES, seed: int = 0, report=None,
               reps=(2, 0, 3),
               kinds=("K1", "K2", "K2zs", "K3", "K4", "K4zs", "K5")):
    """Rows of the kernels JSON line for the layer-major K1-K5 at
    `layers` x `feat` (skip `skip`; default the 12 x 2048 trunk), keyed
    "<K1|K2|K2zs|K3> <dtype> f<feat>", as kernel_rows makes the fused
    family's: each at its main shape (K1 at N_SERVE_PASS points, K2 at
    N_SERVE_MAIN, K2 saving zs/us and K3 at N_TRAIN_MAIN; at bfloat16 the
    last two), and the layer-major K4 and K5 keyed "<K4|K4zs|K5> <dtype>
    f<feat>" as heads_rows makes the fused pair's (K4 at N_SERVE_MAIN, K4
    saving zs and K5 on its zs at N_TRAIN_MAIN; at bfloat16 the last two),
    launched twice bit-identical, held to its twin at check_width's bounds
    (K1, K2 and K4, whose outputs are per point, on the first TWIN_ROWS
    points; K3 and K5, sums over the points, whole, their twins run in
    chunks: chunked_twin), and timed beside the twin on every point (in
    chunks), the torch.matmul chain of the same products (matmul_chains,
    heads_chains) and its bound (trunk_work, with the heads' weight bytes
    for K4 and K5).  kinds: the rows to make (each of the seven by
    default); reps: timed_row's."""
    from ..ops.fused_mlp import LANE
    report = {} if report is None else report
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    cfg16, net = width_model(feat, layers, skip, seed=seed)
    assert k1.layer_major(k1.kernel_cfg(cfg16)), "not a layer-major width"
    p16 = k1.pack_trunk_weights(net, cfg16, torch.bfloat16)
    hw16 = k4.pack_head_weights(net, cfg16, torch.bfloat16)
    bf = torch.bfloat16
    for dtype in dtypes:
        cfg = dc.replace(cfg16, compute_dtype=dtype)
        wd = k1.weight_dtype(cfg)
        packed = k1.pack_trunk_weights(net, cfg, wd)
        hw = k4.pack_head_weights(net, cfg, wd)
        wbytes = weight_bytes(packed, k1.PLANE_KEYS.values())
        hbytes = sum(hw[k].numel() * hw[k].element_size()
                     for k in LAYER_HEAD_KEYS)
        chain_fwd, chain_k2, chain_k3 = matmul_chains(packed, cfg, LANE)
        chain_heads, chain_k5_heads = heads_chains(packed, hw, cfg, LANE)

        def row(kern, fn, twin, library, n, b16=None, sum_scale=None,
                twin_time=None):
            if kern in kinds:
                timed_row(rows, kern, cfg, n,
                          trunk_work(kern, cfg, n, wbytes,
                                     hbytes if kern[:2] in ("K4", "K5")
                                     else 0),
                          peaks, fn, twin,
                          library, report, b16, sum_scale, LAYER_ROW_KINDS,
                          reps, None if twin_time is None else TWIN_ROWS,
                          twin_time)
        m = TWIN_ROWS

        ob = torch.float32 if dtype == "float32" else torch.bfloat16
        f32 = dtype == "float32"
        if dtype != "bfloat16" and {"K1", "K2"} & set(kinds):
            n = N_SERVE_PASS
            enc = points(cfg, n, gen)
            if f32:
                chain1 = lambda: chain_fwd(enc)                # noqa: E731
            else:
                hi, lo = k1.split_bf16(enc)
                chain1 = (lambda: chain_fwd(hi)[0]             # noqa: E731
                          + chain_fwd(lo)[0])
            row("K1",
                lambda: k1._trunk_sigma_cuda(packed, cfg, enc, False)[:1],
                lambda: k1._trunk_sigma_plain(packed, cfg, enc[:m],
                                              False)[:1],
                chain1, n,
                (lambda: k1._trunk_sigma_cuda(p16, cfg16, enc, False)[:1])
                if f32 else None,
                twin_time=lambda: chunked_twin(
                    lambda x: k1._trunk_sigma_plain(packed, cfg, x, False),
                    n, enc, keep=False))
            del enc, chain1
            n = N_SERVE_MAIN
            enc = points(cfg, n, gen)
            encb = enc.to(ob)
            row("K2", lambda: k2._trunk_fwd_grad_cuda(packed, cfg, enc),
                lambda: k2._trunk_fwd_grad_plain(packed, cfg, enc[:m]),
                lambda: chain_k2(encb), n,
                (lambda: k2._trunk_fwd_grad_cuda(p16, cfg16, enc))
                if f32 else None,
                twin_time=lambda: chunked_twin(
                    lambda x: k2._trunk_fwd_grad_plain(packed, cfg, x), n,
                    enc, keep=False))
            del enc, encb
        n = N_TRAIN_MAIN
        enc = points(cfg, n, gen)
        encb = enc.to(ob)
        row("K2zs", lambda: k2._trunk_fwd_grad_cuda(packed, cfg, enc, True),
            lambda: k2._trunk_fwd_grad_plain(packed, cfg, enc[:m], True),
            lambda: chain_k2(encb), n,
            (lambda: k2._trunk_fwd_grad_cuda(p16, cfg16, enc, True))
            if f32 else None,
            twin_time=lambda: chunked_twin(
                lambda x: k2._trunk_fwd_grad_plain(packed, cfg, x, True), n,
                enc, keep=False))
        cs, cf, cg = cotangents(cfg, n, gen, k2._saved_dtype(cfg))
        hth = torch.randn(2 * n, feat, device="cuda", generator=gen).to(ob)
        azb = torch.randn(2 * n, feat, device="cuda", generator=gen).to(ob)
        xtb = torch.cat([enc, cg], 0).to(ob)
        cgb = cg.to(ob)
        if "K3" in kinds:
            zs, us = k2._trunk_fwd_grad_cuda(packed, cfg, enc, True)[3:]
            row("K3", lambda: k2._trunk_bwd_cuda(packed, cfg, enc, cs, cf,
                                                 cg, zs, us),
                lambda: chunked_twin(lambda *r_: k2._trunk_bwd_plain(
                    packed, cfg, *r_), n, enc, cs, cf, cg, zs, us,
                    summed=True),
                lambda: chain_k3(cgb, azb, hth, xtb), n,
                (lambda: k2._trunk_bwd_cuda(p16, cfg16, enc, cs, cf.to(bf),
                                            cg, zs.to(bf), us.to(bf)))
                if f32 else None,
                dbsig_scale_chunked(packed, cfg, cs, cg, zs))
            del zs, us
        del cs, cf
        if not {"K4", "K4zs", "K5"} & set(kinds):
            continue
        # the heads: K4 serving, K4 saving zs, K5 on its zs
        hid = feat // 2
        if dtype != "bfloat16" and "K4" in kinds:
            ns = N_SERVE_MAIN
            enc_s = points(cfg, ns, gen)
            encb_s = enc_s.to(ob)
            hb_s = torch.randn(ns, feat, device="cuda", generator=gen).to(ob)
            row("K4", lambda: k4._trunk_heads_fwd_cuda(packed, hw, cfg,
                                                       enc_s)[:2],
                lambda: k4._trunk_heads_fwd_plain(packed, hw, cfg,
                                                  enc_s[:m])[:2],
                lambda: (chain_k2(encb_s), chain_heads(hb_s)), ns,
                (lambda: k4._trunk_heads_fwd_cuda(p16, hw16, cfg16,
                                                  enc_s)[:2])
                if f32 else None,
                twin_time=lambda: chunked_twin(
                    lambda x: k4._trunk_heads_fwd_plain(packed, hw, cfg, x),
                    ns, enc_s, keep=False))
            del enc_s, encb_s, hb_s
        hb = torch.randn(n, feat, device="cuda", generator=gen).to(ob)
        row("K4zs", lambda: k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc,
                                                     True),
            lambda: k4._trunk_heads_fwd_plain(packed, hw, cfg, enc[:m],
                                              True),
            lambda: (chain_k2(encb), chain_heads(hb)), n,
            (lambda: k4._trunk_heads_fwd_cuda(p16, hw16, cfg16, enc, True))
            if f32 else None,
            twin_time=lambda: chunked_twin(
                lambda x: k4._trunk_heads_fwd_plain(packed, hw, cfg, x,
                                                    True), n, enc,
                keep=False))
        if "K5" in kinds:
            zs = k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc, True)[2]
            cot = torch.randn(n, k4.HEAD_COLS, device="cuda", generator=gen)
            cot[:, 7] = 0.0
            czb = torch.randn(n, 4 * hid, device="cuda",
                              generator=gen).to(ob)
            ubt = torch.randn(n, feat, device="cuda", generator=gen).to(ob)

            def chain_k5():
                chain_k3(cgb, azb, hth, xtb)
                chain_k5_heads(hb, czb, ubt)
            row("K5", lambda: k4._trunk_heads_bwd_cuda(packed, hw, cfg, enc,
                                                       cot, cg, zs),
                lambda: chunked_twin(lambda *r_: k4._trunk_heads_bwd_plain(
                    packed, hw, cfg, *r_), n, enc, cot, cg, zs, summed=True),
                chain_k5, n,
                (lambda: k4._trunk_heads_bwd_cuda(p16, hw16, cfg16, enc, cot,
                                                  cg, zs.to(bf)))
                if f32 else None,
                dbsig_scale_chunked(packed, cfg, cot[:, 0], cg, zs))
            del zs, cot, czb, ubt
        del enc, encb, hb, cg, hth, azb, xtb, cgb
    return rows


def dbsig_scale_chunked(packed, cfg, cs, cg, zs, chunk: int = TWIN_CHUNK):
    """f32_check.dbsig_scale over the points in chunks: the L2 norm of
    the sigma head's bias gradient's per-point terms."""
    total = 0.0
    for i in range(0, cs.shape[0], chunk):
        total += dbsig_scale(packed, cfg, cs[i:i + chunk], cg[i:i + chunk],
                             zs[i:i + chunk]) ** 2
    return total ** 0.5


def heads_chains(packed, hw, mcfg, lane):
    """The head block's products as torch.matmul calls in the packed
    weights' dtype, beside matmul_chains' (K4's and K5's yardsticks):
    chain_heads(hb): xf, the first layers and the 3-column second layers
    from features hb; chain_k5_heads(hb, czb, ubt): the rebuilt u chain
    from ubt (L - 1 products of F x F), xf and z1 again, a_xf = c_z1 W_1
    from czb, a_xf W_f, and the outer products of dW_f and dW_1."""
    hid = mcfg.feat // 2
    wf, w1 = hw["wf"], torch.cat([hw["w1r"], hw["w1p"]])
    w2r, w2p = hw["w2r"][:3], hw["w2p"][:3]
    mids = list(packed["w_mid"])

    def chain_heads(hb):
        xf = hb @ wf.t()
        z1 = xf @ w1.t()
        return z1[:, :hid] @ w2r.t(), z1[:, hid:] @ w2p.t()

    def chain_k5_heads(hb, czb, ubt):
        u = ubt                                     # the b_th chain
        m = len(mids) - 1
        for i in range(mcfg.layers - 1, 0, -1):
            if i == mcfg.skips[0]:
                u = u @ packed["w_skip"][:, lane:]
            else:
                u = u @ mids[m]
                m -= 1
        xf = hb @ wf.t()
        xf @ w1.t()
        axf = czb @ w1
        axf @ wf
        hb.t() @ axf
        xf.t() @ czb

    return chain_heads, chain_k5_heads


def heads_rows(rows: dict, feat: int, peaks, seed: int = 0, report=None):
    """Rows of the kernels JSON line for K4 and K5 at width `feat` (8
    layers, skip 4), keyed "<K4|K4zs|K5> <dtype> f<feat>", as kernel_rows
    makes K1-K3's: K4 at N_SERVE_MAIN points, K4 saving zs and K5 (on
    K4's zs) at N_TRAIN_MAIN, at bfloat16 only the last two; each beside
    the chain of the trunk's products and the heads' (heads_chains), its
    bound from trunk_work with the heads' weight bytes."""
    from ..ops.fused_mlp import LANE
    report = {} if report is None else report
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    cfg16, net = width_model(feat, seed=seed)
    p16 = k1.pack_trunk_weights(net, cfg16, torch.bfloat16)
    hw16 = k4.pack_head_weights(net, cfg16, torch.bfloat16)
    hid = feat // 2
    for dtype in DTYPES:
        cfg = dc.replace(cfg16, compute_dtype=dtype)
        wd = k1.weight_dtype(cfg)
        packed = k1.pack_trunk_weights(net, cfg, wd)
        hw = k4.pack_head_weights(net, cfg, wd)
        wbytes = weight_bytes(packed, k1.PLANE_KEYS.values())
        hbytes = weight_bytes(hw, k4.HEAD_PLANE_KEYS.values())
        _, chain_k2, chain_k3 = matmul_chains(packed, cfg, LANE)
        chain_heads, chain_k5_heads = heads_chains(packed, hw, cfg, LANE)

        def row(kern, fn, twin, library, n, b16=None, sum_scale=None):
            timed_row(rows, kern, cfg, n,
                      trunk_work(kern, cfg, n, wbytes, hbytes), peaks, fn,
                      twin, library, report, b16, sum_scale)

        ob = torch.float32 if dtype == "float32" else torch.bfloat16
        f32 = dtype == "float32"
        if dtype != "bfloat16":
            n = N_SERVE_MAIN
            enc = points(cfg, n, gen)
            encb = enc.to(ob)
            hb = torch.randn(n, feat, device="cuda", generator=gen).to(ob)
            row("K4", lambda: k4._trunk_heads_fwd_cuda(packed, hw, cfg,
                                                       enc)[:2],
                lambda: k4._trunk_heads_fwd_plain(packed, hw, cfg, enc)[:2],
                lambda: (chain_k2(encb), chain_heads(hb)), n,
                (lambda: k4._trunk_heads_fwd_cuda(p16, hw16, cfg16,
                                                  enc)[:2])
                if f32 else None)
            del enc, encb, hb
        n = N_TRAIN_MAIN
        enc = points(cfg, n, gen)
        encb = enc.to(ob)
        hb = torch.randn(n, feat, device="cuda", generator=gen).to(ob)
        row("K4zs", lambda: k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc,
                                                     True),
            lambda: k4._trunk_heads_fwd_plain(packed, hw, cfg, enc, True),
            lambda: (chain_k2(encb), chain_heads(hb)), n,
            (lambda: k4._trunk_heads_fwd_cuda(p16, hw16, cfg16, enc, True))
            if f32 else None)
        zs = k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc, True)[2]
        _, _, cg = cotangents(cfg, n, gen, k2._saved_dtype(cfg))
        cot = torch.randn(n, k4.HEAD_COLS, device="cuda", generator=gen)
        cot[:, 7] = 0.0
        hth = torch.randn(2 * n, feat, device="cuda", generator=gen).to(ob)
        azb = torch.randn(2 * n, feat, device="cuda", generator=gen).to(ob)
        czb = torch.randn(n, 4 * hid, device="cuda", generator=gen).to(ob)
        ubt = torch.randn(n, feat, device="cuda", generator=gen).to(ob)
        xtb = torch.cat([enc, cg], 0).to(ob)
        cgb = cg.to(ob)

        def chain_k5():
            chain_k3(cgb, azb, hth, xtb)
            chain_k5_heads(hb, czb, ubt)
        row("K5", lambda: k4._trunk_heads_bwd_cuda(packed, hw, cfg, enc, cot,
                                                   cg, zs),
            lambda: k4._trunk_heads_bwd_plain(packed, hw, cfg, enc, cot, cg,
                                              zs),
            chain_k5, n,
            (lambda: k4._trunk_heads_bwd_cuda(p16, hw16, cfg16, enc, cot,
                                              cg, zs.to(torch.bfloat16)))
            if f32 else None,
            dbsig_scale(packed, cfg, cot[:, 0], cg, zs))
        del enc, encb, hb, zs, cg, cot, hth, azb, czb, ubt, xtb, cgb
    return rows


def main(argv=None) -> int:
    from .fwd_variants import card
    argv = sys.argv[1:] if argv is None else argv
    nums = tuple(int(a) for a in argv if a.isdigit())
    times = "--times" in argv
    layers = "--layers" in argv
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card(), flush=True)
    from ..ops import cuda_build
    cuda_build.build(libraries())
    for name, rec in cuda_build.build_log.items():
        print(f"  built {name} in {rec['seconds']:.1f} s", flush=True)
        if name.startswith("trunk_layers"):
            print(rec["log"], flush=True)
    report, rows = {}, {}
    if layers:
        check_layers(nums or LAYER_SIZES, report)
    elif times:
        peaks = peaks_of(torch.cuda.get_device_name(0))
        for feat in nums or WIDTHS:
            if feat > k1.FEAT:
                layer_rows(rows, peaks, feat, report=report)
                continue
            kernel_rows(rows, feat, peaks, report=report)
            heads_rows(rows, feat, peaks, report=report)
    else:
        check_all(nums or SIZES, report)
    print(json.dumps({"card": card(), "checks": report, "rows": rows,
                      "misses": MISSES}))
    return 1 if MISSES else 0


def libraries():
    """The library keys of K1-K5 at every width of WIDTHS: the polynomial
    sine at each, and at width 64 the exact sine and ReLU too
    (ops/cuda_build.library_key); then the layer-major family's
    (csrc/trunk_layers.cu) at each activation."""
    from ..ops import cuda_build
    return [cuda_build.library_key(lib, act, feat)
            for feat in WIDTHS
            for act in (("poly",) + tuple(ACT_CONFIGS) if feat == 64
                        else ("poly",))
            for lib in ("trunk_sigma", "trunk_fwd_grad", "trunk_bwd",
                        "trunk_heads_fwd", "trunk_heads_bwd")] + [
        cuda_build.library_key("trunk_layers", act) for act in ACTS]


if __name__ == "__main__":
    sys.exit(main())
