"""The float32 and mixed-bfloat16 instantiations of the trunk kernels on the
card, held against their plain twins.

    python3 -m brdfnerf_tpu_torch.tools.f32_check [points ...]
    python3 -m brdfnerf_tpu_torch.tools.f32_check --wgrad [points] [splits ...]

At each size (default 192: 3 tiles, a ragged last wave), on the flagship
trunk (8 x 512, skip 4) from seed 0:
  * compute_dtype float32 (every product as three on the bf16 hi and lo
    terms of its f32 operands): K1 with and without feats, K2 serving, K2
    saving zs/us, K3, K4 serving, K4 saving zs and K5, each launched twice
    with bit-identical outputs, against its exact-f32 twin on the same
    inputs (TF32 off), to F32_BOUND relative L2 on every output; beside
    each, the bfloat16_all kernel's output for the same inputs against the
    same twin, which the float32 kernel must beat by CLOSER times (K4/K5:
    HEADS_CLOSER); K4/K5 also against their split twins (the kernels'
    own arithmetic in plain PyTorch), and K4's sigma and gx bit for bit
    K2's;
  * compute_dtype bfloat16 (bf16 operands, f32 activations, zs/us saved
    in f32): K2 saving zs/us -> K3, and K4 saving zs -> K5, against their
    twins at the bfloat16_all instantiations' bounds in chip_smoke.py.
Prints the card's name and power limit first and a JSON summary last.
chip_smoke.py runs the same checks at the main paths' shapes.

--wgrad reads what the float32 weight gradients lose to the length of K
an accumulator sums (default 131,072 points, the training step's): K3 at
float32 with the trunk's K cut into each given number of slices (default
1, 11, 32, 96 and the package's choice, wgrad_splits), its dW_0 against
the float64 sum of the three products of its own hi and lo operands
(from its scratch), and against the exact twin.
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops import fused_mlp as k1
from ..ops import fused_trunk_heads as k4
from ..ops import fused_trunk_vjp as k2

# The split products leave each product within 2^-16 of its exact value
# (about 2^-17 as a rule), against f32's 2^-24: 1e-4 relative L2 on every
# output leaves room for the siren's first layer (omega_0 = 30) and eight
# layers of products
F32_BOUND = 1e-4
# ... and the float32 kernel must be at least this many times closer to the
# exact twin than the bfloat16_all kernel
CLOSER = 10.0
# ... K4 and K5 (their float32 instantiations came later, with this bound
# from the start; K1-K3 measured 370-524 times)
HEADS_CLOSER = 100.0
# K5's outputs that no product enters (the logits' bias grads: column sums
# of the cotangents, the same f32 sums at every dtype), held to F32_BOUND
# but to no ratio
SUMS_ONLY = ("db2r", "db2p")
K3_NAMES = ("dw0", "db0", "dwm", "dbm", "dwst", "dwsb", "dbs", "dwsig",
            "dbsig")
K5_NAMES = K3_NAMES + ("dwf", "dbf", "dw1r", "db1r", "dw2r", "db2r", "dw1p",
                       "db1p", "dw2p", "db2p")


def rel_l2(got, ref) -> float:
    ref = ref.float()
    return ((got.float() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def flagship(compute_dtype: str, seed: int = 0, siren: bool = True,
             fast_sin: bool = True):
    """(ModelConfig, network) of the flagship spsbrdf-nerf at
    compute_dtype (and activation: siren, fast_sin), its weights from
    `seed`, on the card."""
    from ..config import ModelConfig
    from ..models.network import init_network
    cfg = ModelConfig(variant="spsbrdf-nerf", siren=siren, mapping=True,
                      compute_dtype=compute_dtype, normal="analystic",
                      sun_v="analystic", func_m=True, func_f=True, func_h=1,
                      dim_rpv=1, fast_sin=fast_sin)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, init_network(cfg, g, device="cuda")


def with_dtype(cfg, compute_dtype: str):
    import dataclasses as dc
    return dc.replace(cfg, compute_dtype=compute_dtype)


def points(cfg, n: int, gen):
    from ..ops.encoding import positional_encoding
    xyz = torch.rand(n, 3, device="cuda", generator=gen) * 2 - 1
    return positional_encoding(xyz, cfg.mapping_sizes[0], fast=True,
                               pad_to=k1._round_up(cfg.xyz_in_dim, k1.LANE))


def cotangents(cfg, n: int, gen, dtype):
    """(c_sigma, c_feats in dtype, c_g at the padded lane width)."""
    cs = torch.randn(n, device="cuda", generator=gen)
    cf = (torch.randn(n, cfg.feat, device="cuda", generator=gen)
          * 0.1).to(dtype)
    cg = torch.zeros(n, k1._round_up(cfg.xyz_in_dim, k1.LANE),
                     device="cuda")
    cg[:, :cfg.xyz_in_dim] = torch.randn(n, cfg.xyz_in_dim, device="cuda",
                                         generator=gen)
    return cs, cf, cg


def same_twice(label, first, second):
    torch.cuda.synchronize()
    for i, (a_, b_) in enumerate(zip(first, second)):
        assert torch.equal(a_, b_), f"{label}: output {i} differs between " \
                                    "launches"


def hold_f32(label, names, got, bf16, ref, report, closer=CLOSER,
             split=None, sum_scale=None, bound=F32_BOUND):
    """Every output of a float32 kernel within `bound` (F32_BOUND) of its
    exact twin (and of its split twin, where given), and `closer` times closer
    than the bfloat16_all kernel's; returns the largest relative L2 and
    the smallest ratio.  With `sum_scale` (dbsig_scale) the sigma head's
    bias gradient is measured against its terms' L2 norm (dbsig_error),
    as the bfloat16 contract measures it, its relative L2 printed beside,
    and its ratio held to K3's CLOSER where `closer` asks more (K5's sigma
    head is K3's sweep's; on that norm the bf16 error is small too)."""
    worst, ratio = 0.0, float("inf")
    split = [None] * len(names) if split is None else split
    for name, g_, b_, r_, s_ in zip(names, got, bf16, ref, split):
        assert torch.isfinite(g_.float()).all(), (label, name)
        e, eb = rel_l2(g_, r_), rel_l2(b_, r_)
        es = None if s_ is None else rel_l2(g_, s_)
        terms = name == "dbsig" and sum_scale
        if terms:
            print(f"  {label} dbsig: relative to the sum {e:.3e} "
                  f"(bfloat16_all kernel {eb:.3e})", flush=True)
            e, eb = (dbsig_error(g_, r_, sum_scale),
                     dbsig_error(b_, r_, sum_scale))
        print(f"  {label} {name}: "
              + ("of its terms' L2 norm" if terms else "relative L2")
              + f" {e:.3e} (bfloat16_all kernel "
              f"{eb:.3e}, {eb / max(e, 1e-30):.0f}x)"
              + ("" if es is None else f"; against the split twin "
                 f"{es:.3e}"), flush=True)
        assert e <= bound, (label, name, e)
        assert es is None or es <= bound, (label, name, es)
        worst = max(worst, e)
        if name in SUMS_ONLY:
            continue
        assert eb >= (min(closer, CLOSER) if terms else closer) * e, (
            label, name, e, eb)
        ratio = min(ratio, eb / max(e, 1e-30))
    report[label] = {"rel_l2": worst, "bf16_over_f32": ratio}
    return worst, ratio


def check_f32(n: int, seed: int = 0, report=None):
    """The float32 instantiations of K1, K2 and K3 at n points (see the
    module docstring); returns the report dict."""
    report = {} if report is None else report
    cfg16, net = flagship("bfloat16_all", seed)
    cfg = with_dtype(cfg16, "float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    p32 = k1.pack_trunk_weights(net, cfg, torch.float32)
    p16 = k1.pack_trunk_weights(net, cfg16, torch.bfloat16)
    enc = points(cfg, n, gen)
    # K1, with and without feats
    for feats in (False, True):
        got = k1._trunk_sigma_cuda(p32, cfg, enc, feats)
        same_twice("K1 float32", got[:1 + feats],
                   k1._trunk_sigma_cuda(p32, cfg, enc, feats)[:1 + feats])
        b16 = k1._trunk_sigma_cuda(p16, cfg16, enc, feats)
        ref = k1._trunk_sigma_plain(p32, cfg, enc, feats)
        hold_f32(f"K1 float32 at {n}, feats {feats}",
                 ("sigma", "feats")[:1 + feats], got, b16, ref, report)
    # K2 serving and saving zs/us
    for want_zs in (False, True):
        got = k2._trunk_fwd_grad_cuda(p32, cfg, enc, want_zs)
        same_twice("K2 float32", got,
                   k2._trunk_fwd_grad_cuda(p32, cfg, enc, want_zs))
        b16 = k2._trunk_fwd_grad_cuda(p16, cfg16, enc, want_zs)
        ref = k2._trunk_fwd_grad_plain(p32, cfg, enc, want_zs)
        hold_f32(f"K2 float32 at {n}, zs/us {want_zs}",
                 ("sigma", "feats", "gx", "zs", "us"), got, b16, ref, report)
        assert got[2][:, cfg.xyz_in_dim:].abs().max().item() == 0.0
    # K3 on the twin's zs/us (the bfloat16_all kernel on their bf16
    # roundings and the bf16 c_feats)
    _, _, _, zs, us = k2._trunk_fwd_grad_plain(p32, cfg, enc, True)
    cs, cf, cg = cotangents(cfg, n, gen, torch.float32)
    got = k2._trunk_bwd_cuda(p32, cfg, enc, cs, cf, cg, zs, us)
    same_twice("K3 float32", got,
               k2._trunk_bwd_cuda(p32, cfg, enc, cs, cf, cg, zs, us))
    bf = torch.bfloat16
    b16 = k2._trunk_bwd_cuda(p16, cfg16, enc, cs, cf.to(bf), cg, zs.to(bf),
                             us.to(bf))
    ref = k2._trunk_bwd_plain(p32, cfg, enc, cs, cf, cg, zs, us)
    hold_f32(f"K3 float32 at {n}", K3_NAMES, got, b16, ref, report)
    check_heads_f32(n, net, cfg16, enc, gen, report)
    return report


def check_heads_f32(n, net, cfg16, enc, gen, report):
    """K4 serving and saving zs, and K5 on the exact twin's zs, at float32
    against their exact and split twins (see the module docstring)."""
    cfg = with_dtype(cfg16, "float32")
    p32 = k1.pack_trunk_weights(net, cfg, torch.float32)
    p16 = k1.pack_trunk_weights(net, cfg16, torch.bfloat16)
    hw32 = k4.pack_head_weights(net, cfg, torch.float32)
    hw16 = k4.pack_head_weights(net, cfg16, torch.bfloat16)
    assert set(k4.HEAD_PLANE_KEYS.values()) <= set(hw32)
    k2_out = k2._trunk_fwd_grad_cuda(p32, cfg, enc)
    for want_zs in (False, True):
        got = k4._trunk_heads_fwd_cuda(p32, hw32, cfg, enc, want_zs)
        names = ("out", "gx", "zs")[:2 + want_zs]
        same_twice("K4 float32", got[:len(names)], k4._trunk_heads_fwd_cuda(
            p32, hw32, cfg, enc, want_zs)[:len(names)])
        b16 = k4._trunk_heads_fwd_cuda(p16, hw16, cfg16, enc, want_zs)
        ref = k4._trunk_heads_fwd_plain(p32, hw32, cfg, enc, want_zs)
        spl = k4._trunk_heads_fwd_split(p32, hw32, cfg, enc, want_zs)
        hold_f32(f"K4 float32 at {n}, zs {want_zs}", names, got, b16, ref,
                 report, HEADS_CLOSER, spl)
        # K4 runs K2's trunk and chain with the same arithmetic
        assert torch.equal(got[1], k2_out[2]), "K4 float32 gx is not K2's"
        assert torch.equal(got[0][:, 0], k2_out[0]), "K4 sigma is not K2's"
        assert got[0][:, 7].abs().max().item() == 0.0
    zs = k4._trunk_heads_fwd_plain(p32, hw32, cfg, enc, True)[2]
    cot = torch.randn(n, k4.HEAD_COLS, device="cuda", generator=gen)
    cot[:, 7] = 0.0
    _, _, cg = cotangents(cfg, n, gen, torch.float32)
    got = k4._trunk_heads_bwd_cuda(p32, hw32, cfg, enc, cot, cg, zs)
    same_twice("K5 float32", got,
               k4._trunk_heads_bwd_cuda(p32, hw32, cfg, enc, cot, cg, zs))
    b16 = k4._trunk_heads_bwd_cuda(p16, hw16, cfg16, enc, cot, cg,
                                   zs.to(torch.bfloat16))
    ref = k4._trunk_heads_bwd_plain(p32, hw32, cfg, enc, cot, cg, zs)
    spl = k4._trunk_heads_bwd_split(p32, hw32, cfg, enc, cot, cg, zs)
    hold_f32(f"K5 float32 at {n}", K5_NAMES, got, b16, ref, report,
             HEADS_CLOSER, spl)


def dbsig_scale(packed, cfg, cs, cg, zs) -> float:
    """The L2 norm of the sigma head's bias gradient's per-point terms,
    a = c_sigma sp'(zsig) + sp''(zsig) tzsig (from the twin's prologue):
    the size the sum would have if its terms did not cancel."""
    _, _, _, zsig, _, _, tzsig = k2._bwd_primal_tangent(packed, cfg, cg, zs)
    sp1 = torch.sigmoid(zsig)
    return (cs * sp1 + sp1 * (1.0 - sp1) * tzsig).norm().item()


def dbsig_error(got, ref, scale: float) -> float:
    """The sigma head's bias gradient's error as a share of its terms' L2
    norm (dbsig_scale): the measure held to a bound where its relative
    error against the sum is not, since the terms may cancel."""
    return (got.float() - ref.float()).norm().item() / scale


def check_mixed(n: int, seed: int = 0, report=None, l2=1e-2):
    """compute_dtype bfloat16 at n points: K2 saving f32 zs/us, K3 on
    them, K4 saving f32 zs and K5 on it, each twice bit-identical, against
    their twins at relative L2 l2 (the bfloat16_all kernels' bound: the
    same bf16 operands, f32 sums in another order); returns the report.
    The sigma head's bias gradient is one sum over the points of terms of
    either sign, so its error is held to l2 of its terms' L2 norm
    (dbsig_scale), not of the sum: where the terms cancel, the sum is
    small and its relative error large for either contract (its relative
    L2 against the sum is printed beside)."""
    report = {} if report is None else report
    cfg16, net = flagship("bfloat16_all", seed)
    cfg = with_dtype(cfg16, "bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    packed = k1.pack_trunk_weights(net, cfg, torch.bfloat16)
    hw = k4.pack_head_weights(net, cfg, torch.bfloat16)
    enc = points(cfg, n, gen)

    def hold(label, names, got, ref, sum_scale=None):
        worst, max_abs = 0.0, 0.0
        for name, g_, r_ in zip(names, got, ref):
            if name in ("dw2r", "dw2p"):            # the 3 logit columns
                g_, r_ = g_[:, :3], r_[:, :3]
            assert torch.isfinite(g_.float()).all(), (label, name)
            e = (rel_l2(g_, r_) if name != "dbsig" else
                 dbsig_error(g_, r_, sum_scale))
            assert e <= l2, (label, name, e)
            worst = max(worst, e)
            max_abs = max(max_abs,
                          (g_.float() - r_.float()).abs().max().item())
        db = (f"; dbsig {rel_l2(got[8], ref[8]):.3e} of the sum, "
              f"{dbsig_error(got[8], ref[8], sum_scale):.3e} of its "
              f"terms' norm" if sum_scale else "")
        print(f"  {label}: two launches bit-identical, largest relative L2 "
              f"against its twin {worst:.3e}{db}", flush=True)
        report[label] = {"rel_l2": worst, "max_abs": max_abs}

    got = k2._trunk_fwd_grad_cuda(packed, cfg, enc, want_zs=True)
    same_twice("K2 bfloat16", got,
               k2._trunk_fwd_grad_cuda(packed, cfg, enc, want_zs=True))
    assert got[3].dtype == got[4].dtype == torch.float32
    hold(f"K2 bfloat16 saving f32 zs/us at {n}",
         ("sigma", "feats", "gx", "zs", "us"), got,
         k2._trunk_fwd_grad_plain(packed, cfg, enc, want_zs=True))
    zs, us = got[3], got[4]
    cs, cf, cg = cotangents(cfg, n, gen, torch.float32)
    got = k2._trunk_bwd_cuda(packed, cfg, enc, cs, cf, cg, zs, us)
    same_twice("K3 bfloat16", got,
               k2._trunk_bwd_cuda(packed, cfg, enc, cs, cf, cg, zs, us))
    hold(f"K3 bfloat16 on f32 zs/us at {n}", K3_NAMES, got,
         k2._trunk_bwd_plain(packed, cfg, enc, cs, cf, cg, zs, us),
         dbsig_scale(packed, cfg, cs, cg, zs))
    out = k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc, want_zs=True)
    same_twice("K4 bfloat16", out,
               k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc, want_zs=True))
    assert out[2].dtype == torch.float32
    hold(f"K4 bfloat16 saving f32 zs at {n}", ("out", "gx", "zs"), out,
         k4._trunk_heads_fwd_plain(packed, hw, cfg, enc, want_zs=True))
    zs = out[2]
    cot = torch.randn(n, k4.HEAD_COLS, device="cuda", generator=gen)
    cot[:, 7] = 0.0
    got = k4._trunk_heads_bwd_cuda(packed, hw, cfg, enc, cot, cg, zs)
    same_twice("K5 bfloat16", got,
               k4._trunk_heads_bwd_cuda(packed, hw, cfg, enc, cot, cg, zs))
    hold(f"K5 bfloat16 on f32 zs at {n}", K5_NAMES, got,
         k4._trunk_heads_bwd_plain(packed, hw, cfg, enc, cot, cg, zs),
         dbsig_scale(packed, cfg, cot[:, 0], cg, zs))
    return report


def wgrad_precision(n: int, splits, report):
    """K3 float32's dW_0 at n points with the trunk's K in each number of
    slices of `splits` (None: the package's), against the f64 sum of its
    three products of its own operands and against the exact twin."""
    cfg16, net = flagship("bfloat16_all")
    cfg = with_dtype(cfg16, "float32")
    p = k1.pack_trunk_weights(net, cfg, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    enc = points(cfg, n, gen)
    _, _, _, zs, us = k2._trunk_fwd_grad_cuda(p, cfg, enc, True)
    cs, cf, cg = cotangents(cfg, n, gen, torch.float32)
    ref = k2._trunk_bwd_plain(p, cfg, enc, cs, cf, cg, zs, us)
    package = k2.wgrad_splits
    try:
        for st in splits:
            if st is not None:
                k2.wgrad_splits = lambda *a, st=st: (st, 0)
            scratch = {}
            got = k2._trunk_bwd_cuda(p, cfg, enc, cs, cf, cg, zs, us,
                                     scratch_out=scratch)
            # xt: [x | t] hi, then lo; azbtz[0]: [a_z | b_tz] hi, then lo
            xt, az = scratch["xt"].double(), scratch["azbtz"][0].double()
            f64 = sum(xt[a].t() @ az[b] for a, b in (
                (0, 0), (2, 0), (0, 2), (1, 1), (3, 1), (1, 3)))
            used = st or package(n, cfg.layers, False,
                                 torch.cuda.get_device_properties(
                                     0).multi_processor_count, True)[0]
            row = {"kernel_vs_f64_of_its_products": rel_l2(got[0], f64),
                   "kernel_vs_twin": rel_l2(got[0], ref[0])}
            report[f"dW_0 at {n} points, {used} slices"] = row
            print(f"  dW_0 at {n} points in {used} slices of K: relative L2 "
                  f"{row['kernel_vs_f64_of_its_products']:.3e} against the "
                  f"f64 sum of its products, {row['kernel_vs_twin']:.3e} "
                  f"against the exact twin", flush=True)
    finally:
        k2.wgrad_splits = package


def main(argv=None) -> int:
    from .fwd_variants import card
    argv = sys.argv[1:] if argv is None else argv
    sizes = [int(a) for a in argv if a.isdigit()] or [192]
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card(), flush=True)
    from ..ops import cuda_build
    cuda_build.build(["trunk_sigma", "trunk_fwd_grad", "trunk_bwd",
                      "trunk_heads_fwd", "trunk_heads_bwd"])
    for name, rec in cuda_build.build_log.items():
        print(f"  built {name} in {rec['seconds']:.1f} s", flush=True)
    report = {}
    if "--wgrad" in argv:
        nums = [int(a) for a in argv if a.isdigit()]
        wgrad_precision(nums[0] if nums else 131072,
                        nums[1:] or [1, 11, 32, 96, None], report)
    for n in sizes if "--wgrad" not in argv else ():
        check_f32(n, report=report)
        check_mixed(n, report=report)
    print(json.dumps({"card": card(), "checks": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
