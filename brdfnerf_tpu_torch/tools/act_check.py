"""The trunk kernels built for the exact sine (fast_sin 0) and for ReLU
(siren 0) on the card, held against their plain twins.

    python3 -m brdfnerf_tpu_torch.tools.act_check [points ...] [--sweeps N]

For each activation, at each compute dtype the kernels take, on the
flagship model (8 x 512 trunk, skip 4, the RPV heads) from seed 0 at each
size (default 8,448: one 64-point tile for each of the H100's 132 SMs):
K1 with and without feats, K2 serving and saving zs/us, K3, K4 serving and
saving zs, and K5, each launched twice with bit-identical outputs and held
to its twin by relative L2 over each output tensor:
  * bfloat16_all and bfloat16: the twin of the same dtype (the same bf16
    operands, f32 sums in another order) at BF16_BOUND, as the polynomial
    instantiations in chip_smoke.py; the sigma head's bias gradient at
    BF16_BOUND of its terms' L2 norm (f32_check.dbsig_scale), since it is
    one sum of terms of either sign;
  * float32: the exact-f32 twin at f32_check.F32_BOUND;
  * K1 (f32 activations split into bf16 hi and lo terms at every dtype):
    its twin at K1_BOUND.
Relative L2 over the tensor, not the largest element: under ReLU an element
whose pre-activation rounds across 0 differently in kernel and twin takes
act' 0 on one side and 1 on the other, an O(1) difference of one element
that a summation order alone produces; over the tensor it weighs what the
few such elements weigh.  What such a flip reaches (K2's and K4's gx and
us, from act' in the reverse chain; every K5 gradient, from the heads'
act' of their recomputed first layers) is held to RELU_KINKED_BOUND at
every dtype (bound_of); everything continuous in z, and K3 (whose act'
comes from the zs it is given), to the dtype's bound.
--sweeps N launches K3 and K5 twice more at N points (the training step's
131,072 in chip_smoke.py) at every dtype and activation, bit-identical.
Prints the card's name and power limit first and a JSON summary last.
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops import fused_mlp as k1
from ..ops import fused_trunk_heads as k4
from ..ops import fused_trunk_vjp as k2
from .f32_check import (F32_BOUND, K3_NAMES, K5_NAMES, cotangents,
                        dbsig_error, dbsig_scale, flagship, points, rel_l2,
                        same_twice)

ACT_CONFIGS = {"sin": {"siren": True, "fast_sin": False},
               "relu": {"siren": False, "fast_sin": True}}
DTYPES = ("bfloat16_all", "bfloat16", "float32")
BF16_BOUND = 1e-2
K1_BOUND = 1e-4
# ReLU's kink: an element whose z lies within the kernel-twin difference
# of 0 takes the other act', and the reverse chain carries each such flip
# into every element of the layers below, so the relative L2 of what act'
# reaches grows like the square root of the share of such elements, not
# with the difference itself: measured 5.0e-3 at float32 (whose difference
# is 2^-17 of a product) and 7.5e-3 at bfloat16_all on 640 points of the
# flagship (act_check on an H100, where every continuous output sat at
# 1e-5 and 4e-3)
RELU_KINKED_BOUND = 3e-2
# the checks that missed their bounds (main exits 1 when any did)
MISSES = []


def bound_of(act: str, kern: str, name: str, bound: float) -> float:
    """The bound of output `name` of kernel `kern` (K1 .. K5) at `act`:
    RELU_KINKED_BOUND where ReLU's act' flips reach it, else `bound`."""
    kinked = kern == "K5" or name in ("gx", "us")
    return max(bound, RELU_KINKED_BOUND) if act == "relu" and kinked \
        else bound


def act_model(act: str, compute_dtype: str, seed: int = 0):
    """(ModelConfig, network) of the flagship at `act` and compute_dtype,
    its weights from `seed`, on the card."""
    return flagship(compute_dtype, seed, **ACT_CONFIGS[act])


def _hold(label, names, got, ref, bounds, report, sum_scale=None):
    """Every output within its bound (bounds: {name: bound}) relative L2 of
    its twin (dbsig: of its terms' norm sum_scale, where given); returns
    the largest error."""
    worst, missed = 0.0, []
    for name, g_, r_ in zip(names, got, ref):
        if g_ is None:
            continue
        assert torch.isfinite(g_.float()).all(), (label, name)
        if name == "dbsig" and sum_scale:
            e = dbsig_error(g_, r_, sum_scale)
        else:
            e = rel_l2(g_, r_)
        if not e <= bounds[name]:
            missed.append(f"{label} {name}: {e:.3e} > {bounds[name]:g}")
        worst = max(worst, e)
    MISSES.extend(missed)
    print(f"  {label}: two launches bit-identical, largest relative L2 "
          f"against its twin {worst:.3e} (bounds "
          f"{sorted(set(bounds.values()))})"
          + ("  MISSED " + "; ".join(missed) if missed else ""), flush=True)
    report[label] = {"rel_l2": worst}
    return worst


def check_act(act: str, n: int, seed: int = 0, report=None):
    """Every instantiation of K1-K5 at `act` and n points (see the module
    docstring); returns the report dict."""
    report = {} if report is None else report
    for dtype in DTYPES:
        cfg, net = act_model(act, dtype, seed)
        assert k1.act_of(cfg) == act and k1.cuda_kernels_cover(cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed + 3)
        wd = k1.weight_dtype(cfg)
        packed = k1.pack_trunk_weights(net, cfg, wd)
        hw = k4.pack_head_weights(net, cfg, wd)
        enc = points(cfg, n, gen)
        bound = F32_BOUND if dtype == "float32" else BF16_BOUND
        tag = f"{act}, {dtype}, {n} points"

        def bounds(kern, names, b=bound):
            return {nm: bound_of(act, kern, nm, b) for nm in names}
        for feats in (False, True):
            got = k1._trunk_sigma_cuda(packed, cfg, enc, feats)
            same_twice(f"K1 {tag}", got[:1 + feats],
                       k1._trunk_sigma_cuda(packed, cfg, enc, feats))
            _hold(f"K1 {tag}, feats {feats}", ("sigma", "feats"), got,
                  k1._trunk_sigma_plain(packed, cfg, enc, feats),
                  bounds("K1", ("sigma", "feats"), K1_BOUND), report)
        for want_zs in (False, True):
            got = k2._trunk_fwd_grad_cuda(packed, cfg, enc, want_zs)
            same_twice(f"K2 {tag}", got,
                       k2._trunk_fwd_grad_cuda(packed, cfg, enc, want_zs))
            names = ("sigma", "feats", "gx", "zs", "us")
            _hold(f"K2 {tag}, zs/us {want_zs}", names, got,
                  k2._trunk_fwd_grad_plain(packed, cfg, enc, want_zs),
                  bounds("K2", names), report)
        zs, us = got[3], got[4]
        cs, cf, cg = cotangents(cfg, n, gen, k2._saved_dtype(cfg))
        got = k2._trunk_bwd_cuda(packed, cfg, enc, cs, cf, cg, zs, us)
        same_twice(f"K3 {tag}", got,
                   k2._trunk_bwd_cuda(packed, cfg, enc, cs, cf, cg, zs, us))
        _hold(f"K3 {tag}", K3_NAMES, got,
              k2._trunk_bwd_plain(packed, cfg, enc, cs, cf, cg, zs, us),
              bounds("K3", K3_NAMES), report,
              dbsig_scale(packed, cfg, cs, cg, zs))
        for want_zs in (False, True):
            got = k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc, want_zs)
            k = 2 + want_zs
            same_twice(f"K4 {tag}", got[:k], k4._trunk_heads_fwd_cuda(
                packed, hw, cfg, enc, want_zs)[:k])
            _hold(f"K4 {tag}, zs {want_zs}", ("out", "gx", "zs")[:k],
                  got[:k], k4._trunk_heads_fwd_plain(packed, hw, cfg, enc,
                                                     want_zs)[:k],
                  bounds("K4", ("out", "gx", "zs")), report)
        zs = got[2]
        cot = torch.randn(n, k4.HEAD_COLS, device="cuda", generator=gen)
        cot[:, 7] = 0.0
        got = k4._trunk_heads_bwd_cuda(packed, hw, cfg, enc, cot, cg, zs)
        same_twice(f"K5 {tag}", got,
                   k4._trunk_heads_bwd_cuda(packed, hw, cfg, enc, cot, cg, zs))
        _hold(f"K5 {tag}", K5_NAMES, got,
              k4._trunk_heads_bwd_plain(packed, hw, cfg, enc, cot, cg, zs),
              bounds("K5", K5_NAMES), report,
              dbsig_scale(packed, cfg, cot[:, 0], cg, zs))
    return report


def sweeps_twice(n: int, acts=("poly", "sin", "relu"), seed: int = 0):
    """K3 and K5 at n points launched twice at every dtype and activation
    of `acts` (poly: the polynomial sine), on the kernels' own zs/us;
    asserts bit-identical grads."""
    for act in acts:
        for dtype in DTYPES:
            if act == "poly":
                cfg, net = flagship(dtype, seed)
            else:
                cfg, net = act_model(act, dtype, seed)
            gen = torch.Generator(device="cuda").manual_seed(seed + 4)
            wd = k1.weight_dtype(cfg)
            packed = k1.pack_trunk_weights(net, cfg, wd)
            hw = k4.pack_head_weights(net, cfg, wd)
            enc = points(cfg, n, gen)
            _, _, _, zs, us = k2._trunk_fwd_grad_cuda(packed, cfg, enc, True)
            cs, cf, cg = cotangents(cfg, n, gen, k2._saved_dtype(cfg))
            same_twice(f"K3 {act}, {dtype}, {n} points",
                       k2._trunk_bwd_cuda(packed, cfg, enc, cs, cf, cg, zs,
                                          us),
                       k2._trunk_bwd_cuda(packed, cfg, enc, cs, cf, cg, zs,
                                          us))
            del us
            zs = k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc, True)[2]
            cot = torch.randn(n, k4.HEAD_COLS, device="cuda", generator=gen)
            same_twice(f"K5 {act}, {dtype}, {n} points",
                       k4._trunk_heads_bwd_cuda(packed, hw, cfg, enc, cot,
                                                cg, zs),
                       k4._trunk_heads_bwd_cuda(packed, hw, cfg, enc, cot,
                                                cg, zs))
            print(f"  K3 and K5 {act}, {dtype} at {n} points: two launches "
                  f"bit-identical", flush=True)


def libraries(acts=("poly", "sin", "relu")):
    """The library keys of every trunk kernel at every activation of
    `acts` (ops/cuda_build.library_key)."""
    from ..ops import cuda_build
    return [cuda_build.library_key(lib, act) for act in acts
            for lib in ("trunk_sigma", "trunk_fwd_grad", "trunk_bwd",
                        "trunk_heads_fwd", "trunk_heads_bwd")]


def main(argv=None) -> int:
    from .fwd_variants import card
    argv = sys.argv[1:] if argv is None else argv
    sweep_n = None
    if "--sweeps" in argv:
        i = argv.index("--sweeps")
        sweep_n = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    sizes = [int(a) for a in argv if a.isdigit()] or [8448]
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
    report = {}
    for n in sizes:
        for act in ACT_CONFIGS:
            check_act(act, n, report=report)
    if sweep_n:
        sweeps_twice(sweep_n)
    print(json.dumps({"card": card(), "checks": report, "misses": MISSES}))
    return 1 if MISSES else 0


if __name__ == "__main__":
    sys.exit(main())
