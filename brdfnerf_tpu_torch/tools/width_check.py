"""K1-K3 at the trunk widths 64, 128 and 256 (--fc_feat) on the card, held
against their plain twins, and timed at the main paths' shapes.

    python3 -m brdfnerf_tpu_torch.tools.width_check [points ...]
    python3 -m brdfnerf_tpu_torch.tools.width_check --times [F ...]

For each configuration of CONFIGS (widths 64, 128 and 256 at 8 layers
with the skip at 4, and width 64 at 4 layers with the skip at 2, the
flagship's RPV heads, weights from seed 0), at each size (default 192
and 8,448: a ragged wave of 3 tiles, and one tile for each of the H100's
132 SMs), at every compute dtype the kernels take with the polynomial
sine, and at width 64 also with the exact sine and ReLU: K1 with and
without feats, K2 serving and saving zs/us, and K3, each launched twice
with bit-identical outputs and held to its twin by relative L2 over each
output tensor, at the bounds of the width-512 rows (tools/act_check.py,
tools/f32_check.py):
  * bfloat16_all and bfloat16: the twin of the same dtype at
    act_check.BF16_BOUND (K1 at K1_BOUND), the sigma head's bias gradient
    at that bound of its terms' L2 norm, ReLU's kinked outputs at
    RELU_KINKED_BOUND;
  * float32: the exact-f32 twin at f32_check.F32_BOUND, and CLOSER times
    closer than the bfloat16_all kernel on the same inputs.
--times does the same for every instantiation at its main path's shape
(kernel_rows: K1 at 327,680 points, K2 at 655,360, K2 saving zs/us and K3
at 131,072, where each persistent block runs several tiles), at the
widths given (default 64, 128 and 256), and times it beside its twin and
the torch.matmul chain of the same products, with its bound (trunk_work,
bound_ms).  This is the one command line for the widths' checks and
times; chip_smoke.py's `widths` phase runs both (check_all, kernel_rows).
Prints the card's name and power limit first and a JSON summary last;
exits 1 where a check missed its bound.
"""

from __future__ import annotations

import dataclasses as dc
import json
import sys

import torch

from ..ops import fused_mlp as k1
from ..ops import fused_trunk_vjp as k2
from .act_check import (ACT_CONFIGS, BF16_BOUND, K1_BOUND, MISSES, _hold,
                        bound_of)
from .f32_check import (K3_NAMES, cotangents, dbsig_scale, hold_f32,
                        points, same_twice)
from .kernel_times import _time as timed

# (width, layers, skip layer) of the configurations checked
CONFIGS = ((64, 8, 4), (128, 8, 4), (256, 8, 4), (64, 4, 2))
# the widths K1-K3 take besides the flagship's 512
WIDTHS = (64, 128, 256)
DTYPES = ("bfloat16_all", "float32", "bfloat16")
ACTS = {"poly": {"siren": True, "fast_sin": True}, **ACT_CONFIGS}
SIZES = (192, 8448)
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


def trunk_work(kern: str, cfg, n: int, wbytes: int):
    """(FLOPs, bytes) that K1, K2, K2zs (K2 saving zs/us) or K3 needs at n
    points of cfg's trunk, at any width: the products at the encoding's
    real width, each input read once and each output written once.  x, gx
    and cg count at the encoding's cfg.xyz_in_dim f32 lanes (not the
    kernels' 128-lane padding, which they neither need nor fill); sigma
    and K3's c_sigma in f32; feats, zs, us and K3's c_feats at 2 bytes at
    bfloat16_all, else 4 (f32 saved state); the weights' `wbytes` once;
    K3's f32 weight gradients at their real shapes."""
    ein, f, layers = cfg.xyz_in_dim, cfg.feat, cfg.layers
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
    assert kern == "K3", kern
    # the tangent forward (macs), the a chain (L - 1 products of F x F),
    # the outer products of every layer's dW over (primal, tangent)
    grad_elems = (2 * ein * f + (layers - 1) * f * f + layers * f + f + 1)
    return (2.0 * (3 * macs + (layers - 1) * f * f) * n,
            n * (zbytes + f * ab + 2 * xb + 4) + wbytes + 4 * grad_elems)


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
                seed: int = 0):
    """(ModelConfig, network) of spsbrdf-nerf with the flagship's heads at
    trunk width `feat`, `layers` layers with the skip at `skip`, the
    activation `act` (poly, sin, relu), its weights from `seed`, on the
    card."""
    from ..config import ModelConfig
    from ..models.network import init_network
    cfg = ModelConfig(variant="spsbrdf-nerf", mapping=True,
                      compute_dtype=compute_dtype, normal="analystic",
                      sun_v="analystic", func_m=True, func_f=True, func_h=1,
                      dim_rpv=1, layers=layers, feat=feat, skips=(skip,),
                      **ACTS[act])
    g = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, init_network(cfg, g, device="cuda")


def held(kern, label, names, got, again, ref, dtype, act, report, b16=None,
         sum_scale=None):
    """Two launches' outputs `got` and `again` bit-identical, and held to
    the twin's `ref` at the module docstring's bounds for `dtype` (b16:
    the bfloat16_all kernel's outputs on the same inputs, for float32)."""
    same_twice(f"{kern} {label}", got, again)
    if dtype == "float32":
        hold_f32(f"{kern} {label}", names, got, b16, ref, report,
                 sum_scale=sum_scale)
    else:
        b = K1_BOUND if kern.startswith("K1") else BF16_BOUND
        _hold(f"{kern} {label}", names, got, ref,
              {nm: bound_of(act, kern, nm, b) for nm in names}, report,
              sum_scale)


def check_width(feat: int, layers: int, skip: int, act: str, n: int,
                seed: int = 0, report=None):
    """K1 (with and without feats), K2 (serving, saving zs/us) and K3 of
    the configuration at `act` and every dtype of DTYPES on n points, as
    the module docstring says; returns the report dict."""
    report = {} if report is None else report
    cfg16, net = width_model(feat, layers, skip, "bfloat16_all", act, seed)
    assert k1.cuda_kernels_cover(cfg16) and k1.act_of(cfg16) == act
    p16 = k1.pack_trunk_weights(net, cfg16, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    enc = points(cfg16, n, gen)
    tag = f"width {feat}, {layers} layers, skip {skip}, {act}, {n} points"
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
                 k1._trunk_sigma_cuda(p16, cfg16, enc, feats)[:k])
        for want_zs in (False, True):
            names = ("sigma", "feats", "gx", "zs", "us")[:3 + 2 * want_zs]
            got = k2._trunk_fwd_grad_cuda(packed, cfg, enc, want_zs)
            assert got[2][:, cfg.xyz_in_dim:].abs().max().item() == 0.0
            held(f"K2 (zs/us {want_zs})", label, names, got,
                 k2._trunk_fwd_grad_cuda(packed, cfg, enc, want_zs),
                 k2._trunk_fwd_grad_plain(packed, cfg, enc, want_zs), dtype,
                 act, report,
                 k2._trunk_fwd_grad_cuda(p16, cfg16, enc, want_zs))
        zs, us = got[3], got[4]
        assert zs.dtype == us.dtype == sd and zs.shape == (n, layers * feat)
        cs, cf, cg = cotangents(cfg, n, gen, sd)
        bf = torch.bfloat16
        held("K3", label, K3_NAMES,
             k2._trunk_bwd_cuda(packed, cfg, enc, cs, cf, cg, zs, us),
             k2._trunk_bwd_cuda(packed, cfg, enc, cs, cf, cg, zs, us),
             k2._trunk_bwd_plain(packed, cfg, enc, cs, cf, cg, zs, us),
             dtype, act, report,
             k2._trunk_bwd_cuda(p16, cfg16, enc, cs, cf.to(bf), cg,
                                zs.to(bf), us.to(bf)) if f32 else None,
             dbsig_scale(packed, cfg, cs, cg, zs))
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


def kernel_rows(rows: dict, feat: int, peaks, seed: int = 0, report=None):
    """Rows of the kernels JSON line for K1-K3 at width `feat` (8 layers,
    skip 4), keyed "<K1|K2|K2zs|K3> <dtype> f<feat>": each instantiation at
    its main shape (K1 at N_SERVE_PASS points, K2 at N_SERVE_MAIN, K2
    saving zs/us and K3 at N_TRAIN_MAIN; at bfloat16 only the last two,
    whose f32 zs/us set them apart), launched twice bit-identical and held
    to its twin there at check_width's bounds (`held`), timed beside its
    twin and the chain of torch.matmul calls of the same products in the
    weights' dtype (matmul_chains), with its bound from the work and
    traffic these inputs need (trunk_work, bound_ms at `peaks`) and the
    largest difference from the twin.  Launches are the main path's,
    filled in by the caller."""
    from ..ops.fused_mlp import LANE
    report = {} if report is None else report
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    src = {"K1": ("brdfnerf_tpu_torch/csrc/trunk_sigma.cu",
                  "brdfnerf_tpu/ops/pallas_mlp.py:114"),
           "K2": ("brdfnerf_tpu_torch/csrc/trunk_fwd_grad.cu",
                  "brdfnerf_tpu/ops/pallas_trunk_vjp.py:205"),
           "K3": ("brdfnerf_tpu_torch/csrc/trunk_bwd.cu",
                  "brdfnerf_tpu/ops/pallas_trunk_vjp.py:240")}
    name = {"K1": "trunk_sigma", "K2": "trunk_fwd_grad",
            "K2zs": "trunk_fwd_grad (saving zs/us)", "K3": "trunk_bwd"}
    outs = {"K1": ("sigma",), "K2": ("sigma", "feats", "gx"),
            "K2zs": ("sigma", "feats", "gx", "zs", "us"), "K3": K3_NAMES}
    cfg16, net = width_model(feat, seed=seed)
    p16 = k1.pack_trunk_weights(net, cfg16, torch.bfloat16)
    bf = torch.bfloat16
    for dtype in DTYPES:
        cfg = dc.replace(cfg16, compute_dtype=dtype)
        packed = k1.pack_trunk_weights(net, cfg, k1.weight_dtype(cfg))
        # the weights' bytes the kernels read (at float32 the hi and lo
        # planes: the f32 weights' bytes)
        wbytes = sum(v.numel() * v.element_size() for k, v in packed.items()
                     if k not in k1.PLANE_KEYS.values())
        chain_fwd, chain_k2, chain_k3 = matmul_chains(packed, cfg, LANE)
        split = 3 if dtype == "float32" else 1

        def row(kern, fn, twin, library, n, b16=None, sum_scale=None):
            key = f"{kern} {dtype} f{feat}"
            got, again, ref = fn(), fn(), twin()
            held(kern, f"width {feat}, {dtype}, {n} points (main shape)",
                 outs[kern], got, again, ref, dtype, "poly", report,
                 None if b16 is None else b16(), sum_scale)
            err = max((g_.float() - r_.float()).abs().max().item()
                      for g_, r_ in zip(got, ref) if g_ is not None)
            del got, again, ref
            r = {"name": f"{name[kern]} [width {feat}, {dtype}]",
                 "route": "cuda", "source": src[kern[:2]][0],
                 "replaces": src[kern[:2]][1], "width": feat,
                 "dtype": dtype, "points": n, "max_abs_err": err,
                 "ms": timed(fn, 10), "plain_ms": timed(twin, 1),
                 "library_ms": timed(library, 5)}
            flops, nbytes = trunk_work(kern, cfg, n, wbytes)
            r["bound_ms"], r["bound_by"] = bound_ms(flops, nbytes, peaks)
            if split > 1:
                r["bound_split_ms"], _ = bound_ms(split * flops, nbytes,
                                                  peaks)
            rows[key] = r
            print(f"  {key}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} by "
                  f"{r['bound_by']}, twin {r['plain_ms']:.1f}, matmul chain "
                  f"{r['library_ms']:.3f}) at {n} points; largest |kernel - "
                  f"twin| {err:.3e}", flush=True)

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


def main(argv=None) -> int:
    from .fwd_variants import card
    argv = sys.argv[1:] if argv is None else argv
    nums = tuple(int(a) for a in argv if a.isdigit())
    times = "--times" in argv
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
    report, rows = {}, {}
    if times:
        peaks = peaks_of(torch.cuda.get_device_name(0))
        for feat in nums or WIDTHS:
            kernel_rows(rows, feat, peaks, report=report)
    else:
        check_all(nums or SIZES, report)
    print(json.dumps({"card": card(), "checks": report, "rows": rows,
                      "misses": MISSES}))
    return 1 if MISSES else 0


def libraries():
    """The library keys of K1-K3 at every width of WIDTHS: the polynomial
    sine at each, and at width 64 the exact sine and ReLU too
    (ops/cuda_build.library_key)."""
    from ..ops import cuda_build
    return [cuda_build.library_key(lib, act, feat)
            for feat in WIDTHS
            for act in (("poly",) + tuple(ACT_CONFIGS) if feat == 64
                        else ("poly",))
            for lib in ("trunk_sigma", "trunk_fwd_grad", "trunk_bwd")]


if __name__ == "__main__":
    sys.exit(main())
