"""How far K5's arithmetic moves with the u chain (b_th) it is given, on
the CPU in f32 at the flagship width (8 x 512, skip 4, bfloat16_all, the
RPV(111) heads) from seed 0.

The Pallas _bwd_kernel_h rebuilds the chain from the saved bf16 zs
(ops/fused_trunk_heads.uchain_plain); the forward's own chain (the us K2
saves for K3) runs on f32 z.  For several draws of points and cotangents
this prints, per layer, the relative L2 gap between the two chains, and
the relative L2 error of each gradient of the heads' backward twin when
its reverse sweep takes (a) the forward's chain in f32, (b) the forward's
chain rounded to bf16 (K5 before it rebuilt the chain), (c) the rebuilt
chain rounded to bf16, against the twin itself (the rebuilt chain in f32).

    python3 -m brdfnerf_tpu_torch.tools.uchain_gap [--device cpu]
        [points ...]

Runs on the card unless --device names another (the plain twins in f32,
no TF32); prints a JSON summary line last.
"""

from __future__ import annotations

import json
import sys

import torch

from ..config import ModelConfig
from ..models.network import init_network
from ..ops import fused_mlp as k1
from ..ops import fused_trunk_heads as k4
from ..ops import fused_trunk_vjp as k2
from ..ops.encoding import positional_encoding
from ..utils.device import resolve_device

NAMES = ("dw0", "db0", "dwm", "dbm", "dwst", "dwsb", "dbs")


def rel(got, ref) -> float:
    return float((got.float() - ref.float()).norm()
                 / ref.float().norm().clamp_min(1e-30))


def trunk_grads(packed, hw, cfg, x, cot, cg, zs, bths):
    """The trunk grads of _trunk_heads_bwd_plain with its b_th states
    given in place of uchain_plain's."""
    saved = k4.uchain_plain
    k4.uchain_plain = lambda *_: torch.cat(list(bths), 1)
    try:
        return k4._trunk_heads_bwd_plain(packed, hw, cfg, x, cot, cg,
                                         zs)[:len(NAMES)]
    finally:
        k4.uchain_plain = saved


def main(argv) -> int:
    dev = resolve_device(argv[argv.index("--device") + 1]
                         if "--device" in argv else None)
    sizes = [int(a) for a in argv if a.isdigit()] or [192, 192, 192, 4096]
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(variant="spsbrdf-nerf", siren=True, mapping=True,
                      compute_dtype="bfloat16_all", normal="analystic",
                      sun_v="analystic", func_m=True, func_f=True, func_h=1,
                      dim_rpv=1)
    net = init_network(cfg, torch.Generator().manual_seed(0),
                       device="cpu").to(dev)
    packed = k1.pack_trunk_weights(net, cfg, torch.bfloat16)
    hw = k4.pack_head_weights(net, cfg, torch.bfloat16)
    F, L, ein = cfg.feat, cfg.layers, cfg.xyz_in_dim
    summary = []
    for draw, n in enumerate(sizes):
        g = torch.Generator().manual_seed(1 + draw)
        xyz = torch.rand(n, 3, generator=g) * 2 - 1
        cot = torch.randn(n, 8, generator=g)
        cot[:, 7] = 0.0
        cg = torch.zeros(n, k1.LANE)
        cg[:, :ein] = torch.randn(n, ein, generator=g)
        xyz, cot, cg = xyz.to(dev), cot.to(dev), cg.to(dev)
        x = positional_encoding(xyz, 10, fast=True, pad_to=k1.LANE)
        _, d1s, zl, zsig = k2._forward_chain(packed, cfg, x)
        _, fwd = k2._grad_chain(packed, cfg, zsig, d1s)
        zs = torch.cat(zl, 1).to(torch.bfloat16)
        rebuilt = k4.uchain_plain(packed, cfg, zs).split(F, 1)
        gap = [rel(fwd[i], rebuilt[i]) for i in range(L)]
        ref = trunk_grads(packed, hw, cfg, x, cot, cg, zs, rebuilt)
        row = {"points": n, "chain_gap_by_layer": gap, "grads": {}}
        print(f"draw {draw}, {n} points: forward chain vs rebuilt, by layer "
              + " ".join(f"{v:.2e}" for v in gap), flush=True)
        for label, bths in (
                ("forward chain f32", fwd),
                ("forward chain bf16", [u.to(torch.bfloat16).float()
                                        for u in fwd]),
                ("rebuilt chain bf16", [u.to(torch.bfloat16).float()
                                        for u in rebuilt])):
            got = trunk_grads(packed, hw, cfg, x, cot, cg, zs, bths)
            errs = {k: rel(a, b) for k, a, b in zip(NAMES, got, ref)}
            row["grads"][label] = errs
            print(f"  {label}: " + " ".join(f"{k} {v:.1e}"
                                            for k, v in errs.items()),
                  flush=True)
        summary.append(row)
    print(json.dumps({"device": str(dev), "draws": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
