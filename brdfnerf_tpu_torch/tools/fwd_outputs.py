"""The forward kernels' outputs on seeded inputs, saved to a file and
compared bit for bit with another such file: K1 (trunk_sigma), K2
(trunk_fwd_grad, with and without zs/us) and K4 (trunk_heads_fwd, with and
without zs) on the flagship network (8 x 512, skip 4, the RPV(111)
heads, bfloat16_all) from seed 0, at 65,536 points.  Run it in two trees
on one card to show that a change leaves these kernels as they were.
Outputs one tree has and the other lacks are listed, not compared (K4 no
longer saves us).  Against a tree before K1's split products, K1's sigma
differs by design: the kernel then rounded its activations to bf16.

    python3 -m brdfnerf_tpu_torch.tools.fwd_outputs OUT.pt [OTHER.pt]

Exits non-zero when OTHER.pt is given and any output differs.
"""

from __future__ import annotations

import sys

import torch

N = 65536


def outputs():
    from brdfnerf_tpu_torch.config import ModelConfig
    from brdfnerf_tpu_torch.models.network import init_network
    from brdfnerf_tpu_torch.ops import fused_mlp as k1
    from brdfnerf_tpu_torch.ops import fused_trunk_heads as k4
    from brdfnerf_tpu_torch.ops import fused_trunk_vjp as k2
    from brdfnerf_tpu_torch.ops.encoding import positional_encoding

    cfg = ModelConfig(variant="spsbrdf-nerf", siren=True, mapping=True,
                      compute_dtype="bfloat16_all", normal="analystic",
                      sun_v="analystic", func_m=True, func_f=True, func_h=1,
                      dim_rpv=1)
    g = torch.Generator(device="cuda").manual_seed(0)
    net = init_network(cfg, g, device="cuda")
    xyz = torch.rand(N, 3, device="cuda", generator=g) * 2 - 1
    enc = positional_encoding(xyz, 10, fast=True, pad_to=k1.LANE)
    packed = k1.pack_trunk_weights(net, cfg, torch.bfloat16)
    hw = k4.pack_head_weights(net, cfg, torch.bfloat16)
    out = {"K1 sigma": k1._trunk_sigma_cuda(packed, cfg, enc, False)[0]}
    for name, v in zip(("sigma", "feats", "gx"),
                       k2._trunk_fwd_grad_cuda(packed, cfg, enc)):
        out[f"K2 {name}"] = v
    for name, v in zip(("sigma", "feats", "gx", "zs", "us"),
                       k2._trunk_fwd_grad_cuda(packed, cfg, enc,
                                               want_zs=True)):
        out[f"K2+zs/us {name}"] = v
    out["K4 out"], out["K4 gx"], _ = k4._trunk_heads_fwd_cuda(
        packed, hw, cfg, enc)[:3]
    for name, v in zip(("out", "gx", "zs"),
                       k4._trunk_heads_fwd_cuda(packed, hw, cfg, enc,
                                                want_zs=True)):
        out[f"K4+zs/us {name}"] = v
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    mine = outputs()
    torch.save(mine, argv[0])
    if len(argv) < 2:
        return 0
    other = torch.load(argv[1])
    same = True
    for k, v in mine.items():
        if k not in other:
            print(f"  {k}: only in this tree", flush=True)
            continue
        eq = torch.equal(v, other[k])
        same &= eq
        print(f"  {k}: {'bit-identical' if eq else 'DIFFERS'}", flush=True)
    for k in other:
        if k not in mine:
            print(f"  {k}: only in the other tree", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
