"""Time the trunk kernels at the main paths' shapes, and compare two
checkouts' kernels on one card.

    python3 -m brdfnerf_tpu_torch.tools.kernel_times [--reps N] [--feat F]
    python3 -m brdfnerf_tpu_torch.tools.kernel_times --ab OTHER [--rounds R]

The first form times, on the flagship model (8 x 512 trunk, skip 4, the
RPV heads, polynomial sine, weights from seed 0), each instantiation a
checkout had before the float32 heads and the other activations: K1 at the
serving pass (327,680 points), K2 and K4 at the serving chunk (655,360),
K2/K4 saving zs(/us), K3 and K5 at the training step (131,072), at
bfloat16_all; K1, K2, K2 saving zs/us and K3 at float32; K2 saving zs/us,
K3, K4 saving zs and K5 at bfloat16 (f32 zs/us).  Each is the mean of
--reps launches (default 10) after one, by CUDA events, and the last line
is a JSON object {instantiation: ms}.  It uses nothing newer than those
wrappers, so that the file copied into an older checkout times that
checkout's kernels.  --feat 64, 128 or 256 times them at that trunk
width instead (the same shapes).

--ab runs the first form from this checkout and from OTHER_ROOT (a copy of
this file placed in its tools/) in turns, OTHER, this, this, OTHER,
--rounds times (default 1), each in a process of its own, and prints both
series of every instantiation.  Prints the card's
name and power limit first.
"""

from __future__ import annotations

import dataclasses as dc
import json
import os
import shutil
import subprocess
import sys

import torch


def _time(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def measure(reps: int = 10, feat: int = 512):
    """{instantiation: ms} of this checkout's kernels at trunk width `feat`
    (module docstring)."""
    from ..config import ModelConfig
    from ..models.network import init_network
    from ..ops import fused_mlp as k1
    from ..ops import fused_trunk_heads as k4
    from ..ops import fused_trunk_vjp as k2
    from ..ops.encoding import positional_encoding
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg16 = ModelConfig(variant="spsbrdf-nerf", siren=True, mapping=True,
                        compute_dtype="bfloat16_all", normal="analystic",
                        sun_v="analystic", func_m=True, func_f=True,
                        func_h=1, dim_rpv=1, feat=feat)
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = init_network(cfg16, gen, device="cuda")

    def points(n):
        xyz = torch.rand(n, 3, device="cuda", generator=gen) * 2 - 1
        return positional_encoding(xyz, 10, fast=True, pad_to=128)

    n1, n2, n3 = 327680, 655360, 131072
    x1, x2, x3 = points(n1), points(n2), points(n3)
    out = {}
    for dtype in ("bfloat16_all", "float32", "bfloat16"):
        cfg = dc.replace(cfg16, compute_dtype=dtype)
        wd = torch.float32 if dtype == "float32" else torch.bfloat16
        p = k1.pack_trunk_weights(net, cfg, wd)
        zs, us = k2._trunk_fwd_grad_cuda(p, cfg, x3, True)[3:]
        cs = torch.randn(n3, device="cuda", generator=gen)
        cf = torch.randn(n3, feat, device="cuda", generator=gen) * 0.1
        cf = cf.to(zs.dtype)
        cg = torch.zeros(n3, 128, device="cuda")
        cg[:, :60] = torch.randn(n3, 60, device="cuda", generator=gen)
        tag = {"bfloat16_all": "", "float32": " float32",
               "bfloat16": " bfloat16"}[dtype]
        if dtype != "bfloat16":
            out["K1" + tag] = _time(
                lambda: k1._trunk_sigma_cuda(p, cfg, x1, False), reps)
            out["K2" + tag] = _time(
                lambda: k2._trunk_fwd_grad_cuda(p, cfg, x2), reps)
        out["K2 zs/us" + tag] = _time(
            lambda: k2._trunk_fwd_grad_cuda(p, cfg, x3, True), reps)
        out["K3" + tag] = _time(
            lambda: k2._trunk_bwd_cuda(p, cfg, x3, cs, cf, cg, zs, us), reps)
        if dtype == "float32":
            continue
        hw = k4.pack_head_weights(net, cfg, torch.bfloat16)
        zs4 = k4._trunk_heads_fwd_cuda(p, hw, cfg, x3, True)[2]
        cot = torch.randn(n3, 8, device="cuda", generator=gen)
        cot[:, 7] = 0.0
        if dtype == "bfloat16_all":
            out["K4" + tag] = _time(
                lambda: k4._trunk_heads_fwd_cuda(p, hw, cfg, x2), reps)
        out["K4 zs" + tag] = _time(
            lambda: k4._trunk_heads_fwd_cuda(p, hw, cfg, x3, True), reps)
        out["K5" + tag] = _time(
            lambda: k4._trunk_heads_bwd_cuda(p, hw, cfg, x3, cot, cg, zs4),
            reps)
    return out


def ab(other: str, rounds: int) -> int:
    """Both checkouts' measure() in turns (module docstring)."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    dst = os.path.join(other, "brdfnerf_tpu_torch", "tools",
                       os.path.basename(__file__))
    if os.path.abspath(dst) != os.path.abspath(__file__):
        shutil.copyfile(__file__, dst)
    series = {"other": [], "this": []}
    for which in ["other", "this", "this", "other"] * rounds:
        root = other if which == "other" else here
        proc = subprocess.run(
            [sys.executable, "-m", "brdfnerf_tpu_torch.tools.kernel_times"],
            cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        series[which].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"  {which}: {series[which][-1]}", flush=True)
    summary = {}
    for k in series["this"][0]:
        a = [s[k] for s in series["other"]]
        b = [s[k] for s in series["this"]]
        summary[k] = {"other": a, "this": b}
        print(f"  {k}: other {', '.join(f'{v:.3f}' for v in a)}; this "
              f"{', '.join(f'{v:.3f}' for v in b)} ms", flush=True)
    print(json.dumps(summary))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    if "--ab" in argv:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
        rounds = (int(argv[argv.index("--rounds") + 1])
                  if "--rounds" in argv else 1)
        return ab(argv[argv.index("--ab") + 1], rounds)
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 10
    feat = int(argv[argv.index("--feat") + 1]) if "--feat" in argv else 512
    print(json.dumps(measure(reps, feat)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
