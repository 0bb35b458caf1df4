"""K1 (csrc/trunk_sigma.cu) on the card: its registers, its agreement with
the plain twin, and what its split products cost.

    python3 -m brdfnerf_tpu_torch.tools.sigma_variants --check [points ...]
    python3 -m brdfnerf_tpu_torch.tools.sigma_variants [points ...]

With --check: ptxas's registers and spills of the kernel, then K1 at each
size (default 192, 65,536 and 327,680 points; 192 is 3 tiles, a ragged
last wave) against _trunk_sigma_plain on the card, with and without
feats, each launched twice with bit-identical outputs; the flagship trunk
(8 x 512, skip 4, bfloat16_all) from seed 0.  Without it: K1 as the
package builds it against its measurement build -DTRUNK_SIGMA_HI_ONLY
(the hi products alone: the bf16-activation arithmetic before the split)
and two chains of bf16 torch.matmul calls for the same products (one chain
on bf16 activations; hi and lo chains summed, the split's fidelity), in
turns on one card, at each size (default 327,680 and 65,536 points: the
serving and the training pass).  Prints the card's name and power limit
first and a JSON summary line last.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

from ..ops import cuda_build
from ..ops import fused_mlp as k1
from .bwd_check import ptxas_summary
from .bwd_variants import VariantKernel
from .fwd_variants import card, ptxas_log, setup, timed

ROUNDS = 5
HI_ONLY = "-DTRUNK_SIGMA_HI_ONLY"


def rel_err(got, ref):
    """max |d| / scale, mean |d| / scale and relative L2 of got against
    ref, scale = max |ref|."""
    d = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max().clamp_min(1e-30)
    return {"max": (d.max() / scale).item(), "mean": (d.mean() / scale).item(),
            "rel": ((got.float() - ref.float()).norm()
                    / ref.float().norm().clamp_min(1e-30)).item()}


def check(sizes) -> int:
    for fn in ptxas_summary(ptxas_log("trunk_sigma")):
        print(f"  trunk_sigma {fn['name'][:56]}: {fn['registers']} registers"
              f" at launch, spills {fn['spill_stores']} B stored / "
              f"{fn['spill_loads']} B loaded", flush=True)
    for n in sizes:
        cfg, packed, _, enc = setup(n)
        for feats in (False, True):
            got = k1._trunk_sigma_cuda(packed, cfg, enc, feats)
            again = k1._trunk_sigma_cuda(packed, cfg, enc, feats)
            ref = k1._trunk_sigma_plain(packed, cfg, enc, feats)
            torch.cuda.synchronize()
            assert torch.equal(got[0], again[0]), (n, feats)
            errs = {"sigma": rel_err(got[0], ref[0])}
            if feats:
                assert torch.equal(got[1], again[1]), n
                errs["feats"] = rel_err(got[1], ref[1])
            for k, e in errs.items():
                assert torch.isfinite(got[0]).all(), (n, k)
                print(f"  K1 at {n} points, feats {feats}: {k} max/scale "
                      f"{e['max']:.3e} mean/scale {e['mean']:.3e} rel L2 "
                      f"{e['rel']:.3e}; two launches bit-identical",
                      flush=True)
    return 0


def build_hi_only() -> str:
    path = cuda_build.library_path("trunk_sigma")[:-3] + "-hi-only.so"
    proc = subprocess.run(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, HI_ONLY, "-o", path,
         os.path.join(cuda_build.CSRC, "trunk_sigma.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the hi-only build:\n"
                           f"{proc.stdout}")
    return path


def chains(cfg, packed):
    """The trunk's products as bf16 torch.matmul calls: on bf16
    activations, and as hi and lo chains summed (K1's fidelity)."""
    mids = list(packed["w_mid"])
    lane, skip = k1.LANE, cfg.skips[0]

    def layer(i, h, x):
        if i == 0:
            return x @ packed["w0"].t()
        if i == skip:
            return (h @ packed["w_skip"][:, lane:].t()
                    + x @ packed["w_skip"][:, :lane].t())
        return h @ mids[i - 1 if i < skip else i - 2].t()

    def bf16(x):
        h = None
        for i in range(cfg.layers):
            h = layer(i, h, x)
        return h

    def split(xh, xl):
        h = l_ = None
        for i in range(cfg.layers):
            h, l_ = layer(i, h, xh), layer(i, l_, xl)
        return h + l_

    return bf16, split


def time_builds(sizes, summary) -> int:
    path = build_hi_only()
    built = k1.TRUNK_SIGMA
    cases = {"built": built, "hi_only": VariantKernel(built, path)}
    for n in sizes:
        cfg, packed, _, enc = setup(n)
        xh, xl = k1.split_bf16(enc)
        chain_bf16, chain_split = chains(cfg, packed)
        runs = dict(cases)
        times = {c: [] for c in list(runs) + ["chain_bf16", "chain_split"]}
        sig = {}
        for r in range(ROUNDS):
            order = list(runs) if r % 2 == 0 else list(runs)[::-1]
            for c in order:
                k1.TRUNK_SIGMA = runs[c]
                try:
                    def run():
                        return k1._trunk_sigma_cuda(packed, cfg, enc,
                                                    False)[0]
                    times[c].append(timed(run, 10))
                    sig[c] = run()
                finally:
                    k1.TRUNK_SIGMA = built
            times["chain_bf16"].append(timed(lambda: chain_bf16(xh), 10))
            times["chain_split"].append(timed(lambda: chain_split(xh, xl),
                                              10))
            print(f"  {n} points round {r}: " + ", ".join(
                f"{c} {v[-1]:.3f} ms" for c, v in times.items()), flush=True)
        # the hi-only build computes with bf16 activations: if sigma agreed
        # bit for bit, the define did not reach the kernel
        assert not torch.equal(sig["built"], sig["hi_only"]), n
        ref = k1._trunk_sigma_plain(packed, cfg, enc, False)[0]
        errs = {c: rel_err(s, ref) for c, s in sig.items()}
        med = {c: statistics.median(v) for c, v in times.items()}
        summary["kernels"][str(n)] = {"rounds_ms": times, "median_ms": med,
                                      "sigma_vs_twin": errs}
        print(f"  {n} points: median " + ", ".join(
            f"{c} {v:.3f}" for c, v in med.items()) + "; sigma vs twin "
            + ", ".join(f"{c} max/scale {e['max']:.2e} rel {e['rel']:.2e}"
                        for c, e in errs.items()), flush=True)
    return 0


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    smi = card()
    print(smi, flush=True)
    t0 = time.perf_counter()
    cuda_build.build(["trunk_sigma"])
    print(f"  built in {time.perf_counter() - t0:.1f} s", flush=True)
    sizes = [int(a) for a in argv if a.isdigit()]
    if "--check" in argv:
        return check(sizes or [192, 65536, 327680])
    summary = {"card": smi, "kernels": {}}
    rc = time_builds(sizes or [327680, 65536], summary)
    print(json.dumps(summary))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
