"""Where the backward kernels K3 and K5 spend their time: each is timed at
the training step's shape (131,072 points, the flagship 8 x 512 trunk in
bfloat16_all, seeded as tools/bwd_check.py) as the package builds it and
as measurement-only builds of the same source, in turns on one card
(built, variant, variant, built, ...), split by kernel function:

  no_epilogue_loads  -DBWD_NO_EPILOGUE_LOADS: the sweep's epilogues load no
                     zs, us or tz (no ring stages of them) and read
                     constants instead
  identity_act       -DTRUNK_IDENTITY_ACT: the activation becomes w0 z

and with the weight-gradient kernel's K axis cut into other numbers of
slices than ops/fused_trunk_vjp.wgrad_splits picks.  The package build
and the other splits compute the kernels' function: the splits agree with
it to 1e-3
relative L2 (another order of the same f32 sums, over up to 262,144
points, with cancellation).

    python3 -m brdfnerf_tpu_torch.tools.bwd_variants [variant ...]

Prints the card's name and power limit, one line per kernel, variant and
round, and a JSON summary line last.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from ..ops import cuda_build
from ..ops import fused_trunk_heads as k4
from ..ops import fused_trunk_vjp as k2
from .bwd_check import setup

N = 131072
ROUNDS = 3
VARIANTS = {"no_epilogue_loads": "-DBWD_NO_EPILOGUE_LOADS",
            "identity_act": "-DTRUNK_IDENTITY_ACT"}
# (trunk, heads) splits tried beside the package's choice
SPLITS = {"k3": [(1, 0), (2, 0), (3, 0), (11, 0)],
          "k5": [(1, 3), (2, 1), (2, 2), (3, 2), (9, 5), (11, 11)]}
LIBS = {"k3": (k2, "TRUNK_BWD", "trunk_bwd"),
        "k5": (k4, "TRUNK_HEADS_BWD", "trunk_heads_bwd")}


class VariantKernel:
    """The entry point of a kernel from a measurement build, called like
    its cuda_build.CudaKernel."""

    def __init__(self, kernel: cuda_build.CudaKernel, path: str):
        fn = getattr(ctypes.CDLL(path), kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        self.fn, self.symbol = fn, kernel.symbol

    def __call__(self, *args) -> None:
        err = self.fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} (variant): CUDA error {err}")


def build_variants(flags):
    """{(library, variant): path} of every backward library built with each
    variant's flag, all nvcc processes started together."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for _, _, lib in LIBS.values():
        for variant, flag in flags.items():
            path = cuda_build.library_path(lib)[:-3] + f"-{variant}.so"
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, flag, "-o",
                   path, os.path.join(cuda_build.CSRC, f"{lib}.cu")]
            procs[(lib, variant)] = (path, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
    return {key: path for key, (path, _) in procs.items()}


def measure(fn, reps=5):
    """(ms per call by CUDA events over reps calls after one, {kernel
    function: device ms per call} from torch.profiler over 2 calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            for part in ("sweep", "wgrad", "reduce"):
                if f"trunk_bwd_{part}_kernel" in ev.key:
                    parts[part] = (parts.get(part, 0.0)
                                   + ev.self_device_time_total / 2e3)
    return e0.elapsed_time(e1) / reps, parts


def main(argv):
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    flags = {v: f for v, f in VARIANTS.items() if not argv or v in argv}
    cuda_build.build([lib for _, _, lib in LIBS.values()] + ["trunk_fwd_grad"])
    paths = build_variants(flags)
    d = setup(N)
    summary = {"card": smi, "points": N, "kernels": {}}
    for name, (mod, attr, lib) in LIBS.items():
        built = getattr(mod, attr)
        pick = k2.wgrad_splits(N, 8, name == "k5")
        cases = {"built": (built, None)}
        cases.update({v: (VariantKernel(built, paths[(lib, v)]), None)
                      for v in flags})
        cases.update({f"splits {s}": (built, s) for s in SPLITS[name]})

        def run(kernel, splits):
            setattr(mod, attr, kernel)
            saved = k2.wgrad_splits
            if splits is not None:
                k2.wgrad_splits = lambda *a, **kw: splits
            try:
                return measure(d[name]), d[name]()
            finally:
                setattr(mod, attr, built)
                k2.wgrad_splits = saved

        times = {c: [] for c in cases}
        outs = {}
        for r in range(ROUNDS):
            order = list(cases) if r % 2 == 0 else list(cases)[::-1]
            for c in order:
                (ms, parts), outs[c] = run(*cases[c])
                times[c].append({"ms": ms, **parts})
                print(f"  {name} {c} round {r}: {ms:.3f} ms "
                      + " ".join(f"{k} {v:.3f}" for k, v in parts.items()),
                      flush=True)
        for c in outs:
            if c.startswith("splits"):
                for a_, b_ in zip(outs["built"], outs[c]):
                    rel = float((a_ - b_).norm() / b_.norm().clamp_min(1e-30))
                    assert rel <= 1e-3, (name, c, rel)
        summary["kernels"][name] = {"package_splits": pick, "cases": {
            c: {k: statistics.median(t[k] for t in ts) for k in ts[0]}
            for c, ts in times.items()}}
        for c, med in summary["kernels"][name]["cases"].items():
            print(f"  {name} {c}: median " + ", ".join(
                f"{k} {v:.3f}" for k, v in med.items()), flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
