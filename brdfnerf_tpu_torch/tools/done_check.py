"""The two-stage workflow at trunk width 64, scored over seeds: the
done-check that the port's scores lie within the JAX package's run-to-run
spread.

    python3 -m brdfnerf_tpu_torch.tools.done_check --side kernels
    python3 -m brdfnerf_tpu_torch.tools.done_check --side kernels_heads \
        --brdf_on 0.5
    python3 -m brdfnerf_tpu_torch.tools.done_check --side unfused
    JAX_PLATFORMS=cpu python3 -m brdfnerf_tpu_torch.tools.done_check \
        --side jax

For each seed (default 0 1 2) it builds the synthetic AOI
(data/synth_aoi.build_aoi, 256 px), runs the train CLI for stage 1
(Lambertian, depth-supervised) and stage 2 (the RPV BRDF, handed off with
--in_ckpts), and the eval CLI on each stage's last checkpoint, every CLI in
a process of its own.  The flags are those of
examples/synthetic_quickstart.py with --fc_layers 8, so that the skip
layer (4) lies inside the trunk and the fused kernels take it.  --side
picks the CLIs: `kernels` the port's on the card (K1-K3 at width 64),
`kernels_heads` the same with BRDFNERF_FUSED_HEADS set (K4/K5 in K2's and
K3's places where the RPV heads run without theta: stage 2's [kernels]
line must name them), `unfused` the port's with --fused_trunk 0
--use_pallas 0, `jax` the JAX package's (run as `python -m
brdfnerf_tpu.cli.*`, wherever JAX is installed; this module imports
nothing of it).  --brdf_on sets stage 2's (the quickstart's 0: the RPV
BRDF with theta from the first step; K4/K5 take no theta, so with the
switch they run only at 0.5 <= brdf_on < 1, the BRDF without theta from
step brdf_on x steps on).  --steps cuts both stages'
steps alike.  --device cpu runs the port's CLIs on the CPU (their
main(argv, device="cpu")); by default they run on the card.  --ulp also
trains stage 2 a second time from the stage-1 checkpoint with every
float32 weight moved by one ulp in a random direction (the smallest
change float32 can make; numpy, from the seed), all else equal, scored
as `stage2_ulp`: how far stage 2's scores move under a perturbation
smaller than any two implementations of its arithmetic agree to.
Prints each run's PSNR, SSIM and DSM MAE after each stage, then each
score's mean, standard deviation and range over the seeds, and as its
last line one JSON object of all of them.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

PACKAGES = {"kernels": "brdfnerf_tpu_torch",
            "kernels_heads": "brdfnerf_tpu_torch",
            "unfused": "brdfnerf_tpu_torch", "jax": "brdfnerf_tpu"}
STEPS = (300, 200)              # stage 1, stage 2 (the quickstart's)
# examples/synthetic_quickstart.py's flags, at 8 layers (skip 4)
COMMON = ["--mapping", "--fc_feat", "64", "--fc_layers", "8",
          "--n_samples", "8", "--guided_samples", "8",
          "--batch_size", "256", "--lr", "1e-3",
          "--eval_every_n_epochs", "1000"]
STAGE1 = ["--model", "spsbrdf-nerf", "--ds_lambda", "10"]
STAGE2 = ["--model", "spsbrdf-nerf", "--normal", "analystic",
          "--funcM", "1", "--funcF", "1", "--funcH", "1",
          "--cos_irra_on", "0", "--ds_lambda", "10"]
SIDE_FLAGS = {"unfused": ["--fused_trunk", "0", "--use_pallas", "0"]}
SIDE_ENV = {"kernels_heads": {"BRDFNERF_FUSED_HEADS": "1"}}
SCORES = ("psnr", "ssim", "mae")
_MEAN = re.compile(r"^mean: psnr (\S+) ssim (\S+) mae (\S+)", re.M)


def _cli(pkg: str, name: str, argv, log: str, device=None,
         env=None) -> str:
    """Run `python -m pkg.cli.name argv` (with `device`: the CLI's
    main(argv, device=device)) with `env` added to the environment, its
    output appended to `log`; returns its standard output, raising if it
    fails."""
    if device is None:
        cmd = [sys.executable, "-m", f"{pkg}.cli.{name}"] + list(argv)
    else:
        cmd = [sys.executable, "-c",
               f"import sys; from {pkg}.cli import {name} as m; "
               f"sys.exit(m.main(sys.argv[1:], device={device!r}))"
               ] + list(argv)
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True,
                       env=dict(os.environ, **(env or {})))
    with open(log, "a") as fh:
        fh.write(f"$ {' '.join(cmd)}\n{p.stdout}{p.stderr}\n")
    if p.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {p.returncode}:\n"
                           f"{p.stderr[-4000:]}")
    print(f"  {pkg}.cli.{name} {time.perf_counter() - t0:.1f} s", flush=True)
    return p.stdout


def last_epoch(ckpt_dir: str) -> int:
    return max(int(f[len("epoch="):-len(".npz")])
               for f in os.listdir(ckpt_dir)
               if f.startswith("epoch=") and f.endswith(".npz")
               and ".opt." not in f)


def ulp_moved(src: str, dst: str, seed: int) -> None:
    """Write the checkpoint `src` to `dst` with every float32 array moved
    by one ulp, each element up or down at random (RandomState(seed))."""
    import numpy as np
    rng = np.random.RandomState(seed)
    with np.load(src) as z:
        out = {}
        for k in z.files:
            a = z[k]
            if a.dtype == np.float32:
                up = rng.randint(0, 2, a.shape).astype(bool)
                a = np.nextafter(a, np.where(up, np.float32(np.inf),
                                             np.float32(-np.inf))
                                 ).astype(np.float32)
            out[k] = a
    np.savez(dst, **out)


def scores_of(out: str) -> dict:
    """The eval CLI's mean PSNR, SSIM and DSM MAE (its "mean:" line)."""
    m = _MEAN.findall(out)
    if not m:
        raise RuntimeError("the eval CLI printed no mean scores")
    return dict(zip(SCORES, (float(v) for v in m[-1])))


def run_seed(side: str, seed: int, work: str, steps=STEPS, device=None,
             ulp: bool = False, brdf_on: str = "0") -> dict:
    """Stage 1, its eval, stage 2 at --brdf_on brdf_on, its eval (with
    `ulp`, stage 2 and its eval again from the ulp-moved stage-1
    checkpoint); {stage: scores}."""
    from ..data.synth_aoi import build_aoi
    pkg = PACKAGES[side]
    aoi = build_aoi(os.path.join(work, "aoi"), size=256)
    logs, ckpts = os.path.join(work, "logs"), os.path.join(work, "ckpts")
    log = os.path.join(work, "cli.log")
    common = (["--root_dir", aoi["root"], "--logs_dir", logs,
               "--ckpts_dir", ckpts, "--gt_dir", aoi["gt_dir"],
               "--aoi_id", aoi["aoi_id"], "--seed", str(seed)] + COMMON
              + SIDE_FLAGS.get(side, []))
    out = {}
    env = SIDE_ENV.get(side)
    stage2 = STAGE2 + ["--brdf_on", brdf_on]
    stages = [("stage1", STAGE1, steps[0]), ("stage2", stage2, steps[1])]
    if ulp:
        stages.append(("stage2_ulp", stage2, steps[1]))
    for stage, flags, n in stages:
        extra = []
        if stage != "stage1":
            s1 = os.path.join(ckpts, "stage1")
            ck = os.path.join(s1, f"epoch={last_epoch(s1)}.npz")
            if stage == "stage2_ulp":
                moved = os.path.join(work, "stage1_ulp.npz")
                ulp_moved(ck, moved, seed)
                ck = moved
            extra = ["--in_ckpts", ck]
        train_out = _cli(pkg, "train", flags + extra + common + [
            "--exp_name", stage, "--max_train_steps", str(n)], log, device,
            env)
        line = [ln for ln in train_out.splitlines()
                if ln.startswith("[kernels]")]
        if line:
            print(f"  {line[0]}", flush=True)
        if side == "kernels_heads" and stage != "stage1" and not (
                line and "K4 + K5 in their place" in line[0]):
            raise RuntimeError(f"{stage} with BRDFNERF_FUSED_HEADS runs no "
                               f"K4/K5: {line}")
        epoch = last_epoch(os.path.join(ckpts, stage))
        out[stage] = scores_of(_cli(pkg, "eval", [
            "--logs_dir", os.path.join(logs, stage), "--epoch_number",
            str(epoch)], log, device, env))
        print(f"  seed {seed} {stage}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in out[stage].items()), flush=True)
    return out


def spread(runs: list) -> dict:
    """{stage: {score: (mean, std, min, max)}} over the seeds' runs."""
    res = {}
    for stage in runs[0]:
        res[stage] = {}
        for k in SCORES:
            v = [r[stage][k] for r in runs]
            res[stage][k] = (statistics.mean(v),
                             statistics.stdev(v) if len(v) > 1 else 0.0,
                             min(v), max(v))
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--side", choices=tuple(PACKAGES), required=True)
    p.add_argument("--seed", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--steps", type=int, nargs=2, default=list(STEPS),
                   metavar=("STAGE1", "STAGE2"))
    p.add_argument("--device", default=None,
                   help="run the port's CLIs here (default: the card)")
    p.add_argument("--brdf_on", default="0",
                   help="stage 2's --brdf_on (default 0, the quickstart's)")
    p.add_argument("--ulp", action="store_true",
                   help="also train stage 2 from the ulp-moved stage-1 "
                        "checkpoint (stage2_ulp)")
    p.add_argument("--workdir", default=None,
                   help="keep the runs here (default: a temporary "
                        "directory, removed at the end)")
    a = p.parse_args(argv)
    tmp = None if a.workdir else tempfile.TemporaryDirectory()
    root = a.workdir or tmp.name
    t0 = time.perf_counter()
    runs = []
    for seed in a.seed:
        print(f"== {a.side}, seed {seed}", flush=True)
        runs.append(run_seed(a.side, seed,
                             os.path.join(root, f"seed{seed}"), a.steps,
                             a.device, a.ulp, a.brdf_on))
    res = spread(runs)
    for stage, sc in res.items():
        print(f"{a.side} {stage}: " + "; ".join(
            f"{k} mean {m:.4f} std {s:.4f} range [{lo:.4f}, {hi:.4f}]"
            for k, (m, s, lo, hi) in sc.items()), flush=True)
    print(f"{a.side}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"side": a.side, "seeds": a.seed, "steps": a.steps,
                      "brdf_on": a.brdf_on, "runs": runs, "spread": res}))
    if tmp is not None:
        tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
