"""Checkpoint converter: move checkpoints between the shared .npz format
and the reference's Lightning .ckpt format, both directions (the JAX
package's cli/convert_ckpt.py, with its checks, exit codes and lines).

  # export a trained model back to the reference (eval.py:26-54 loaders)
  python -m brdfnerf_tpu_torch.cli.convert_ckpt --input ckpts/exp/epoch=9.npz \
      --output epoch=9.ckpt

  # convert a reference checkpoint to .npz up front (the CLIs also
  # accept .ckpt directly via --in_ckpts; this just materializes it)
  python -m brdfnerf_tpu_torch.cli.convert_ckpt --input epoch=9.ckpt \
      --output epoch=9.npz

Direction is inferred from the file extensions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None, device=None):
    """device: accepted as every CLI's main takes it; the conversion runs
    on the host."""
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True,
                   help=".npz (shared layout) or .ckpt/.pth (reference torch)")
    p.add_argument("--output", required=True,
                   help="target path; extension selects the format")
    args = p.parse_args(argv)

    src_torch = args.input.endswith((".ckpt", ".pth"))
    dst_torch = args.output.endswith((".ckpt", ".pth"))
    if src_torch == dst_torch:
        print("error: exactly one of --input/--output must be a torch "
              ".ckpt/.pth and the other a native .npz", file=sys.stderr)
        return 2
    # the non-torch side must really be .npz: np.savez would silently
    # append '.npz' and write somewhere other than --output
    native = args.output if src_torch else args.input
    if not native.endswith(".npz"):
        print(f"error: native-side path must end with .npz: {native}",
              file=sys.stderr)
        return 2

    if src_torch:
        from ..utils.torch_import import import_torch_checkpoint
        flat = import_torch_checkpoint(args.input)
        step = int(np.asarray(flat.pop("__step__", 0)))
        np.savez(args.output, __step__=np.asarray(step), **flat)
        print(f"{args.input} -> {args.output} "
              f"({len(flat)} params, step {step})")
    else:
        from ..utils.torch_export import export_torch_checkpoint
        d = np.load(args.input)
        flat = {k: d[k] for k in d.files}
        export_torch_checkpoint(flat, args.output)
        n = len([k for k in flat if k != "__step__"])
        print(f"{args.input} -> {args.output} ({n} params)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
