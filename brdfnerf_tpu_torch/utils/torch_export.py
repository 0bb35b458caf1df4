"""Export npz checkpoints to the reference's (torch/Lightning) format:
the port's copy of the JAX package's utils/torch_export.py, the inverse of
utils/torch_import.py.  A model trained by the port drops into the
reference's `--in_ckpts` / eval.py loaders (eval.py:26-54,
main.py:88-118), and the file is the one the JAX exporter writes.

Key mapping (inverse of torch_import.convert_state_dict):

  coarse/ / fine/          ->  nerf_coarse. / nerf_fine.
  t                        ->  embedding_t.weight
  <head>/<j>/{w,b}         ->  <head>.<2*j>.weight/bias  (torch Sequential
                               interleaves activations at odd indices,
                               reference models/spsbrdfnerf.py:515-612)
  feats_from_xyz, grad_from_xyz are bare nn.Linear modules in the
  reference (spsbrdfnerf.py:530,578) -> no submodule index in their keys.

Linear weights transpose back from the npz's (in, out) to torch's
(out, in).
`__step__` becomes Lightning's global_step.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

SEP = "/"

_NET_PREFIXES = {"coarse" + SEP: "nerf_coarse.", "fine" + SEP: "nerf_fine."}

# heads that are bare nn.Linear modules in the reference (no Sequential
# wrapper, so their torch keys carry no submodule index)
_BARE_LINEAR_HEADS = {"feats_from_xyz", "grad_from_xyz"}


def flat_to_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The flat param dict (utils/checkpoint layout) -> reference
    state_dict keys (numpy values; the caller tensors them)."""
    sd: Dict[str, np.ndarray] = {}
    for key, val in flat.items():
        arr = np.asarray(val)
        if key == "t":
            sd["embedding_t.weight"] = arr
            continue
        if key == "__step__":
            continue
        prefix = None
        for ours_p, torch_p in _NET_PREFIXES.items():
            if key.startswith(ours_p):
                prefix = torch_p
                rest = key[len(ours_p):]
                break
        if prefix is None:
            raise ValueError(f"cannot export param {key!r}: unknown prefix "
                             f"(expected coarse/, fine/, or t)")
        head, idx, leaf = rest.split(SEP)
        suffix = "weight" if leaf == "w" else "bias"
        if leaf == "w" and arr.ndim == 2:
            arr = arr.T.copy()          # npz (in,out) -> torch (out,in)
        if head in _BARE_LINEAR_HEADS:
            if idx != "0":
                raise ValueError(f"{key!r}: bare-Linear head {head} cannot "
                                 f"have layer index {idx}")
            sd[f"{prefix}{head}.{suffix}"] = arr
        else:
            # Sequential: Linear j sits at module index 2*j (activations
            # interleave at odd indices)
            sd[f"{prefix}{head}.{2 * int(idx)}.{suffix}"] = arr
    return sd


def export_torch_checkpoint(flat: Dict[str, Any], path: str) -> None:
    """Write a Lightning-style epoch={n}.ckpt the reference can load:
    {'state_dict': {...}, 'global_step': N, 'epoch': 0}."""
    import torch
    step = int(np.asarray(flat.get("__step__", 0)))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
          for k, v in flat_to_state_dict(flat).items()}
    torch.save({"state_dict": sd, "global_step": step, "epoch": 0}, path)
