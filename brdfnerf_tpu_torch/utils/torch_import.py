"""Import reference (PyTorch-Lightning) checkpoints into the port: the
port's copy of the JAX package's utils/torch_import.py, key for key.

The reference trains with Lightning and saves `epoch={n}.ckpt` files whose
state_dict keys are torch module paths — nerf_coarse.fc_net.0.weight,
nerf_coarse.k_from_xyz.2.bias, embedding_t.weight, ... (reference:
main.py:709-712; the two-stage handoff reads them at eval.py:26-54).
This converter maps those onto the flat param layout both packages share
(coarse/fc_net/0/w, t, ...; utils/checkpoint.py), so `--in_ckpts`, resume
(`--ckpt_path`), the stage-1 -> stage-2 handoff, `--eval 1` freeze-all
evaluation and serve.load_renderer take a checkpoint trained by the
reference.

Key mapping:

  nerf_coarse. / nerf_fine.   ->  coarse/ / fine/
  embedding_t.weight          ->  t
  <head>.<j>.weight/bias      ->  <head>/<j//2>/{w,b}  (torch Sequential
                                  interleaves activation modules at odd
                                  indices, so Linear j -> layer j//2)
  <head>.weight/bias          ->  <head>/0/{w,b}       (bare nn.Linear
                                  heads, e.g. feats_from_xyz/grad_from_xyz)

torch stores Linear weights as (out, in); the npz holds (in, out) ->
transposed.
Lightning's global_step becomes __step__ so resume keeps the schedule
position.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

SEP = "/"

_NET_PREFIXES = {"nerf_coarse.": "coarse" + SEP, "nerf_fine.": "fine" + SEP}


def convert_state_dict(sd: Dict[str, Any],
                       skipped: list = None) -> Dict[str, np.ndarray]:
    """Reference state_dict -> flat param dict (utils/checkpoint layout).

    Unrecognized keys (buffers, loss modules, ...) are skipped — the
    reference's checkpoints contain only the module families mapped here.
    Recognized-prefix (nerf_coarse./nerf_fine.) keys whose module path has
    an unexpected layout are collected into `skipped` when given, so layout
    drift in future reference checkpoints is diagnosable instead of
    surfacing as a bare 'missing N parameters' restore error.
    """
    out: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        arr = _to_numpy(val)
        if key == "embedding_t.weight":
            out["t"] = arr
            continue
        prefix = None
        for torch_p, ours_p in _NET_PREFIXES.items():
            if key.startswith(torch_p):
                prefix = ours_p
                rest = key[len(torch_p):]
                break
        if prefix is None:
            continue
        parts = rest.split(".")
        if parts[-1] not in ("weight", "bias"):
            if skipped is not None:
                skipped.append(key)
            continue
        leaf = "w" if parts[-1] == "weight" else "b"
        if len(parts) == 2:                      # bare nn.Linear head
            head, idx = parts[0], 0
        elif len(parts) == 3 and parts[1].isdigit():
            head, idx = parts[0], int(parts[1]) // 2
        else:
            if skipped is not None:
                skipped.append(key)
            continue
        if leaf == "w" and arr.ndim == 2:
            arr = arr.T.copy()                   # torch (out,in) -> (in,out)
        out[f"{prefix}{head}{SEP}{idx}{SEP}{leaf}"] = arr
    return out


def _to_numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def import_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a reference .ckpt (or bare state_dict .pth) as the flat dict."""
    import os
    import torch
    try:
        # weights_only rejects arbitrary pickled code — Lightning
        # state_dict+global_step checkpoints load fine this way
        d = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        # full unpickling EXECUTES code embedded in the file; require an
        # explicit opt-in instead of silently falling back
        if os.environ.get("BRDFNERF_ALLOW_UNSAFE_CKPT") != "1":
            raise ValueError(
                f"{path}: safe (weights_only) load failed: {e}. If you "
                f"trust this checkpoint, set BRDFNERF_ALLOW_UNSAFE_CKPT=1 "
                f"to allow full unpickling (runs arbitrary code from the "
                f"file).") from e
        print(f"[torch_import] {path}: weights_only load failed; "
              f"BRDFNERF_ALLOW_UNSAFE_CKPT=1 set — full unpickling")
        d = torch.load(path, map_location="cpu", weights_only=False)
    sd = d.get("state_dict", d) if isinstance(d, dict) else d
    skipped: list = []
    flat = convert_state_dict(sd, skipped=skipped)
    if skipped:
        print(f"[torch_import] {path}: {len(skipped)} recognized-prefix "
              f"keys had an unexpected module layout and were NOT "
              f"imported: {skipped[:8]}{'...' if len(skipped) > 8 else ''}")
    if not flat:
        raise ValueError(
            f"{path}: no reference-model keys found (expected "
            f"nerf_coarse.* / nerf_fine.* / embedding_t.*)"
            + (f"; skipped unmapped keys: {skipped[:8]}" if skipped else ""))
    if isinstance(d, dict) and "global_step" in d:
        flat["__step__"] = np.asarray(int(d["global_step"]))
    return flat
