"""Hold the wgmma and TMA layouts of csrc/sm90_common.cuh against
torch.matmul on the card (csrc/sm90_check.cu), one product per mode and
layout parameter pair; prints one line per pair and exits non-zero unless
the pairs the backward kernels use (LAYOUTS) agree.

    python3 -m brdfnerf_tpu_torch.tools.sm90_check
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops.cuda_build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
SM90_CHECK = CudaKernel("sm90_check", "sm90_check_launch",
                        [_P, _P, _P, _I, _I, _I, _P])
# mode -> (lbo, sbo) bytes as the kernels of csrc/trunk_bwd.cuh set them
LAYOUTS = {0: (16, 0), 1: (2048, 512), 2: (8192, 1024), 3: (16, 0)}
# the candidates tried beside them
CANDIDATES = {0: [(16, 0), (0, 0)], 1: [(2048, 512), (512, 2048)],
              2: [(8192, 1024), (1024, 8192)], 3: [(16, 0), (0, 0)]}


def run(mode: int, lbo: int, sbo: int, seed: int = 0) -> float:
    """Max |D - A.B| over max |A.B| for one mode and layout pair."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 128 if mode == 3 else 256
    a = torch.randn(64, 64, device="cuda", generator=g).to(torch.bfloat16)
    b = torch.randn(64, n, device="cuda", generator=g).to(torch.bfloat16)
    a_in = (a.t() if mode == 2 else a).contiguous()
    b_in = (b if mode in (1, 2) else b.t()).contiguous()
    d = torch.full((64, n), float("nan"), device="cuda")
    SM90_CHECK(a_in.data_ptr(), b_in.data_ptr(), d.data_ptr(), mode, lbo,
               sbo, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    ref = a.float() @ b.float()
    return float((d - ref).abs().max() / ref.abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    ok = True
    for mode, pairs in CANDIDATES.items():
        for lbo, sbo in pairs:
            err = run(mode, lbo, sbo)
            used = (lbo, sbo) == LAYOUTS[mode]
            print(f"mode {mode} lbo {lbo} sbo {sbo}: rel max err {err:.3e}"
                  + (" (used)" if used else ""), flush=True)
            if used and not err <= 1e-5:
                ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
