"""Build and bind the port's CUDA kernels (csrc/*.cu).

Each `csrc/<name>.cu` is one shared library with a plain C interface,
compiled by nvcc for sm_90a at first use into `brdfnerf_tpu_torch/_build/`
(listed in .gitignore) under a name keyed by a hash of its sources and
flags, and loaded with ctypes.  Nothing is built or loaded at import time:
the CPU host that runs the tests has no nvcc.

The trunk kernels' activation and width are compile-time choices: a
library key is the source's name for the polynomial sine at width 512,
built exactly as before, with ":sin" or ":relu" for the same source built
with its -DTRUNK_ACT flag (ACTS) and ":f64", ":f128" or ":f256" with its
-DTRUNK_F flag (WIDTHS), so that a run builds the variants it uses and no
others (library_key).  The layer-major kernels (csrc/trunk_layers.cu)
take the width at run time: their keys carry the activation alone
("trunk_layers", "trunk_layers:sin", "trunk_layers:relu").
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the activations the trunk kernels are built for, and their nvcc flags
# (csrc/trunk_common.cuh TRUNK_ACT)
ACTS = {"poly": (), "sin": ("-DTRUNK_ACT=1",), "relu": ("-DTRUNK_ACT=2",)}
# the trunk widths they are built for (csrc/trunk_common.cuh TRUNK_F); 512
# is the default, which needs no flag
WIDTHS = (64, 128, 256, 512)
DEFAULT_WIDTH = 512

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time, "log": nvcc/ptxas output}; empty for a
# library found already built
build_log: Dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "host with the CUDA toolkit")
    return path


def library_key(name: str, act: str = "poly",
                feat: int = DEFAULT_WIDTH) -> str:
    """The key of csrc/<name>.cu built for activation `act` (ACTS) and
    trunk width `feat` (WIDTHS): "name", "name:sin", "name:f64",
    "name:relu:f64", ..."""
    if act not in ACTS:
        raise ValueError(f"activation {act!r} is not one of {tuple(ACTS)}")
    if feat not in WIDTHS:
        raise ValueError(f"width {feat} is not one of {WIDTHS}")
    parts = [name] + ([act] if act != "poly" else []) + (
        [f"f{feat}"] if feat != DEFAULT_WIDTH else [])
    return ":".join(parts)


def _source_flags(key: str):
    """(source name, nvcc flags) of a library key."""
    name, *rest = key.split(":")
    act = next((r for r in rest if r in ACTS), "poly")
    feat = next((int(r[1:]) for r in rest if r not in ACTS), DEFAULT_WIDTH)
    if feat not in WIDTHS or len(rest) != (act != "poly") + (
            feat != DEFAULT_WIDTH):
        raise ValueError(f"not a library key: {key!r}")
    width = (f"-DTRUNK_F={feat}",) if feat != DEFAULT_WIDTH else ()
    return name, NVCC_FLAGS + ACTS[act] + width


def library_path(key: str) -> str:
    """Where a library key builds to: the hash covers the source, every
    shared header and the library's own flags (a polynomial library's are
    NVCC_FLAGS alone)."""
    name, flags = _source_flags(key)
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(os.listdir(CSRC)):
        if f == f"{name}.cu" or f.endswith(".cuh"):
            h.update(f.encode())
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(fh.read())
    tag = key.replace(":", "-")
    return os.path.join(BUILD_DIR, f"{tag}-{h.hexdigest()[:16]}.so")


def build(keys: Iterable[str]) -> None:
    """Compile the libraries (keys as library_key gives them) that are not
    built yet, one nvcc process per library, all started together."""
    todo: List[tuple] = []
    for key in keys:
        out = library_path(key)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        name, flags = _source_flags(key)
        cmd = [_nvcc(), *flags, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        todo.append((key, out, tmp, proc, time.perf_counter()))
    failed = []
    for key, out, tmp, proc, t0 in todo:
        log, _ = proc.communicate()
        build_log[key] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{key}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(key: str) -> ctypes.CDLL:
    with _lock:
        if key not in _libs:
            build([key])
            _libs[key] = ctypes.CDLL(library_path(key))
        return _libs[key]


class CudaKernel:
    """One C entry point of a csrc/ library, with its launch count.

    The entry point launches on the stream it is given and returns
    cudaGetLastError(); a non-zero code raises.  `act` and `feat` pick the
    library built for that activation (ACTS) and trunk width (WIDTHS).
    `launches` counts the launches that succeeded, of every library, and
    nothing else."""

    def __init__(self, library: str, symbol: str,
                 argtypes: Sequence[type]):
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fns: Dict[str, tuple] = {}

    def __call__(self, *args, act: str = "poly",
                 feat: int = DEFAULT_WIDTH) -> None:
        key = library_key(self.library, act, feat)
        if key not in self._fns:
            lib = load(key)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err_str = lib.cuda_error_string
            err_str.argtypes = [ctypes.c_int]
            err_str.restype = ctypes.c_char_p
            self._fns[key] = (fn, err_str)
        fn, err_str = self._fns[key]
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} "
                               f"({err_str(err).decode()})")
        with _count_lock:   # a multi-device server launches from threads
            self.launches += 1


# ----------------------------------------------------------- host C code

HOST_CFLAGS = ("-O3", "-shared", "-fPIC", "-std=c99")


def _cc() -> str:
    for name in ("cc", "gcc", "clang"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C compiler found (cc, gcc or clang): the port's "
                       "host libraries build with one")


def host_library_path(name: str) -> str:
    """Where csrc/<name>.c builds to, keyed by a hash of the source and
    HOST_CFLAGS as the kernels are."""
    h = hashlib.sha256(" ".join(HOST_CFLAGS).encode())
    with open(os.path.join(CSRC, f"{name}.c"), "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"host-{name}-{h.hexdigest()[:16]}.so")


def load_host(name: str) -> ctypes.CDLL:
    """csrc/<name>.c, a host library with a plain C interface, compiled
    with the system C compiler at first use and loaded with ctypes."""
    key = f"host:{name}"
    with _lock:
        if key not in _libs:
            out = host_library_path(name)
            if not os.path.exists(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.tmp"
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [_cc(), *HOST_CFLAGS, "-o", tmp,
                     os.path.join(CSRC, f"{name}.c")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                build_log[key] = {"seconds": time.perf_counter() - t0,
                                  "log": proc.stdout}
                if proc.returncode != 0:
                    raise RuntimeError(f"cc failed for {name}.c:\n"
                                       f"{proc.stdout}")
                os.replace(tmp, out)
            _libs[key] = ctypes.CDLL(out)
        return _libs[key]
