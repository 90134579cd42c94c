"""Build and load the port's CUDA kernels (``apdmvs_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so <src>

``--fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions compute them, so kernel and plain version agree to
the last bits of the warp arithmetic (no ``--use_fast_math`` either: it
would approximate the NCC epilogue's square root and divisions).

Libraries land in ``apdmvs_tpu_torch/_build/`` (git-ignored), named by a
hash of source and flags, so an edited source rebuilds and a finished build
is reused. Nothing is built at import: :func:`load` builds on first use and
:func:`build_all` builds every source at once, one ``nvcc`` per source,
all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: kernel library name -> source file under csrc/
SOURCES = {
    "build_volume": "build_volume.cu",
    "ncc_cost": "ncc_cost.cu",
    "rebase_view": "rebase_view.cu",
    "geom_cost": "geom_cost.cu",
    "gather_cols": "gather_cols.cu",
    "contract_lookup": "contract_lookup.cu",
    "gather_rows": "gather_rows.cu",
    "volume_sample": "volume_sample.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = "/usr/local/cuda/bin/nvcc"
        if os.path.exists(cand):
            return cand
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so_path(name: str) -> str:
    src = os.path.join(CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def _start(name: str) -> Tuple[subprocess.Popen, str, str, float]:
    so = _so_path(name)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so, time.perf_counter()


def _finish(name, proc, tmp, so, t0) -> Tuple[float, str]:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{out}")
    os.replace(tmp, so)
    return time.perf_counter() - t0, out


def build_all(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, Tuple[float, str]]:
    """Compile every named source that has no current library, all ``nvcc``
    processes at once. Returns name -> (seconds, compiler output) for the
    sources it compiled."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in names if not os.path.exists(_so_path(n))]
    started = {n: _start(n) for n in todo}
    results = {}
    try:
        for n, job in started.items():
            results[n] = _finish(n, *job)
    finally:
        for proc, *_ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def load(name: str, signatures: Dict[str, List]) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use), with each
    function's ``argtypes`` set from ``signatures`` and ``restype`` int
    (the kernel's ``cudaGetLastError()`` after the launch)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = _so_path(name)
            if not os.path.exists(so):
                build_all([name])
            lib = ctypes.CDLL(so)
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def on_device(t):
    """The context every launch runs in: ``t``'s card made the current
    device, so a kernel loaded through ``ctypes`` (which launches in the
    current CUDA context) runs where its tensors live, whatever card the
    caller has current. On the current card it changes nothing."""
    import torch

    return torch.cuda.device(t.device)


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError {err}")
