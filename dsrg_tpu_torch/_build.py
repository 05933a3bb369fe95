"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``.  A source that includes
PyTorch's headers takes minutes to build; these take seconds.  Libraries go
into ``dsrg_tpu_torch/_build/`` under a name that carries a hash of the
source, the headers and the flags, so an edited source is never served a
stale library.
Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    # the headers too: a source may include any of them
    src = b"".join(f.read_bytes() for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start one nvcc for ``name`` unless its library exists; returns
    (path, process or None)."""
    path = _lib_path(name)
    if path.exists():
        return path, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return path, (proc, tmp)


def _finish(name: str, path: Path, started) -> str:
    if started is None:
        saved = path.with_suffix(".log")
        return saved.read_text() if saved.exists() else ""
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, path)  # atomic: concurrent builders never load a partial file
    path.with_suffix(".log").write_text(log)
    return log


def build(names) -> dict:
    """Build every named kernel with one nvcc each, all started together.
    Returns {name: compiler log}."""
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def launch(lib_name: str, out: torch.Tensor, args, entry: str = "") -> None:
    """Call the C entry point ``entry`` (by default ``lib_name``) of
    ``csrc/<lib_name>.cu`` on the current stream of ``out``'s device.
    ``args``: the kernel's arguments before the output (tensors and ints),
    then the ints after it; the stream comes last.  Raises on a non-zero
    CUDA error code."""
    entry = entry or lib_name
    fn = getattr(load(lib_name), entry)
    before, after = args
    fn.argtypes = ([ctypes.c_void_p if isinstance(a, torch.Tensor) else ctypes.c_int for a in before]
                   + [ctypes.c_void_p] + [ctypes.c_int] * len(after) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in before),
                out.data_ptr(), *after, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {rc}")
