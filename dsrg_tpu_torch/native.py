"""The host-side C++ engines of ``native/*.cpp`` through ctypes
(``dsrg_tpu/native/__init__.py``).

The sources are the JAX package's own (``native/crf_cpu.cpp``,
``region_grow.cpp``, ``permutohedral_cpu.cpp``), compiled with ``g++`` and
the flags of ``native/Makefile`` (:func:`flags`) into
``dsrg_tpu_torch/_build/`` under a name that carries a hash of the sources,
the flags and the host's CPU (``-march=native``), at first use.
Nothing is written into ``native/``.  A failed build raises with the
compiler's output: no caller falls back to another engine.

The four functions take and return numpy arrays, as JAX's do:
:func:`crf_cpu` (the exact N^2 mean field), :func:`permutohedral_filter`,
:func:`crf_permutohedral` (the reference's lattice CRF, the oracle of
``tools/neutrality_study.py``) and :func:`region_grow_cpu`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCES = ("crf_cpu.cpp", "region_grow.cpp", "permutohedral_cpu.cpp")
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SERIAL_RUNTIME = Path(__file__).resolve().parent / "csrc" / "gomp_serial.cpp"
# native/Makefile's CXXFLAGS and OMPFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
OMP_FLAGS = ("-fopenmp",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _host() -> bytes:
    """What ``-march=native`` compiles for: the CPU's model and feature flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return b"".join(line for line in f if line.startswith((b"model name", b"flags")))
    except OSError:
        return b""


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native engines build with the host's C++ compiler")
    return cxx


def _has_openmp(cxx: str) -> bool:
    """Whether ``cxx -fopenmp`` compiles and links a program that includes
    ``<omp.h>`` (a compiler installed without libgomp does not)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe = BUILD_DIR / f"omp_probe.{os.getpid()}.cpp"
    probe.write_text("#include <omp.h>\nint main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n")
    try:
        return subprocess.run([cxx, *OMP_FLAGS, str(probe), "-o", str(probe.with_suffix(".out"))],
                              capture_output=True).returncode == 0
    finally:
        probe.unlink(missing_ok=True)
        probe.with_suffix(".out").unlink(missing_ok=True)


def _serial_include() -> Path:
    return BUILD_DIR / "serial_include"


def flags(cxx: str) -> tuple:
    """The Makefile's flags: CXXFLAGS and OMPFLAGS (``-fopenmp``).

    Where the compiler has no libgomp, the sources still compile with
    ``-fopenmp`` and link against ``csrc/gomp_serial.cpp``, a one-thread
    stand-in for the runtime, with an empty ``<omp.h>`` from
    ``_build/serial_include`` in case the header is missing too.  The loops
    are then the OpenMP build's code, and each ``parallel for`` splits
    independent rows, so the results are the OpenMP build's bits.  A build
    without ``-fopenmp`` (``make OMPFLAGS=``) would not give them: with
    ``-march=native`` g++ may compile a loop outside an OpenMP region with
    other FMA contractions (``build_kernel``'s distance sum, inlined with its
    constant feature width) than the same loop outlined inside one."""
    if _has_openmp(cxx):
        return CXX_FLAGS + OMP_FLAGS
    shim = _serial_include()
    shim.mkdir(parents=True, exist_ok=True)
    (shim / "omp.h").write_text("/* a build without libgomp: no omp_* call is made */\n")
    return CXX_FLAGS + OMP_FLAGS + ("-I" + str(shim),)


def library_path(build_flags: tuple) -> Path:
    """Where the library of the current sources, ``build_flags`` and host CPU
    lives (a library built for another CPU is never loaded)."""
    src = b"".join((SOURCE_DIR / name).read_bytes() for name in SOURCES) + SERIAL_RUNTIME.read_bytes()
    digest = hashlib.sha256(src + " ".join(build_flags).encode() + _host()).hexdigest()[:16]
    return BUILD_DIR / f"libdsrg_native-{digest}.so"


def _run(cmd: list, cwd=None) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=cwd)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")


def build() -> Path:
    """Compile the library unless it exists; returns its path.  Raises
    ``RuntimeError`` naming the compiler's output when the build fails."""
    cxx = _cxx()
    build_flags = flags(cxx)
    path = library_path(build_flags)
    if path.exists():
        return path
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    sources = [str(SOURCE_DIR / n) for n in SOURCES]
    try:
        if "-I" + str(_serial_include()) not in build_flags:
            _run([cxx, *build_flags, "-o", str(tmp), *sources])
        else:  # compile with -fopenmp, link without libgomp (see flags)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objs:
                _run([cxx, *build_flags, "-c", *sources, str(SERIAL_RUNTIME)], cwd=objs)
                _run([cxx, *CXX_FLAGS, "-Wl,-z,defs", "-o", str(tmp),
                      *sorted(str(o) for o in Path(objs).glob("*.o"))])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, path)  # atomic: another process never loads a partial file
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fp = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
            i, f = ctypes.c_int, ctypes.c_float
            lib.dsrg_crf_mean_field.argtypes = [fp, fp, fp, f, f, i, i, i, fp]
            lib.dsrg_crf_reference.argtypes = [fp, fp, i, i, i, i, f, f, fp]
            lib.dsrg_region_grow.argtypes = [fp, fp, fp, i, i, i, f, f, fp]
            lib.dsrg_permutohedral_filter.argtypes = [fp, fp, i, i, i, fp]
            lib.dsrg_crf_permutohedral.argtypes = [fp, fp, i, i, i, i, f, f, fp]
            for fn in (lib.dsrg_crf_mean_field, lib.dsrg_crf_reference, lib.dsrg_region_grow,
                       lib.dsrg_permutohedral_filter, lib.dsrg_crf_permutohedral):
                fn.restype = None
            _lib = lib
        return _lib


def _crf(entry: str, image, unary, maxiter: int, scale_factor: float, color_factor: float) -> np.ndarray:
    h, w, m = unary.shape
    img = np.ascontiguousarray(image, np.float32).reshape(h * w * 3)
    un = np.ascontiguousarray(unary, np.float32).reshape(h * w * m)
    out = np.empty(h * w * m, np.float32)
    getattr(_load(), entry)(img, un, h, w, m, maxiter, np.float32(scale_factor),
                            np.float32(color_factor), out)
    return out.reshape(h, w, m)


def crf_cpu(image: np.ndarray, unary: np.ndarray, maxiter: int = 10,
            scale_factor: float = 1.0, color_factor: float = 13.0) -> np.ndarray:
    """The exact dense CRF on the host: (H, W, 3) image, (H, W, M) scores ->
    (H, W, M) marginals."""
    return _crf("dsrg_crf_reference", image, unary, maxiter, scale_factor, color_factor)


def permutohedral_filter(feats: np.ndarray, values: np.ndarray) -> np.ndarray:
    """O(N*(d+1)) lattice Gaussian filter: (N, d) feats, (N, c) values -> (N, c)."""
    n, d = feats.shape
    c = values.shape[1]
    out = np.empty((n, c), np.float32)
    _load().dsrg_permutohedral_filter(np.ascontiguousarray(feats, np.float32),
                                      np.ascontiguousarray(values, np.float32), n, d, c, out)
    return out


def crf_permutohedral(image: np.ndarray, unary: np.ndarray, maxiter: int = 10,
                      scale_factor: float = 1.0, color_factor: float = 13.0) -> np.ndarray:
    """The permutohedral-lattice CRF of the reference's host engine
    (``CRF/src/permutohedral.cpp``), with :func:`crf_cpu`'s surface."""
    return _crf("dsrg_crf_permutohedral", image, unary, maxiter, scale_factor, color_factor)


def region_grow_cpu(labels: np.ndarray, cues: np.ndarray, probs: np.ndarray,
                    th1: float = 0.99, th2: float = 0.85) -> np.ndarray:
    """Seeded region growing on the host: (M,), (M, h, w), (M, h, w) -> (M, h, w)."""
    m, h, w = cues.shape
    out = np.empty(m * h * w, np.float32)
    _load().dsrg_region_grow(np.ascontiguousarray(labels, np.float32),
                             np.ascontiguousarray(cues, np.float32).reshape(m * h * w),
                             np.ascontiguousarray(probs, np.float32).reshape(m * h * w),
                             m, h, w, np.float32(th1), np.float32(th2), out)
    return out.reshape(m, h, w)
