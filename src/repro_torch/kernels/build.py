"""Builds the CUDA kernels of ``csrc/`` with ``nvcc`` and loads them with
``ctypes``.

The sources have a plain C interface (no PyTorch headers), so each compiles
in seconds.  ``library()`` builds at first use: one ``nvcc -c`` per source,
all started together, then one link into a shared library under
``src/repro_torch/_build/`` (git-ignored), named by a hash of the sources and
flags so an edited source is rebuilt and an unchanged one is reused.
Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("dg_volume.cu", "dg_flux.cu", "flash_attention.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_SIGNATURES = {
    # q, D, rho, lam, mu, out, K, M, metric0..2, stream
    "dg_volume_f64": [_P] * 6 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_double] * 3 + [_P],
    "dg_volume_f32": [_P] * 6 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_double] * 3 + [_P],
    # Sm, vm, Sp, vp, mats, FE, Fv, F, M*M, axis, sign, stream
    "dg_flux_f64": [_P] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_double, _P],
    "dg_flux_f32": [_P] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_double, _P],
    # q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, causal, window, q_offset, stream
    "flash_attention_bf16": [_P] * 4 + [ctypes.c_int] * 6 + [ctypes.c_double] + [ctypes.c_int] * 3 + [_P],
    "flash_attention_f32": [_P] * 4 + [ctypes.c_int] * 6 + [ctypes.c_double] + [ctypes.c_int] * 3 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
_build_log: str = ""


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libdg_kernels_{_digest()}.so"


def build() -> Path:
    """Compile every source (in parallel) and link them into one shared
    library; returns its path.  Raises with nvcc's output on failure."""
    global _build_log
    target = library_path()
    if target.exists():
        return target
    cc = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [cc, *FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== nvcc {name}\n{out}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / target.name
        link = [cc, *ARCH, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)]
        r = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link\n{r.stdout}")
        if r.returncode != 0:
            raise RuntimeError("linking the kernels failed:\n" + "\n".join(logs))
        os.replace(tmp_lib, target)
    _build_log = "\n".join(logs)
    return target


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
    the build this process ran, or "" when the library was already built."""
    return _build_log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.dg_error_string.argtypes = [ctypes.c_int]
        lib.dg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = library().dg_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
