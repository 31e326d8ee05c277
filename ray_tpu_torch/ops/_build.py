"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C entry point named ``<name>`` and is
compiled by ``nvcc`` for ``sm_90a`` into ``build/ray_tpu_torch/lib<name>.so``
at the root of the checkout, at first use, from the sources in the
checkout only. The library is loaded with ctypes. A build is redone when
the SHA-256 of the source and of the headers beside it (``csrc/*.cuh``)
differs from the one recorded beside the library.
``build`` compiles several sources at once, one ``nvcc`` each, all started
together. A failed build raises; nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ray_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return nvcc


def _digest(src: Path) -> str:
    """SHA-256 over the source and every header beside it, so that an edit
    to a shared header rebuilds the sources that include it."""
    h = hashlib.sha256()
    for path in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return h.hexdigest()


def build(*names: str) -> Dict[str, str]:
    """Compile each ``csrc/<name>.cu`` whose library beside its hash stamp
    is not current, all at once. Returns {name: nvcc's ptxas report} ('' for
    a library that was current). Raises RuntimeError with nvcc's output if
    a build fails."""
    started = {}
    for name in names:
        src = SRC_DIR / f"{name}.cu"
        lib = BUILD_DIR / f"lib{name}.so"
        stamp = lib.with_suffix(".so.sha256")
        digest = _digest(src)
        if lib.exists() and stamp.exists() \
                and stamp.read_text().strip() == digest:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, src, tmp, lib, stamp, digest)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, src, tmp, lib, stamp, digest) in started.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"CUDA kernel build of {src} failed (nvcc exit "
                          f"{proc.returncode}):\n{reports[name]}")
            continue
        os.replace(tmp, lib)          # atomic: concurrent loaders see old
        stamp.write_text(digest)      # or new, never a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str, argtypes: list) -> ctypes.CDLL:
    """The loaded library for kernel ``name`` (built first if stale), with
    the C entry point's argument types declared and an int return (the
    cudaError_t of the launch)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib
