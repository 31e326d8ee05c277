"""ray_tpu_torch.native — C++ performance layer, loaded via ctypes.

The image has no pybind11; the native pieces export a C ABI and build
on first import with the system g++ into a content-hashed cached .so
(so a source edit rebuilds, and N processes race benignly via atomic
rename). `load_store_lib()` returns None when no compiler is present —
callers fall back to the pure-Python implementations, which remain the
semantics reference.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

_SRC = os.path.join(os.path.dirname(__file__), "store.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cache_dir() -> str:
    d = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_native")
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha1(src).hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"librtpu_store_{tag}.so")
    if os.path.exists(out):
        return out
    tmp = out + f".tmp.{os.getpid()}"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: concurrent builders race benignly
        return out
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


_WIRE_SRC = os.path.join(os.path.dirname(__file__), "wirefast.c")
_wire_mod = None
_wire_tried = False


def load_wirefast():
    """The _rtpu_wirefast CPython extension (wire-codec decode hot path),
    or None — callers fall back to the pure-Python decoder, which stays
    the semantics reference."""
    global _wire_mod, _wire_tried
    with _lock:
        if _wire_tried:
            return _wire_mod
        _wire_tried = True
        if os.environ.get("RTPU_NATIVE_WIRE", "1") != "1":
            return None
        import sysconfig

        with open(_WIRE_SRC, "rb") as f:
            src = f.read()
        tag = hashlib.sha1(src).hexdigest()[:16]
        out = os.path.join(_cache_dir(), f"_rtpu_wirefast_{tag}.so")
        if not os.path.exists(out):
            tmp = out + f".tmp.{os.getpid()}"
            cmd = ["gcc", "-O2", "-shared", "-fPIC",
                   "-I", sysconfig.get_paths()["include"],
                   "-o", tmp, _WIRE_SRC]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=120)
                os.replace(tmp, out)
            except Exception:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return None
        try:
            import importlib.machinery
            import importlib.util

            loader = importlib.machinery.ExtensionFileLoader(
                "_rtpu_wirefast", out)
            spec = importlib.util.spec_from_file_location(
                "_rtpu_wirefast", out, loader=loader)
            _wire_mod = importlib.util.module_from_spec(spec)
            loader.exec_module(_wire_mod)
        except Exception:
            _wire_mod = None
        return _wire_mod


def load_store_lib() -> Optional[ctypes.CDLL]:
    """The C++ store library, or None (no compiler / build failure)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("RTPU_NATIVE_STORE", "1") != "1":
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u64, p = ctypes.c_uint64, ctypes.c_void_p
        lib.rtpu_store_open.restype = p
        lib.rtpu_store_open.argtypes = [ctypes.c_char_p, u64,
                                        ctypes.c_char_p, u64]
        lib.rtpu_store_create.restype = ctypes.c_int
        lib.rtpu_store_create.argtypes = [p, ctypes.c_char_p, u64]
        lib.rtpu_store_seal.restype = ctypes.c_int
        lib.rtpu_store_seal.argtypes = [p, ctypes.c_char_p, ctypes.c_int]
        lib.rtpu_store_verify.restype = ctypes.c_int
        lib.rtpu_store_verify.argtypes = [p, ctypes.c_char_p]
        lib.rtpu_store_pin.restype = ctypes.c_int
        lib.rtpu_store_pin.argtypes = [p, ctypes.c_char_p, ctypes.c_int]
        lib.rtpu_store_contains.restype = ctypes.c_int
        lib.rtpu_store_contains.argtypes = [p, ctypes.c_char_p]
        lib.rtpu_store_get.restype = ctypes.c_int
        lib.rtpu_store_get.argtypes = [p, ctypes.c_char_p,
                                       ctypes.POINTER(p),
                                       ctypes.POINTER(u64),
                                       ctypes.POINTER(ctypes.c_int)]
        lib.rtpu_store_delete.restype = ctypes.c_int
        lib.rtpu_store_delete.argtypes = [p, ctypes.c_char_p]
        lib.rtpu_store_stats.restype = None
        lib.rtpu_store_stats.argtypes = [p] + [ctypes.POINTER(u64)] * 5
        lib.rtpu_store_destroy.restype = None
        lib.rtpu_store_destroy.argtypes = [p]
        _lib = lib
        return _lib
