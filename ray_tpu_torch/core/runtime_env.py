"""Per-task/actor runtime environments.

Equivalent of the reference's runtime_env machinery (ref:
dashboard/modules/runtime_env/runtime_env_agent.py:161 CreateRuntimeEnv;
python/ray/_private/runtime_env/working_dir.py + py_modules.py packaging;
runtime_env/packaging.py zip-and-upload protocol).

Design: the submitting process validates the env, zips any local
directories, and uploads them as content-addressed blobs in the GCS KV
("renv" namespace) — the same channel function exports already ride.
Workers are DEDICATED to one environment (reference semantics:
worker_pool.cc keys PopWorker by runtime_env hash): the node's lease
dispatch only hands a task to a worker bound to the same env hash, and a
fresh worker applies the env exactly once before its first task —
env_vars into os.environ, extracted working_dir as cwd + sys.path head,
py_modules onto sys.path.

pip envs install into per-requirement-set venvs on the worker host
(--system-site-packages so the base stack stays importable); pip's
standard source controls (PIP_INDEX_URL / --no-index / --find-links)
point at a mirror or wheelhouse on air-gapped pods. conda/container
remain gated: a clear error beats a silent ignore.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import sys
import tempfile
import zipfile
from typing import Callable, Dict, List, Optional

ALLOWED_KEYS = {"env_vars", "working_dir", "py_modules", "pip", "config",
                "container"}
# conda stays gated by design (README "runtime_env design stance"):
# TPU hosts run hermetic images whose Python stack must match the
# baked-in jax/libtpu; pip-in-venv (--system-site-packages) layers on
# top of it, while a conda env REPLACES the interpreter and would
# detach workers from the host's TPU stack. Container isolation is the
# supported heavyweight path.
GATED_KEYS = {"conda", "image_uri", "uv"}
# ref: runtime_env/packaging.py GCS_STORAGE_MAX_SIZE guard
MAX_PACKAGE_BYTES = 500 * 1024 * 1024
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}

KV_NAMESPACE = "renv"


def validate(renv: Optional[dict]) -> Optional[dict]:
    """Normalize and reject unknown/gated keys early, in the submitter."""
    if not renv:
        return None
    gated = GATED_KEYS & renv.keys()
    if gated:
        raise ValueError(
            f"runtime_env keys {sorted(gated)} are not supported on this "
            f"runtime: TPU hosts run hermetic images; ship code via "
            f"working_dir/py_modules/pip and configuration via env_vars")
    unknown = renv.keys() - ALLOWED_KEYS
    if unknown:
        raise ValueError(f"unknown runtime_env keys {sorted(unknown)}; "
                         f"supported: {sorted(ALLOWED_KEYS)}")
    out: dict = {}
    env_vars = renv.get("env_vars") or {}
    if env_vars:
        if not isinstance(env_vars, dict):
            raise TypeError("env_vars must be a dict")
        out["env_vars"] = {str(k): str(v) for k, v in env_vars.items()}
    if renv.get("working_dir"):
        out["working_dir"] = str(renv["working_dir"])
    mods = renv.get("py_modules") or []
    if mods:
        out["py_modules"] = [str(m) for m in mods]
    if "container" in renv and renv["container"] is not None:
        cont = renv["container"]
        # ref: runtime_env/container.py (podman wrapper there). Shape:
        # {"image": str, "run_options": [str]}; workers for this env are
        # LAUNCHED inside the container via the configured launcher
        # (config.container_launcher; scripts/container_worker_launcher
        # is the docker reference) — a running worker can't be moved
        # into one after the fact.
        if isinstance(cont, str):
            cont = {"image": cont}
        if not isinstance(cont, dict) or not cont.get("image"):
            raise TypeError('container must be {"image": str, '
                            '"run_options": [str]} or an image string')
        out["container"] = {
            "image": str(cont["image"]),
            "run_options": [str(o) for o in cont.get("run_options", [])],
        }
    if "pip" in renv and renv["pip"] is not None:
        pip = renv["pip"]
        # ref: runtime_env/pip.py — list of requirement strings, or
        # {"packages": [...], "pip_install_options": [...]}. Installs go
        # into a per-requirement-set venv on the worker host; standard
        # pip env (PIP_INDEX_URL / PIP_NO_INDEX / PIP_FIND_LINKS) and
        # the explicit options control where packages come from — on an
        # air-gapped pod that is a local mirror or wheelhouse.
        if isinstance(pip, (list, tuple)):
            if not pip:
                raise ValueError("runtime_env pip list must be non-empty")
            out["pip"] = {"packages": [str(p) for p in pip],
                          "pip_install_options": []}
        elif isinstance(pip, dict):
            pkgs = pip.get("packages")
            if not pkgs:
                raise ValueError("runtime_env pip dict needs 'packages'")
            out["pip"] = {
                "packages": [str(p) for p in pkgs],
                "pip_install_options": [
                    str(o) for o in pip.get("pip_install_options") or []]}
        else:
            raise TypeError("pip must be a list of requirements or a "
                            "{'packages': [...]} dict")
    if renv.get("config"):
        out["config"] = dict(renv["config"])
    return out or None


def _zip_dir(path: str) -> bytes:
    """Deterministic zip of a directory tree (sorted walk, zeroed
    timestamps) so identical trees hash identically across submitters."""
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
            for name in sorted(files):
                full = os.path.join(root, name)
                rel = os.path.relpath(full, path)
                try:
                    data = open(full, "rb").read()
                except OSError:
                    continue  # sockets, vanished tmpfiles
                total += len(data)
                if total > MAX_PACKAGE_BYTES:
                    raise ValueError(
                        f"runtime_env package {path!r} exceeds "
                        f"{MAX_PACKAGE_BYTES >> 20} MiB")
                info = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
                info.compress_type = zipfile.ZIP_DEFLATED
                zf.writestr(info, data)
    return buf.getvalue()


def _upload_dir(path: str, kv_put: Callable[[str, bytes], None]) -> dict:
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"runtime_env directory {path!r} not found")
    blob = _zip_dir(path)
    sha = hashlib.sha1(blob).hexdigest()
    kv_put(f"pkg:{sha}", blob)
    return {"pkg": sha, "name": os.path.basename(path.rstrip(os.sep))}


def package(renv: Optional[dict],
            kv_put: Callable[[str, bytes], None]) -> Optional[dict]:
    """Submitter side: replace local paths with content-addressed KV
    references, then stamp the whole env with its hash (the worker-pool
    dedication key)."""
    renv = validate(renv)
    if renv is None:
        return None
    out = dict(renv)
    if "working_dir" in out:
        out["working_dir"] = _upload_dir(out["working_dir"], kv_put)
    if "py_modules" in out:
        out["py_modules"] = [_upload_dir(m, kv_put)
                             for m in out["py_modules"]]
    out["_hash"] = hashlib.sha1(
        json.dumps(out, sort_keys=True).encode()).hexdigest()[:16]
    return out


_FP_TTL = 5.0  # seconds a directory fingerprint stays cached
_fp_cache: Dict[str, tuple] = {}  # path -> (monotonic_ts, fingerprint)


def dir_fingerprint(path: str) -> str:
    """Cheap content fingerprint (relpath, size, mtime_ns of every file)
    so submitter-side caches notice edited working_dirs without paying a
    full re-zip per submission. The walk itself is memoized for a few
    seconds — task-submission hot loops must not pay one stat() per
    tracked file per .remote() call."""
    import time

    path = os.path.abspath(os.path.expanduser(path))
    hit = _fp_cache.get(path)
    now = time.monotonic()
    if hit is not None and now - hit[0] < _FP_TTL:
        return hit[1]
    fp = _dir_fingerprint_uncached(path)
    _fp_cache[path] = (now, fp)
    return fp


def _dir_fingerprint_uncached(path: str) -> str:
    h = hashlib.sha1()
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
        for name in sorted(files):
            full = os.path.join(root, name)
            try:
                st = os.stat(full)
            except OSError:
                continue
            h.update(f"{os.path.relpath(full, path)}|{st.st_size}|"
                     f"{st.st_mtime_ns}\n".encode())
    return h.hexdigest()[:16]


def cache_key(renv: dict) -> str:
    """Cache key for a VALIDATED (pre-packaging) env: the env dict plus
    fingerprints of every referenced local directory — a path alone would
    serve stale packages after the user edits the tree."""
    fps = {}
    wd = renv.get("working_dir")
    if wd:
        fps["working_dir"] = dir_fingerprint(wd)
    for i, m in enumerate(renv.get("py_modules") or []):
        fps[f"py_modules.{i}"] = dir_fingerprint(m)
    return json.dumps({"env": renv, "fp": fps}, sort_keys=True)


def container_command(launcher: str, container: dict,
                      base_cmd: list) -> list:
    """THE launcher invocation contract, shared by the local Node and
    remote NodeAgent worker starts:
        <launcher> <image> [run_options...] -- <worker cmd...>
    (scripts/container_worker_launcher.sh is the docker reference)."""
    return [str(launcher), container["image"],
            *container.get("run_options", []), "--", *base_cmd]


def env_hash(packaged: Optional[dict]) -> str:
    """'' = the plain environment (no runtime_env)."""
    return packaged.get("_hash", "") if packaged else ""


def merge(base: Optional[dict], override: Optional[dict]) -> Optional[dict]:
    """Job-level default + per-task override (ref:
    runtime_env.py:merge_runtime_env): env_vars union (task wins),
    other keys replaced wholesale."""
    if not base:
        return override
    if not override:
        return base
    out = dict(base)
    out.update({k: v for k, v in override.items() if k != "env_vars"})
    ev = dict(base.get("env_vars") or {})
    ev.update(override.get("env_vars") or {})
    if ev:
        out["env_vars"] = ev
    out.pop("_hash", None)
    return out


# -- worker side --------------------------------------------------------------

def _cache_root() -> str:
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch_runtime_env")


def _extract(ref: dict, kv_get: Callable[[str], bytes]) -> str:
    """Fetch+extract a packaged dir into the shared content-addressed
    cache. Concurrent workers race benignly: extraction goes to a
    process-private temp dir, then one atomic rename wins."""
    sha = ref["pkg"]
    dest = os.path.join(_cache_root(), sha)
    if os.path.isdir(dest):
        return dest
    blob = kv_get(f"pkg:{sha}")
    if blob is None:
        raise RuntimeError(f"runtime_env package {sha} missing from KV")
    os.makedirs(_cache_root(), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_cache_root(), prefix=f".{sha}.")
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        zf.extractall(tmp)
    try:
        os.rename(tmp, dest)
    except OSError:
        if not os.path.isdir(dest):  # lost the race is fine; else real error
            raise
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return dest


def _venv_site_packages(venv_dir: str) -> str:
    vpy = f"python{sys.version_info.major}.{sys.version_info.minor}"
    return os.path.join(venv_dir, "lib", vpy, "site-packages")


def _ensure_pip_env(pip_spec: dict) -> str:
    """Create (or reuse) the venv for this requirement set; returns its
    site-packages path. Cache key = packages + options + interpreter
    version; builds are atomic-rename like _extract so concurrent
    workers race benignly (ref: runtime_env/pip.py PipProcessor)."""
    import shutil
    import subprocess

    key = hashlib.sha1(json.dumps(
        {"pkgs": sorted(pip_spec["packages"]),
         "opts": pip_spec.get("pip_install_options") or [],
         "py": sys.version_info[:2]},
        sort_keys=True).encode()).hexdigest()[:16]
    dest = os.path.join(_cache_root(), f"venv_{key}")
    if os.path.isdir(dest):
        return _venv_site_packages(dest)
    os.makedirs(_cache_root(), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_cache_root(), prefix=f".venv_{key}.")
    try:
        # --system-site-packages: the worker's own stack (ray_tpu_torch, jax,
        # numpy) must stay importable alongside the extra packages
        subprocess.run([sys.executable, "-m", "venv",
                        "--system-site-packages", tmp],
                       check=True, capture_output=True, timeout=120)
        vpip = os.path.join(tmp, "bin", "python")
        out = subprocess.run(
            [vpip, "-m", "pip", "install", "--no-input",
             *pip_spec.get("pip_install_options", []),
             *pip_spec["packages"]],
            capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise RuntimeError(
                f"runtime_env pip install failed "
                f"(packages={pip_spec['packages']}):\n{out.stderr[-2000:]}")
        os.rename(tmp, dest)
    except KeyboardInterrupt:
        shutil.rmtree(tmp, ignore_errors=True)
        raise  # never swallow interrupts, winner or not
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        if not os.path.isdir(dest):  # a concurrent builder may have won
            raise
    return _venv_site_packages(dest)


def apply(packaged: Optional[dict],
          kv_get: Callable[[str], bytes]) -> None:
    """Apply an environment to THIS process (called once, before the
    worker's first task — the worker is dedicated from then on)."""
    if not packaged:
        return
    for k, v in (packaged.get("env_vars") or {}).items():
        os.environ[k] = v
    pip_spec = packaged.get("pip")
    if pip_spec:
        site = _ensure_pip_env(pip_spec)
        if site not in sys.path:
            sys.path.insert(0, site)
    paths: List[str] = []
    wd = packaged.get("working_dir")
    if wd:
        dest = _extract(wd, kv_get)
        paths.append(dest)
        os.chdir(dest)
    for ref in packaged.get("py_modules") or []:
        dest = _extract(ref, kv_get)
        # a py_modules entry IS the importable package: expose it under
        # its original name via an aliasing dir on sys.path (the zip is
        # rooted inside the package; ref: py_modules.py upload contract)
        alias_root = dest + "_pkg"
        os.makedirs(alias_root, exist_ok=True)
        link = os.path.join(alias_root, ref["name"])
        if not os.path.lexists(link):
            try:
                os.symlink(dest, link)
            except FileExistsError:
                pass  # concurrent worker won the race
        paths.append(alias_root)
    for p in reversed(paths):
        if p not in sys.path:
            sys.path.insert(0, p)
