"""Rules of the PyTorch/CUDA port, checked on its source.

- ``ray_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
  package ``ray_tpu``: the machine with the card has no JAX, and the port
  keeps its own copy of whatever it needs.
- ``chip_smoke.py`` fails and prints no result where it cannot run: with
  no CUDA device, or with no port beside it.
- The kernel wrappers and the kernel build hold no ``try``: on a CUDA
  tensor a wrapper launches its kernel or raises, and a failed build
  raises; nothing gives way to the plain version.
- No string literal names a module of ``ray_tpu``: a module path in a
  string (``"-m", "ray_tpu.core.worker_main"``) would start the JAX
  package's code where the port's was meant.
- The port imports no third-party module beyond what the machine with
  the card has (torch, numpy, triton, scipy, einops) and what it carries
  itself (``ray_tpu_torch._vendor``): no ``ml_dtypes``, no site
  ``cloudpickle``.
- A worker process of the port's runtime starts without torch: the
  package loads it only when a task needs it.
- No string literal names a path under ``/tmp``: what the port writes
  (session directories and their sockets, spill, logs, caches) goes under
  ``tempfile.gettempdir()``, so a caller's ``TMPDIR`` holds it and two
  checkouts run side by side never share it.
"""
import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ray_tpu")
# the third-party packages of the machine with the card that the port may
# import; anything else must be the standard library or the port itself
THIRD_PARTY = ("torch", "numpy", "triton", "scipy", "einops")
NO_TRY_FILES = ("ray_tpu_torch/ops/flash_attention.py",
                "ray_tpu_torch/ops/fused.py",
                "ray_tpu_torch/ops/_build.py")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def imported_modules(tree: ast.AST):
    """(line, module) for every import statement and every
    importlib.import_module / __import__ call with a literal name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for want in ("ray_tpu_torch/__init__.py", "chip_smoke.py",
                 "ray_tpu_torch/serve/llm/prefix_cache.py",
                 "ray_tpu_torch/models/moe.py", "ray_tpu_torch/models/vit.py",
                 "ray_tpu_torch/models/resnet.py",
                 "ray_tpu_torch/models/mlp.py",
                 "ray_tpu_torch/core/worker_main.py",
                 "ray_tpu_torch/cgraph/compiled.py",
                 "ray_tpu_torch/serve/llm/disagg.py",
                 "ray_tpu_torch/parallel/pipeline.py",
                 "ray_tpu_torch/parallel/collective.py",
                 "ray_tpu_torch/parallel/zero.py",
                 "ray_tpu_torch/train/pipeline_cgraph.py",
                 "ray_tpu_torch/train/pipeline_engine.py",
                 "ray_tpu_torch/parallel/mesh.py",
                 "ray_tpu_torch/parallel/mesh_group.py",
                 "ray_tpu_torch/parallel/sharding/layout.py",
                 "ray_tpu_torch/parallel/sharding/owner.py",
                 "ray_tpu_torch/parallel/sharding/lower.py",
                 "ray_tpu_torch/parallel/sharding/tensor_parallel.py",
                 "ray_tpu_torch/_vendor/cloudpickle/cloudpickle.py",
                 *NO_TRY_FILES):
        assert want in names
    for kernel in ("flash_fwd.cu", "flash_bwd.cu", "ln_matmul.cu",
                   "mm_res.cu", "tile_gemm.cuh", "hopper.cuh",
                   "hopper_gemm.cuh"):
        assert (ROOT / "ray_tpu_torch" / "csrc" / kernel).exists()
    assert (ROOT / "ray_tpu_torch" / "_vendor" / "cloudpickle" /
            "LICENSE").exists()


def test_fused_kernels_are_hand_written_wgmma_and_tma():
    """The bf16 fused entry and exit run the GEMM of hopper_gemm.cuh
    (wgmma, TMA loads and stores); no source of theirs reaches a library
    GEMM or the mma.sync fragments of nvcuda::wmma, and the f32 GEMM of
    tile_gemm.cuh is FMA only."""
    csrc = ROOT / "ray_tpu_torch" / "csrc"
    texts = {name: (csrc / name).read_text() for name in (
        "ln_matmul.cu", "mm_res.cu", "hopper_gemm.cuh", "tile_gemm.cuh",
        "hopper.cuh")}
    for name in ("ln_matmul.cu", "mm_res.cu"):
        assert '#include "hopper_gemm.cuh"' in texts[name], name
        assert "hgemm::launch<" in texts[name], name
    gemm = texts["hopper_gemm.cuh"]
    for used in ("Wgmma<BN, 1>::rs", "Wgmma<BN, 1>::ss", "tma_load_2d",
                 "tma_store_2d", "ldmatrix_x4"):
        assert used in gemm, used
    for name, text in texts.items():
        for banned in ("wmma::", "mma.h", "cublas", "cutlass", "mma.sync"):
            assert banned not in text.lower(), (name, banned)
    assert "fmaf(" in texts["tile_gemm.cuh"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_no_jax_and_no_ray_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in imported_modules(tree)
           if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("source,bad", [
    ("import jax.numpy as jnp", True),
    ("from jaxlib import xla_client", True),
    ("from ray_tpu.ops import mha_reference", True),
    ("import importlib\nimportlib.import_module('ray_tpu.models')", True),
    ("__import__('jax')", True),
    ("from ray_tpu_torch.ops import mha_reference", False),
    ("from .ops import layers", False),
    ("import torch", False),
])
def test_import_rule_catches_what_it_should(source, bad):
    found = [m for _, m in imported_modules(ast.parse(source))
             if _forbidden(m)]
    assert bool(found) == bad


@pytest.mark.parametrize("rel", NO_TRY_FILES)
def test_kernel_launch_and_build_have_no_try(rel):
    tree = ast.parse((ROOT / rel).read_text())
    tries = [n.lineno for n in ast.walk(tree)
             if isinstance(n, (ast.Try, getattr(ast, "TryStar", ast.Try)))]
    assert not tries, f"{rel} has try statements at lines {tries}"


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_port(where, tmp_path):
    """With no CUDA device visible, in the checkout or copied away from
    the package, the script exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


_DOTTED = re.compile(r"(?<![\w.])ray_tpu(?:\.[A-Za-z_]\w*)*")


def _is_reference_module(dotted: str) -> bool:
    path = ROOT.joinpath(*dotted.split("."))
    return path.with_suffix(".py").exists() or (path / "__init__.py").exists()


def reference_modules_named(tree: ast.AST):
    """(line, name) for each string literal that names a module of the
    JAX package: the whole string is ``ray_tpu``, or it holds a dotted
    ``ray_tpu.x[.y]`` whose prefix past ``ray_tpu`` is a module there."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant)
                and isinstance(node.value, str)):
            continue
        if node.value.strip() == "ray_tpu":
            yield node.lineno, node.value
            continue
        for m in _DOTTED.finditer(node.value):
            parts = m.group(0).split(".")
            if any(_is_reference_module(".".join(parts[:i]))
                   for i in range(2, len(parts) + 1)):
                yield node.lineno, m.group(0)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_strings_name_no_reference_module(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = list(reference_modules_named(tree))
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


@pytest.mark.parametrize("source,bad", [
    ('cmd = [sys.executable, "-m", "ray_tpu.core.worker_main"]', True),
    ('name = "ray_tpu"', True),
    ('"""counterpart of ray_tpu.serve.llm"""', True),
    ('cmd = ["-m", "ray_tpu_torch.core.worker_main"]', False),
    ('"""counterpart of ray_tpu/serve/llm/engine.py:409"""', False),
    ('msg = "call ray_tpu_torch.init() first"', False),
    ('metric = "ray_tpu_task_events_total"', False),
])
def test_string_rule_catches_what_it_should(source, bad):
    assert bool(list(reference_modules_named(ast.parse(source)))) == bad


def _outside_module(module: str) -> bool:
    top = module.split(".")[0]
    return not (top in sys.stdlib_module_names or top in THIRD_PARTY
                or top == "ray_tpu_torch" or top == "__future__")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_only_what_the_card_machine_has(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in imported_modules(tree)
           if _outside_module(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("source,bad", [
    ("import ml_dtypes", True),
    ("import cloudpickle", True),
    ("from cloudpickle import CloudPickler", True),
    ("from .._vendor import cloudpickle", False),
    ("from ray_tpu_torch._vendor import cloudpickle", False),
    ("import torch, numpy, pickle", False),
])
def test_third_party_rule_catches_what_it_should(source, bad):
    found = [m for _, m in imported_modules(ast.parse(source))
             if _outside_module(m)]
    assert bool(found) == bad


def test_worker_main_starts_without_torch():
    """A worker starts as ``python -S -m ray_tpu_torch.core.worker_main``
    with the parent's path in PYTHONPATH: importing its module (and with
    it the package) loads neither torch nor JAX nor the JAX package."""
    code = ("import sys, ray_tpu_torch.core.worker_main; print(sorted("
            "m for m in ('torch', 'jax', 'ray_tpu', 'cloudpickle', "
            "'ml_dtypes') if m in sys.modules))")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT)] + sys.path[1:])}
    out = subprocess.run([sys.executable, "-S", "-c", code], env=env,
                         cwd=str(ROOT.parent), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_TMP = re.compile(r"(?<![\w.])/tmp(?![\w.-])")


def fixed_tmp_paths(tree: ast.AST):
    """(line, string) for each string literal that names /tmp or a path
    under it."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _TMP.search(node.value):
            yield node.lineno, node.value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_strings_name_no_fixed_tmp_path(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = list(fixed_tmp_paths(tree))
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


@pytest.mark.parametrize("source,bad", [
    ('d = "/tmp/ray_tpu_torch"', True),
    ('d = os.path.join("/tmp", "x")', True),
    ('spill = "/tmp/ray_tpu_spill"', True),
    ('d = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_spill")', False),
    ('out = path + ".tmp"', False),
    ('name = "session.tmp/x"', False),
])
def test_tmp_rule_catches_what_it_should(source, bad):
    assert bool(list(fixed_tmp_paths(ast.parse(source)))) == bad
