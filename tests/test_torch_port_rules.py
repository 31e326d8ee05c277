"""Rules of the PyTorch/CUDA port, checked on its source.

- ``ray_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
  package ``ray_tpu``: the machine with the card has no JAX, and the port
  keeps its own copy of whatever it needs.
- ``chip_smoke.py`` fails and prints no result where it cannot run: with
  no CUDA device, or with no port beside it.
- The kernel wrappers and the kernel build hold no ``try``: on a CUDA
  tensor a wrapper launches its kernel or raises, and a failed build
  raises; nothing gives way to the plain version.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ray_tpu")
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
                 *NO_TRY_FILES):
        assert want in names
    for kernel in ("flash_fwd.cu", "flash_bwd.cu", "ln_matmul.cu",
                   "mm_res.cu", "tile_gemm.cuh", "hopper.cuh",
                   "hopper_gemm.cuh"):
        assert (ROOT / "ray_tpu_torch" / "csrc" / kernel).exists()


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
