"""Port hygiene: accessory_tpu_torch imports neither JAX nor accessory_tpu
(checked in a fresh interpreter and by an AST scan), and its entry points
default to the CUDA device, so on a host without one they raise instead of
quietly running on the CPU."""

import ast
import inspect
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import accessory_tpu_torch
from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.convert import params_from_jax
from accessory_tpu_torch.engine.generate import Generator
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.models import llama

PKG_DIR = Path(accessory_tpu_torch.__file__).parent
REPO = PKG_DIR.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG_DIR)], "accessory_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "accessory_tpu_torch.ops.quant_matmul_planes" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'accessory_tpu' or k.startswith('accessory_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_jax_or_reference_imports_in_source():
    offenders = []
    for path in sorted(PKG_DIR.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "flax", "accessory_tpu"):
                    offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders


@pytest.mark.parametrize("fn", [llama.init_kv_cache, llama.init_params, params_from_jax,
                                Generator.__init__, MetaModel.__init__])
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_raises_without_cuda():
    """Built without device="cpu", an entry point goes to CUDA; where there is
    none it must raise, never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default then works")
    args = LLaMAArgs(dim=64, n_layers=1, n_heads=2, n_kv_heads=1, vocab_size=32,
                     multiple_of=32, max_seq_len=16)
    with pytest.raises((RuntimeError, AssertionError)):
        llama.init_kv_cache(args, 1, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        llama.init_params(args)
