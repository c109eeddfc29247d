"""Port hygiene: accessory_tpu_torch imports neither JAX nor accessory_tpu
(checked in a fresh interpreter and by an AST scan), its serving and
checkpoint paths need neither ``safetensors`` nor ``tokenizers``, and its
entry points default to the CUDA device, so on a host without one they raise
instead of quietly running on the CPU."""

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
from accessory_tpu_torch.checkpoint import load_checkpoint, load_checkpoint_list
from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.convert import paged_cache_from_jax, params_from_jax
from accessory_tpu_torch.demos.server import serve
from accessory_tpu_torch.engine import kvcache
from accessory_tpu_torch.engine.generate import Generator
from accessory_tpu_torch.engine.scheduler import ContinuousBatcher
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.models import llama

PKG_DIR = Path(accessory_tpu_torch.__file__).parent
REPO = PKG_DIR.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG_DIR)], "accessory_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    for name in ("ops.quant_matmul_planes", "ops.paged_decode", "ops.paged_write",
                 "engine.kvcache", "engine.scheduler", "demos.server", "data.conversation"):
        assert "accessory_tpu_torch." + name in mods
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


def test_checkpoint_and_serving_need_no_safetensors_or_tokenizers(tmp_path):
    """A machine with neither library saves, loads and serves: in a fresh
    interpreter where both imports are blocked, every module imports, a
    quantized model is saved with save_pretrained, read back bit for bit and
    generates through a stub tokenizer. (``tokenizers`` is imported only by
    ``Tokenizer`` for a tokenizer.json, ``safetensors`` nowhere.)"""
    code = f"""
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('safetensors', 'tokenizers', 'jax'):
            raise ImportError(name + ' is blocked in this test')
sys.meta_path.insert(0, Block())
for m in {_modules()!r}:
    importlib.import_module(m)
import torch
from accessory_tpu_torch.checkpoint import load_checkpoint
from accessory_tpu_torch.meta import MetaModel
class Tok:
    bos_id, eos_id, n_words = 62, 63, 64
    def encode(self, s, bos, eos): return [self.bos_id] * bos + [ord(c) % 62 for c in s]
    def decode(self, t): return ''.join(chr(48 + x) for x in t)
    def encode_segment(self, s): return self.encode(s, False, False)
    encode_wo_prefix_space = encode_segment
cfg = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, multiple_of=128, vocab_size=64)
m = MetaModel('llama', cfg, max_seq_len=64, device='cpu').quantize()
m.tokenizer = Tok()
m.save_pretrained({str(tmp_path)!r})
back = load_checkpoint({str(tmp_path)!r}, m.args, device='cpu')
w, b = (p['layers'][1]['feed_forward']['w2']['weight'] for p in (m.params, back))
assert torch.equal(w.packed, b.packed) and torch.equal(w.zeros, b.zeros)
assert torch.equal(m.params['output']['weight'], back['output']['weight'])
m.params = back
assert len(m.generate(['hello'], max_gen_len=4)) == 1
assert list(m.stream_generate('hello', max_gen_len=3))[-1]['end_of_content']
assert not [k for k in sys.modules if k.split('.')[0] in ('safetensors', 'tokenizers', 'jax')]
print('ok')
"""
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
                                Generator.__init__, MetaModel.__init__,
                                MetaModel.from_pretrained.__func__, load_checkpoint,
                                load_checkpoint_list, llama.init_paged_cache,
                                kvcache.init_paged_cache, paged_cache_from_jax,
                                ContinuousBatcher.__init__, serve])
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
    with pytest.raises((RuntimeError, AssertionError)):
        llama.init_paged_cache(args, slots=1, total_pages=3, page_size=8)
    params = llama.init_params(args, device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        ContinuousBatcher(llama, args, params, None, slots=1, page_size=8)
