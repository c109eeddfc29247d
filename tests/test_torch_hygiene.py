"""Port hygiene: accessory_tpu_torch imports neither JAX nor accessory_tpu
(checked in a fresh interpreter and by an AST scan), its serving and
checkpoint paths need neither ``safetensors`` nor ``tokenizers``, its
entry points default to the CUDA device, so on a host without one they raise
instead of quietly running on the CPU, and its native host library is built
inside the package, never beside the JAX package's source."""

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
from accessory_tpu_torch import native
from accessory_tpu_torch.main_finetune import main as finetune_main
from accessory_tpu_torch.main_pretrain import main as pretrain_main
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.checkpoint import visual_import
from accessory_tpu_torch.models import (falcon, internlm, llama, llama_qformerv2, mixtral, sphinx,
                                        visual)
from accessory_tpu_torch.parallel import (init_distributed_mode, local_mesh, make_global_mesh,
                                          make_mesh)
from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
from accessory_tpu_torch.train.ckpt import resume_stage1
from accessory_tpu_torch.util import profiling
from accessory_tpu_torch.dit import sample as dit_sample
from accessory_tpu_torch.dit import train as dit_train
from accessory_tpu_torch.dit.diffusion import GaussianDiffusion
from accessory_tpu_torch.dit.model import init_dit
from accessory_tpu_torch.dit.timestep_sampler import (create_named_schedule_sampler,
                                                      init_sampler_state)
from accessory_tpu_torch.eval import eval_mm, run_eval

PKG_DIR = Path(accessory_tpu_torch.__file__).parent
REPO = PKG_DIR.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG_DIR)], "accessory_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    for name in ("ops.quant_matmul_planes", "ops.paged_decode", "ops.paged_write",
                 "engine.kvcache", "engine.scheduler", "demos.server", "data.conversation",
                 "data.alpaca", "data.system_prompt", "train.loss", "train.lr_sched",
                 "train.optim", "train.precision", "train.train_step", "train.ckpt",
                 "train.tree", "util.logging", "main_finetune", "parallel.mesh",
                 "parallel.distributed", "parallel.context", "ops.moe", "models.mixtral",
                 "models.internlm", "models.falcon", "models.static",
                 "checkpoint.torch_import", "models.visual", "models.sphinx",
                 "models.llama_qformerv2", "checkpoint.visual_import", "data.transform",
                 "data.data_reader", "sphinx_api", "demos.cli", "native", "data.falcon",
                 "data.falcon_packed", "tools.generate_packed_data", "main_pretrain",
                 "dit.diffusion", "dit.model", "dit.timestep_sampler", "dit.train",
                 "dit.sample", "eval.harness", "eval.tasks", "eval.run_eval", "eval.eval_mm",
                 "eval.code_exec", "eval.math_util", "tools.weight_operate",
                 "tools.convert_weights_to_hf", "tools.download"):
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


def test_multimodal_serving_needs_no_pil_or_transformers():
    """The card's machine has neither PIL nor transformers: with both (and
    jax) blocked, every module imports, and a tiny SPHINX model captions
    CLIP-normalized arrays through sphinx_api (generate_response,
    batch_caption) and scores an example with its image; reading an image
    file or a transformers model is what needs them."""
    code = """
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('PIL', 'transformers', 'jax'):
            raise ImportError(name + ' is blocked in this test')
sys.meta_path.insert(0, Block())
for m in %r:
    importlib.import_module(m)
import torch
from accessory_tpu_torch.sphinx_api import SPHINXModel, batch_caption
class Tok:
    bos_id, eos_id, n_words = 62, 63, 64
    def encode(self, s, bos, eos): return [self.bos_id] * bos + [ord(c) %% 62 for c in s]
    def decode(self, t): return ''.join(chr(48 + x) for x in t)
    def encode_segment(self, s): return self.encode(s, False, False)
    encode_wo_prefix_space = encode_segment
cfg = dict(dim=128, n_layers=1, n_heads=2, vocab_size=64, multiple_of=128, vit_patch=56,
           clip_width=32, clip_layers=1, clip_heads=2, dino_width=32, dino_layers=1,
           dino_heads=2, convnext_depths=(1, 1, 1, 1), convnext_dims=(8, 16, 32, 64),
           qformer_width=32, qformer_layers=1, qformer_heads=2)
m = SPHINXModel('llama_ens_light', cfg, max_seq_len=256, device='cpu', tokenizer=Tok()).quantize()
imgs = list(torch.randn(3, 3, 224, 224))
assert isinstance(m.generate_response([['what is this?', None]], image=imgs[0], max_gen_len=3), str)
assert len(batch_caption(m, imgs, batch_size=2, max_gen_len=3)) == 3
r = m.evaluate_examples(['a b'], [' c'], images=torch.stack(imgs[:1]))[0]
assert r['ppl'] >= 1
assert not [k for k in sys.modules if k.split('.')[0] in ('PIL', 'transformers', 'jax')]
print('ok')
""" % (_modules(),)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("fn", [llama.init_kv_cache, llama.init_params, params_from_jax,
                                Generator.__init__, MetaModel.__init__,
                                MetaModel.from_pretrained.__func__, load_checkpoint,
                                load_checkpoint_list, llama.init_paged_cache,
                                kvcache.init_paged_cache, paged_cache_from_jax,
                                ContinuousBatcher.__init__, serve, make_train_step,
                                finetune_main, pretrain_main, resume_stage1,
                                init_distributed_mode,
                                make_mesh, local_mesh, make_global_mesh,
                                mixtral.init_params, mixtral.init_kv_cache,
                                mixtral.init_paged_cache, internlm.init_params,
                                internlm.init_kv_cache, falcon.init_params,
                                falcon.init_kv_cache, sphinx.init_params,
                                llama_qformerv2.init_params, visual.init_vit,
                                visual.init_convnext, visual.init_qformer,
                                visual_import.convert_hf_clip_vision,
                                visual_import.convert_hf_dinov2, visual_import.convert_convnext,
                                visual_import.convert_hf_blip2_qformer, profiling.time_fn,
                                profiling.roofline_report, init_dit, dit_train.main,
                                dit_train.make_dit_train_step, dit_sample.sample,
                                dit_sample.main, dit_sample.load_dit_params,
                                GaussianDiffusion.p_sample_loop,
                                GaussianDiffusion.ddim_sample_loop, init_sampler_state,
                                create_named_schedule_sampler, run_eval.main, eval_mm.main])
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_native_builds_under_the_package(tmp_path, monkeypatch):
    """The library is built by source hash into ``accessory_tpu_torch/build/``
    (here redirected to a temporary directory) and nothing is written
    beside the reference's ``native/packing.cc``."""
    ref_dir = native.SRC.parents[2] / "native"
    before = sorted((p.name, p.stat().st_mtime_ns) for p in ref_dir.iterdir())
    assert native.BUILD_DIR == native.SRC.parents[1] / "build"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available(), native.build_error
    assert native.lib_path().parent == tmp_path / "build" and native.lib_path().exists()
    assert native.lib_path().name.startswith("packing-")
    assert sorted((p.name, p.stat().st_mtime_ns) for p in ref_dir.iterdir()) == before


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
    tx = make_optimizer(params, 1e-3)
    step = make_train_step(llama, args, tx)
    batch = {"examples": torch.ones((1, 8), dtype=torch.int32),
             "labels": torch.ones((1, 8), dtype=torch.int32)}
    with pytest.raises((RuntimeError, AssertionError)):
        step(TrainState.create(params, tx), batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed_mode()


def test_finetune_needs_no_yaml_optax_orbax_or_safetensors(tmp_path):
    """The card's machine has no PyYAML, optax, orbax, safetensors, tokenizers
    or jax: with all of them blocked, main_finetune reads a YAML data config,
    trains a QPEFT epoch on the CPU, saves and resumes."""
    (tmp_path / "a.json").write_text(
        '[{"instruction": "add two and two", "input": "", "output": "four"},'
        ' {"instruction": "name a colour", "input": "", "output": "blue"}]')
    (tmp_path / "data.yaml").write_text(f"META:\n  - path: {tmp_path / 'a.json'}\n"
                                        "    type: text\n    prompt_type: None\n")
    (tmp_path / "llama.json").write_text(
        '{"dim": 128, "n_layers": 1, "n_heads": 2, "vocab_size": 258, "multiple_of": 64,'
        ' "lora_rank": 2, "bias_tuning": true, "norm_tuning": true}')
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('yaml', 'optax', 'orbax', 'safetensors', 'tokenizers', 'jax'):
            raise ImportError(name + ' is blocked in this test')
sys.meta_path.insert(0, Block())
from accessory_tpu_torch import main_finetune
class Tok:
    bos_id, eos_id, n_words = 256, 257, 258
    def encode(self, s, bos, eos): return [256] * bos + list(s.encode()) + [257] * eos
t = {str(tmp_path)!r}
for epochs in ("1", "2"):
    a = main_finetune.get_args_parser().parse_args([
        "--llama_config", t + "/llama.json", "--tokenizer_path", "unused",
        "--data_config", t + "/data.yaml", "--output_dir", t + "/out", "--batch_size", "2",
        "--epochs", epochs, "--max_words", "64", "--quant", "--only_save_trainable"])
    state = main_finetune.main(a, tokenizer=Tok(), device="cpu")
assert state.step == 2, state.step
assert not [k for k in sys.modules
            if k.split('.')[0] in ('yaml', 'optax', 'orbax', 'safetensors', 'tokenizers', 'jax')]
print('ok')
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_dit_eval_and_tools_need_no_safetensors_pil_hub_or_optax(tmp_path):
    """The card's machine has no safetensors, PIL, huggingface_hub or optax:
    with them (and jax) blocked, DiT trains two iterations and saves, samples
    from that checkpoint, the eval primitives and a driver of each kind run
    on a tiny model through a stub tokenizer, code_exec checks a program,
    and the weight-delta and HF tools round-trip a checkpoint. Only
    eval_mm's image drivers read images with PIL."""
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('safetensors', 'PIL', 'huggingface_hub', 'optax', 'jax'):
            raise ImportError(name + ' is blocked in this test')
sys.meta_path.insert(0, Block())
import json, os, shutil
import numpy as np, torch
from accessory_tpu_torch.dit import sample, train
from accessory_tpu_torch.eval import code_exec, harness, tasks
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.tools import convert_weights_to_hf as hf, download, weight_operate
t = {str(tmp_path)!r}
rng = np.random.RandomState(0)
os.makedirs(t + '/shards')
np.savez(t + '/shards/a.npz', latents=rng.randn(4, 4, 8, 8).astype(np.float32),
         labels=np.arange(4))
dims = ['--dim', '32', '--n_layers', '1', '--n_heads', '2', '--input_size', '8',
        '--num_classes', '4']
a = train.get_args_parser().parse_args(['--data_dir', t + '/shards', '--output_dir', t + '/o',
    '--batch_size', '2', '--max_iters', '2', '--save_freq', '2', '--log_every', '1',
    '--schedule_sampler', 'loss-second-moment'] + dims)
state, ema = train.main(a, device='cpu')
s = sample.get_args_parser().parse_args(['--ckpt', t + '/o/iter2', '--steps', '2',
    '--labels', '1', '2', '--out', t + '/s.npz'] + dims)
assert sample.main(s, device='cpu').shape == (2, 4, 8, 8)
class Tok:
    bos_id, eos_id, n_words = 62, 63, 64
    def encode(self, s, bos, eos): return [self.bos_id] * bos + [ord(c) % 62 for c in s]
    def decode(self, t): return ''.join(chr(48 + x) for x in t)
    def encode_segment(self, s): return self.encode(s, False, False)
    encode_wo_prefix_space = encode_segment
cfg = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, multiple_of=32, vocab_size=64)
m = MetaModel('llama', cfg, max_seq_len=128, device='cpu', tokenizer=Tok())
assert harness.perplexity(m, 'hello world ' * 20, seq_len=64) > 1
assert harness.multiple_choice(m, [dict(question='a', choices=['b', 'c'], answer=0)])['total'] == 1
os.makedirs(t + '/ceval/val'); os.makedirs(t + '/ceval/dev')
for part in ('val', 'dev'):
    with open(t + f'/ceval/{{part}}/logic_{{part}}.csv', 'w') as f:
        f.write('id,question,A,B,C,D,answer\\n0,q?,1,2,3,4,A\\n')
assert 'logic' in tasks.eval_ceval(m, t + '/ceval', ntrain=1)['tasks']
with open(t + '/math.jsonl', 'w') as f:
    f.write(json.dumps(dict(problem='1+1?', solution='\\\\boxed{{2}}')) + '\\n')
assert tasks.eval_math(m, t + '/math.jsonl', max_gen_len=4)['total'] == 1
assert code_exec.check_program('assert 1 + 1 == 2')
m.save_pretrained(t + '/base')
m.params['norm']['weight'] += 0.5
m.save_pretrained(t + '/tuned')
weight_operate.extract_delta(t + '/base', t + '/tuned', t + '/delta')
weight_operate.apply_delta(t + '/base', t + '/delta', t + '/merged')
shutil.copy(t + '/base/config.json', t + '/merged/config.json')
hf.convert_to_hf(t + '/merged', t + '/hf')
back = hf.convert_hf_to_ours(t + '/hf', n_heads=4, n_kv_heads=2)
assert float(back['norm/weight'][0]) == 1.5
assert download.resolve_hf_path(t) == t
bad = sorted(k for k in sys.modules if k.split('.')[0] in
             ('safetensors', 'PIL', 'huggingface_hub', 'optax', 'jax'))
assert not bad, bad
print('ok')
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
