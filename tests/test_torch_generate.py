"""Port parity, whole slice: a small W4 LLaMA (dim 256, 2 layers, 4 query /
2 KV heads) built and quantized by the JAX package, served by the JAX
Generator on its unrolled decode path (fused wqkv/w13, the Pallas planes
and fused decode-attention kernels in interpret mode) and, after
params_from_jax, by the port's Generator on the CPU (the kernels' plain
versions). Greedy text must be identical; logits agree within the stated
tolerances.

multiple_of=128 keeps every projection quantizable (with 32 the FFN hidden
is 704 and w2 stays dense), and the buffer length is kept a multiple of 128
so the JAX side runs its fused decode kernel rather than its XLA branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.config import LLaMAArgs as JArgs
from accessory_tpu.engine.generate import Generator as JGenerator
from accessory_tpu.models import llama as jllama
from accessory_tpu.quant import qtensor as jq
from accessory_tpu.quant.quantize import quantize_params as jquantize_params
from accessory_tpu.tokenizer import Tokenizer as JTokenizer

from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.convert import params_from_jax
from accessory_tpu_torch.engine.generate import Generator
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.quant.fuse import fuse_for_decode
from accessory_tpu_torch.quant.quantize import quantize_params
from accessory_tpu_torch.tokenizer import Tokenizer

CORPUS = [
    "Hi my darling how are you today",
    "the quick brown fox jumps over the lazy dog",
    "hello world this is a test of the engine",
] * 30
MAX_GEN = 70  # prompts of <= 20 tokens: buffer length 128


def to_numpy_tree(node):
    if isinstance(node, jq.QuantizedWeight):
        return {"packed": np.asarray(node.packed), "scales": np.asarray(node.scales),
                "zeros": np.asarray(node.zeros), "bits": node.bits,
                "group_size": node.group_size, "in_dim": node.in_dim,
                "out_dim": node.out_dim, "layout": node.layout, "tile_k": node.tile_k}
    if isinstance(node, dict):
        return {k: to_numpy_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [to_numpy_tree(v) for v in node]
    return np.asarray(node)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread while a module's tests run (autouse here and
    in each test module that imports it). The suite runs as several xdist
    workers on one host, and each worker's torch would start one OpenMP
    thread a core: the workers' threads then spin against each other, and
    these modules' tests took ~20x their serial time. The count is restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tok_path(tmp_path_factory):
    from tokenizers import Tokenizer as HFTok
    from tokenizers import decoders, models, pre_tokenizers, trainers

    tk = HFTok(models.BPE(unk_token=None))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    tk.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=300, special_tokens=["<s>", "</s>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tk.train_from_iterator(CORPUS, trainer)
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    tk.save(str(path))
    return str(path)


def _build(tok_path, dtype):
    jtok = JTokenizer(tok_path)
    cfg = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, multiple_of=128,
               vocab_size=jtok.n_words, max_seq_len=192, dtype=dtype)
    jargs = JArgs(**cfg)
    qparams = jquantize_params(jllama.init_params(jax.random.PRNGKey(0), jargs), layout="planes")
    jgen = JGenerator(jllama, jargs, qparams, jtok, unroll_decode=True, kv_dtype="fp")
    targs = LLaMAArgs(**cfg)
    tgen = Generator(llama, targs, params_from_jax(to_numpy_tree(qparams), targs, device="cpu"),
                     Tokenizer(tok_path), device="cpu")
    return jgen, tgen


@pytest.fixture(scope="module")
def f32_pair(tok_path):
    return _build(tok_path, "float32")


def test_greedy_text_identical(f32_pair):
    jgen, tgen = f32_pair
    prompts = ["the quick brown", "hello world"]
    want = jgen.generate(prompts, max_gen_len=MAX_GEN)
    got = tgen.generate(prompts, max_gen_len=MAX_GEN)
    assert got == want
    assert all(len(t) > 0 for t in got)


def test_ragged_prompts_identical(f32_pair):
    """Prompts of different lengths exercise the prompt-mask overwrite and
    the per-row max_gen_len slicing."""
    jgen, tgen = f32_pair
    prompts = ["the quick brown fox jumps over the lazy", "hi", "hello world this"]
    assert tgen.generate(prompts, max_gen_len=MAX_GEN) == jgen.generate(
        prompts, max_gen_len=MAX_GEN)


def test_stop_symbol_truncation_identical(f32_pair):
    jgen, tgen = f32_pair
    base = tgen.generate(["the quick"], max_gen_len=MAX_GEN)[0]
    # a stop symbol whose tokens occur in the generated ids (a random
    # model's text re-tokenizes differently, so try the words in order)
    for stop in base.split()[:8]:
        got = tgen.generate(["the quick"], max_gen_len=MAX_GEN, additional_stop_symbols=(stop,))
        if len(got[0]) < len(base):
            break
    else:
        pytest.fail(f"no word of {base!r} stops the port's generation")
    want = jgen.generate(["the quick"], max_gen_len=MAX_GEN, additional_stop_symbols=(stop,))
    assert got == want


def _logits_pair(jgen, tgen, steps=4):
    """Prefill (cur_pos 0) then teacher-forced decode steps through both
    forwards on the fused per-layer params the Generators hold."""
    rng = np.random.RandomState(0)
    b, plen, s_len = 2, 64, 128
    toks = rng.randint(0, jgen.args.vocab_size, size=(b, plen + steps))
    jcache = jllama.init_kv_cache(jgen.args, b, max_len=s_len, stacked=False, kv_dtype="fp")
    tcache = llama.init_kv_cache(tgen.args, b, s_len, device="cpu")
    jl, jcache = jllama.forward(jgen.params, jgen.args, jnp.asarray(toks[:, :plen]),
                                cache=jcache, cur_pos=0)
    tl, _ = llama.forward(tgen.params, tgen.args, torch.from_numpy(toks[:, :plen]),
                          cache=tcache, cur_pos=0)
    pairs = [(np.asarray(jl), tl.numpy())]
    for i in range(steps):
        p = plen + i
        jl, jcache = jllama.forward(jgen.params, jgen.args, jnp.asarray(toks[:, p:p + 1]),
                                    cache=jcache, cur_pos=p)
        tl, _ = llama.forward(tgen.params, tgen.args, torch.from_numpy(toks[:, p:p + 1]),
                              cache=tcache, cur_pos=p)
        pairs.append((np.asarray(jl), tl.numpy()))
    return pairs


def test_logits_f32(f32_pair):
    """f32: each op agrees to ~1e-5 relative; logits to 1e-3 absolute."""
    for want, got in _logits_pair(*f32_pair):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def test_logits_bf16(tok_path):
    """bf16: the two packages round to bf16 at different points (the JAX
    planes kernel rounds q*s to bf16 before its dot; the port keeps q exact
    and applies the scale in f32), each rounding 2^-8 relative and carried
    through two layers, so logits are held to 3% in relative L2 and 0.1
    absolute."""
    for want, got in _logits_pair(*_build(tok_path, "bfloat16"), steps=2):
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 3e-2, rel
        np.testing.assert_allclose(got, want, atol=0.1, rtol=0)


def test_forward_takes_fused_params_only():
    """forward takes layers with fused wqkv / w13 weights or with the separate
    projections (the stacked-cache path's form), and gives the same f32 logits
    over both (1e-4: the same sums split at other points); a layer that has
    neither raises and names fuse_for_decode."""
    args = LLaMAArgs(dim=256, n_layers=1, n_heads=4, n_kv_heads=2, multiple_of=128,
                     vocab_size=64, max_seq_len=64, dtype="float32")
    params = quantize_params(llama.init_params(args, seed=0, device="cpu"))
    toks = torch.zeros((1, 4), dtype=torch.int64)
    broken = dict(params, layers=[dict(params["layers"][0], attention={
        k: v for k, v in params["layers"][0]["attention"].items() if k != "wk"})])
    with pytest.raises(ValueError, match="fuse_for_decode"):
        llama.forward(broken, args, toks, cache=llama.init_kv_cache(args, 1, device="cpu"))
    logits, _ = llama.forward(fuse_for_decode(params), args, toks,
                              cache=llama.init_kv_cache(args, 1, device="cpu"))
    assert logits.shape == (1, 4, 64) and torch.isfinite(logits).all()
    unfused, _ = llama.forward(params, args, toks,
                               cache=llama.init_kv_cache(args, 1, device="cpu"))
    np.testing.assert_allclose(unfused.numpy(), logits.numpy(), atol=1e-4, rtol=1e-4)
