"""Port parity, InternLM and Falcon served: the port's Generator against the
JAX package's Generator on the same W4 params (identical greedy text over
per-layer pools with the fused decode write, and over a stacked cache); a
W4 checkpoint of each family written by the JAX package's save_pretrained,
loaded by the port's from_pretrained (every leaf as ``params_from_jax``
gives it, greedy text equal to the JAX MetaModel's); the embedding table
kept dense (ROADMAP C8: the JAX default blocklist quantizes it and the JAX
forward then raises, the port's keeps it and serves); the continuous
batcher's refusal of a model without a paged forward; the missing-leaf
check naming each family's own top-level keys. Small f32 models (hidden
256, head_dim 64, 2 layers); CPU only.
"""

import jax.numpy as jnp
import pytest
import torch

from accessory_tpu.engine.generate import Generator as JGenerator
from accessory_tpu.meta import MetaModel as JMetaModel
from accessory_tpu.quant import qtensor as jq
from accessory_tpu.quant.quantize import DEFAULT_BLOCKLIST as JBLOCK
from accessory_tpu.quant.quantize import quantize_params as jquantize_params
from accessory_tpu.tokenizer import Tokenizer as JTokenizer

from accessory_tpu_torch.checkpoint import save_checkpoint
from accessory_tpu_torch.convert import params_from_jax
from accessory_tpu_torch.engine.generate import Generator
from accessory_tpu_torch.engine.scheduler import ContinuousBatcher
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.models import falcon, internlm
from accessory_tpu_torch.quant.qtensor import QuantizedWeight
from accessory_tpu_torch.tokenizer import Tokenizer

from test_torch_generate import one_torch_thread, to_numpy_tree, tok_path  # noqa: F401

CFGS = {"internlm": dict(num_layers=2, hidden_size=256, num_attention_heads=4, multiple_of=256,
                         dtype="float32"),
        "falcon": dict(num_layers=2, hidden_size=256, num_attention_heads=4, num_kv_heads=2,
                       bias=True, dtype="float32")}
MODULES = {"internlm": internlm, "falcon": falcon}
JAX_BLOCKLIST = tuple(JBLOCK) + ("word_embeddings",)
PROMPTS = ["the quick brown fox jumps over the lazy", "hi", "hello world this"]


def _same_tree(a, b):
    """Every tensor of two port params trees equal; returns the leaf count."""
    if isinstance(a, QuantizedWeight):
        assert isinstance(b, QuantizedWeight) and (a.layout, a.in_dim) == (b.layout, b.in_dim)
        return sum(_same_tree(getattr(a, f), getattr(b, f)) for f in ("packed", "scales", "zeros"))
    if isinstance(a, dict):
        assert set(a) == set(b)
        return sum(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        return sum(_same_tree(x, y) for x, y in zip(a, b))
    assert a.dtype == b.dtype and torch.equal(a, b)
    return 1


@pytest.fixture(scope="module")
def zoo(tok_path):  # noqa: F811
    """Each family's JAX MetaModel (W4 planes, the embeddings dense) and the
    port's copy of its params."""
    out = {}
    for family, cfg in CFGS.items():
        jm = JMetaModel(family, cfg, tokenizer_path=tok_path, max_seq_len=128)
        jm.params = jquantize_params(jm.params, layout="planes", blocklist=JAX_BLOCKLIST)
        tm = MetaModel(family, cfg, tokenizer_path=tok_path, max_seq_len=128,
                       init_params=False, device="cpu")
        tm.params = params_from_jax(to_numpy_tree(jm.params), tm.args, device="cpu")
        # the Generator jm.generate builds on the CPU (the stacked route, the
        # float cache), made once: its compiled loop serves the stacked case
        # of the greedy-text test and the checkpoint test alike
        jm._generator = JGenerator(jm.module, jm.args, jm.params, JTokenizer(tok_path),
                                   kv_dtype="fp", unroll_decode=False)
        out[family] = (jm, tm)
    return out


@pytest.mark.parametrize("unroll", [True, False])
@pytest.mark.parametrize("family", list(CFGS))
def test_generator_greedy_text_identical(zoo, tok_path, family, unroll):  # noqa: F811
    """The port's Generator against the JAX Generator on the same route,
    over per-layer pools with the fused decode write (``unroll_decode``) or
    over a stacked cache: identical greedy text with the float cache. The
    port keeps the family's own projections (nothing fused)."""
    jm, tm = zoo[family]
    module = MODULES[family]
    jgen = JGenerator(jm.module, jm.args, jm.params, JTokenizer(tok_path), kv_dtype="fp",
                      unroll_decode=True) if unroll else jm.generator
    tgen = Generator(module, tm.args, tm.params, Tokenizer(tok_path), kv_dtype="fp",
                     device="cpu", unroll_decode=unroll)
    assert tgen.params is tm.params
    want = jgen.generate(PROMPTS, max_gen_len=24)
    got = tgen.generate(PROMPTS, max_gen_len=24)
    assert got == want and any(got)


@pytest.mark.parametrize("family", list(CFGS))
def test_jax_checkpoint_through_from_pretrained(zoo, tmp_path, family):
    """A W4 checkpoint written by the JAX package's save_pretrained loads
    through the port's from_pretrained (meta.json names the family, the
    missing-leaf check reads its top-level keys): every leaf as
    ``params_from_jax`` gives it, and MetaModel.generate's greedy text equal
    to the JAX MetaModel's."""
    jm, tm = zoo[family]
    jm.save_pretrained(str(tmp_path))
    loaded = MetaModel.from_pretrained(str(tmp_path), max_seq_len=128, dtype="float32",
                                       device="cpu")
    assert loaded.llama_type == family and loaded.module is MODULES[family]
    assert _same_tree(loaded.params, tm.params) > 20
    assert loaded.generate(PROMPTS, max_gen_len=16) == jm.generate(PROMPTS, max_gen_len=16)


@pytest.mark.parametrize("family", list(CFGS))
def test_c8_embedding_table_stays_dense(family):
    """ROADMAP C8, both ways, at vocab 256 (a multiple of the group size):
    the JAX package's default blocklist quantizes ``word_embeddings`` and
    its forward then raises on the table lookup; the port's quantize keeps
    the table dense and its forward serves."""
    cfg = dict(CFGS[family], vocab_size=256)
    jm = JMetaModel(family, cfg, max_seq_len=64)
    jm.quantize()
    assert isinstance(jm.params["word_embeddings"]["weight"], jq.QuantizedWeight)
    with pytest.raises(TypeError, match="QuantizedWeight"):
        jm.module.forward(jm.params, jm.args, jnp.ones((1, 4), jnp.int32))
    tm = MetaModel(family, cfg, max_seq_len=64, device="cpu").quantize()
    emb = tm.params["word_embeddings"]["weight"]
    assert isinstance(emb, torch.Tensor) and emb.shape == (256, 256)
    assert isinstance(tm.params["layers"][0]["mlp"][
        "w1" if family == "internlm" else "dense_h_to_4h"]["weight"], QuantizedWeight)
    logits, _ = tm.module.forward(tm.params, tm.args, torch.ones((1, 4), dtype=torch.int64))
    assert logits.shape == (1, 4, 256) and torch.isfinite(logits).all()


@pytest.mark.parametrize("family", list(CFGS))
def test_batcher_and_partial_checkpoint_refused(zoo, tmp_path, family):
    """The continuous batcher serves the paged cache of LLaMA and Mixtral
    only: a family without ``forward_paged`` is refused at construction,
    before any pool is made. A native checkpoint without the family's final
    norm (``norm`` / ``ln_f``) is refused by from_pretrained, naming it."""
    _, tm = zoo[family]
    with pytest.raises(TypeError, match="forward_paged"):
        ContinuousBatcher(tm.module, tm.args, tm.params, tm.tokenizer, slots=2, device="cpu")
    final = "norm" if family == "internlm" else "ln_f"
    save_checkpoint(str(tmp_path), {k: v for k, v in tm.params.items() if k != final})
    with pytest.raises(KeyError, match=final):
        MetaModel.from_pretrained(str(tmp_path), llama_type=family, llama_config=[CFGS[family]],
                                  tokenizer=tm.tokenizer, device="cpu")
