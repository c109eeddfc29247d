"""Port parity, Mixtral served: ``mixtral.forward_paged`` against the JAX
package's over float and int8 pools (a fresh prefill, ragged one-token
decode, a 5-token and a 20-token continuation chunk) and chunked against
one-shot prefill; the port's Generator (no fused projections for a module
without ``SUPPORTS_FUSED_QKV``) and ContinuousBatcher against the JAX
package's Generator and batcher, identical greedy text; and a quantized
Mixtral checkpoint written by the JAX package, loaded by the port and
written again, read back by the JAX package bit for bit. Small f32 models;
the JAX paged kernels in interpret mode over int8 pools (see
test_torch_paged_model.py for why head_dim 128 there). CPU only;
tolerances at each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.checkpoint import load_checkpoint as jload_checkpoint
from accessory_tpu.config import MixtralArgs as JArgs
from accessory_tpu.engine.generate import Generator as JGenerator
from accessory_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from accessory_tpu.meta import MetaModel as JMetaModel
from accessory_tpu.models import llama as jllama
from accessory_tpu.models import mixtral as jmixtral
from accessory_tpu.quant import qtensor as jq
from accessory_tpu.quant.quantize import quantize_params as jquantize_params
from accessory_tpu.tokenizer import Tokenizer as JTokenizer

from accessory_tpu_torch.config import LLaMAArgs, MixtralArgs
from accessory_tpu_torch.convert import params_from_jax
from accessory_tpu_torch.engine.generate import Generator
from accessory_tpu_torch.engine.scheduler import ContinuousBatcher
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.models import llama, mixtral
from accessory_tpu_torch.quant import qtensor
from accessory_tpu_torch.tokenizer import Tokenizer

from test_torch_generate import one_torch_thread, to_numpy_tree, tok_path  # noqa: F401
from test_torch_paged_model import PAGE, SLOTS, TOTAL, _check_written8, _pools_to_jax, _steps

PAGED = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=256, num_experts=4,
             vocab_size=97, max_seq_len=128, dtype="float32")
PAGED128 = dict(PAGED, n_heads=2, n_kv_heads=1)     # head_dim 128: unfolded JAX pools
# the Mixtral entry of tests/test_zoo_generate.py
ZOO = {"dim": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "hidden_dim": 96,
       "num_experts": 4, "dtype": "float32"}
PROMPTS = ["the quick brown fox jumps over the lazy", "hi", "hello world this"]


def _paged_models(cfg):
    jargs, targs = JArgs(**cfg), MixtralArgs(**cfg)
    jparams = jmixtral.init_params(jax.random.PRNGKey(4), jargs)
    return jargs, jparams, targs, params_from_jax(to_numpy_tree(jparams), targs, device="cpu")


@pytest.mark.parametrize("kv_dtype,kernel_mode", [(None, "0"), ("int8", "interpret")])
def test_forward_paged_matches_jax(monkeypatch, kv_dtype, kernel_mode):
    """Every step's f32 logits within 1e-4 of the JAX package's and the
    lengths alike; over int8 pools the written values held as in
    test_torch_paged_model (the JAX side then continues from the port's
    pools, so each step compares the two forwards on the same pools)."""
    monkeypatch.setenv("ACCESSORY_PAGED_KERNEL", kernel_mode)
    jargs, jparams, targs, tparams = _paged_models(PAGED128 if kv_dtype else PAGED)
    toks = np.random.RandomState(0).randint(0, 97, size=(SLOTS, 41))
    jpc = jmixtral.init_paged_cache(jargs, slots=SLOTS, total_pages=TOTAL, page_size=PAGE,
                                    kv_dtype=kv_dtype or "fp")
    tpc = mixtral.init_paged_cache(targs, slots=SLOTS, total_pages=TOTAL, page_size=PAGE,
                                   kv_dtype=kv_dtype, device="cpu")
    for lo, hi, mode, lengths in _steps():
        if lengths is not None:
            jpc = dataclasses.replace(jpc, lengths=jnp.asarray(lengths, jnp.int32))
            tpc = dataclasses.replace(tpc, lengths=torch.tensor(lengths, dtype=torch.int32))
        kw = dict(continuation=mode == "continuation",
                  active_pages=None if mode == "prefill" else 4)
        jl, jpc = jmixtral.forward_paged(jparams, jargs, jnp.asarray(toks[:, lo:hi]), jpc, **kw)
        tl, tpc = mixtral.forward_paged(tparams, targs, torch.from_numpy(toks[:, lo:hi]), tpc,
                                        **kw)
        np.testing.assert_array_equal(tpc.lengths.numpy(), np.asarray(jpc.lengths))
        if kv_dtype == "int8":
            _check_written8(jpc, tpc)
            jpc = _pools_to_jax(tpc, jpc)
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)


def test_chunked_prefill_equals_one_shot():
    """Two continuation chunks give the one-shot prefill's last logits and
    lengths, and the static cache's forward gives the paged decode step's
    logits: f32 to 1e-4. (Over int8 pools a chunk attends over the earlier
    chunk's quantized k/v where a one-shot prefill sees the exact ones; the
    int8 continuation is held against the JAX package above.)"""
    _, _, targs, tparams = _paged_models(PAGED)
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, 97, size=(2, 17)))
    one = mixtral.init_paged_cache(targs, slots=2, total_pages=TOTAL, page_size=PAGE,
                                   device="cpu")
    want, one = mixtral.forward_paged(tparams, targs, toks[:, :16], one)
    two = mixtral.init_paged_cache(targs, slots=2, total_pages=TOTAL, page_size=PAGE,
                                   device="cpu")
    for c in range(2):
        got, two = mixtral.forward_paged(tparams, targs, toks[:, c * 8:(c + 1) * 8], two,
                                         continuation=True)
    np.testing.assert_allclose(got.numpy(), want[:, 8:].numpy(), rtol=0, atol=1e-4)
    assert torch.equal(one.lengths, two.lengths) and one.lengths.tolist() == [16, 16]
    cache = mixtral.init_kv_cache(targs, 2, 128, device="cpu")
    mixtral.forward(tparams, targs, toks[:, :16], cache=cache)
    static, _ = mixtral.forward(tparams, targs, toks[:, 16:17], cache=cache, cur_pos=16)
    paged, _ = mixtral.forward_paged(tparams, targs, toks[:, 16:17], one)
    np.testing.assert_allclose(paged.numpy(), static.numpy(), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def zoo(tok_path):  # noqa: F811
    """The JAX MetaModel of test_zoo_generate's Mixtral entry, and the port's
    MetaModel on the CPU with its weights."""
    jm = JMetaModel("mixtral", ZOO, tokenizer_path=tok_path, max_seq_len=128)
    tm = MetaModel("mixtral", ZOO, tokenizer_path=tok_path, max_seq_len=128, init_params=False,
                   device="cpu")
    tm.params = params_from_jax(to_numpy_tree(jm.params), tm.args, device="cpu")
    return jm, tm


def _jax_picks(jm, buf, plens, unroll, kv_dtype):
    """The JAX model teacher-forced on a Generator's token buffer (a prefill
    of the first 64 tokens, then one token a step from the shortest
    prompt's end, on the Generator's cache path): {(row, position): (JAX
    argmax, its top-2 margin)} for the positions the Generator sampled."""
    params = jllama.unstack_layers(jm.params) if unroll else jm.params
    b, n = buf.shape
    cache = jmixtral.init_kv_cache(jm.args, b, n, None, not unroll, kv_dtype)
    start = min(plens)
    fwd = jax.jit(lambda p, t, c, pos: jmixtral.forward(p, jm.args, t, cache=c, cur_pos=pos))
    logits, cache = fwd(params, jnp.asarray(buf[:, :64]), cache, 0)
    last, out = np.asarray(logits)[:, start - 1], {}
    for cur in range(start, n):
        top2 = np.sort(last, axis=-1)[:, ::-1]
        for row in range(b):
            if cur >= plens[row]:
                out[row, cur] = (int(last[row].argmax()), float(top2[row, 0] - top2[row, 1]))
        logits, cache = fwd(params, jnp.asarray(buf[:, cur:cur + 1]), cache, cur)
        last = np.asarray(logits)[:, 0]
    return out


@pytest.mark.parametrize("unroll", [True, False])
def test_generator_greedy_text_identical(zoo, tok_path, unroll):  # noqa: F811
    """The port's Generator against the JAX Generator on the same path, over
    per-layer pools with the fused decode write (``unroll_decode``) or over a
    stacked cache: identical greedy text with the float cache. The port
    keeps Mixtral's separate projections (no wqkv / w13)."""
    jm, tm = zoo
    jgen = JGenerator(jmixtral, jm.args, jm.params, JTokenizer(tok_path), kv_dtype="fp",
                      unroll_decode=unroll)
    tgen = Generator(mixtral, tm.args, tm.params, Tokenizer(tok_path), kv_dtype="fp",
                     device="cpu", unroll_decode=unroll)
    assert tgen.params is tm.params
    assert {"wq", "wk", "wv"} <= set(tgen.params["layers"][0]["attention"])
    want = jgen.generate(PROMPTS, max_gen_len=24)
    got = tgen.generate(PROMPTS, max_gen_len=24)
    assert got == want and any(len(t) > 0 for t in got)


@pytest.mark.parametrize("unroll", [True, False])
def test_generator_int8_cache_follows_jax(zoo, tok_path, unroll):  # noqa: F811
    """The port's Generator over the int8 cache, each greedy token held
    against the JAX model teacher-forced on the port's own tokens over its
    int8 cache on the same path: the same token wherever the JAX top-2
    margin exceeds 2e-2, twice the int8 logit tolerance of
    test_torch_mixtral (the reference's jitted quantizer multiplies by
    1/127 where the port divides, ROADMAP "Deliberate differences", so a
    value may land one int8 step apart and move a logit by ~1e-2; text may
    then part at a nearer tie)."""
    jm, tm = zoo
    tgen = Generator(mixtral, tm.args, tm.params, Tokenizer(tok_path), kv_dtype="int8",
                     device="cpu", unroll_decode=unroll)
    tgen.generate(PROMPTS, max_gen_len=24)
    buf = tgen.last_tokens
    plens = [len(tgen.tokenizer.encode(p, bos=True, eos=False)) for p in PROMPTS]
    picks = _jax_picks(jm, buf, plens, unroll, "int8")
    eos = tgen.tokenizer.eos_id
    checked = 0
    for row, plen in enumerate(plens):
        for cur in range(plen, min(plen + 24, buf.shape[1])):
            pick, margin = picks[row, cur]
            if margin > 2e-2:
                assert buf[row, cur] == pick, (row, cur, margin)
                checked += 1
            if buf[row, cur] == eos:
                break
    assert checked >= 30


def test_meta_model_generate_and_batcher(zoo):
    """MetaModel.generate and the ContinuousBatcher over forward_paged give
    the JAX MetaModel's and the JAX batcher's greedy text; the port's
    allocator is balanced after the run."""
    jm, tm = zoo
    want = jm.generate(PROMPTS, max_gen_len=12)
    assert tm.generate(PROMPTS, max_gen_len=12) == want
    kw = dict(slots=2, page_size=32)
    jb = JBatcher(jm.module, jm.args, jm.params, jm.tokenizer, **kw)
    tb = ContinuousBatcher(tm.module, tm.args, tm.params, tm.tokenizer, device="cpu", **kw)
    assert tb.params is tm.params
    got = tb.run(PROMPTS, max_gen_len=12)
    assert got == jb.run(PROMPTS, max_gen_len=12) and all(got)
    assert tb.pool.free_pages == tb.total_pages - 1


def test_generator_fuses_only_where_the_module_supports_it(zoo):
    """Generator(unroll_decode=True) fuses wq / wk / wv and w1 / w3 for LLaMA
    (SUPPORTS_FUSED_QKV) and leaves a Mixtral tree as it is."""
    _, tm = zoo
    gen = Generator(mixtral, tm.args, tm.params, tm.tokenizer, device="cpu")
    assert gen.params is tm.params and not getattr(mixtral, "SUPPORTS_FUSED_QKV", False)
    largs = LLaMAArgs(dim=64, n_layers=1, n_heads=4, vocab_size=32, multiple_of=32,
                            dtype="float32")
    lgen = Generator(llama, largs, llama.init_params(largs, device="cpu"), tm.tokenizer,
                     device="cpu")
    assert "wqkv" in lgen.params["layers"][0]["attention"]
    assert "w13" in lgen.params["layers"][0]["feed_forward"]
    with pytest.raises(ValueError, match="ffn_fuse"):
        Generator(mixtral, tm.args, tm.params, tm.tokenizer, device="cpu",
                  ffn_fuse=True).generate(["hi"], max_gen_len=2)


def _leaves(node, prefix=""):
    if isinstance(node, jq.QuantizedWeight):
        yield prefix, node
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(node)


def test_jax_checkpoint_round_trip(tmp_path, tok_path):  # noqa: F811
    """A W4 (planes) Mixtral saved by the JAX package's save_pretrained loads
    through the port's from_pretrained (each expert leaf a tuple of per-expert
    folded weights, the router f32, f32 logits within 1e-4 of the JAX
    package's), is saved again by the port, and the JAX package reads every
    leaf of that back bit for bit: packed words, scales, zeros, the stacked
    (L, E, ...) expert leaves and the dense ones."""
    cfg = dict(PAGED, vocab_size=JTokenizer(tok_path).n_words)
    jm = JMetaModel("mixtral", cfg, tokenizer_path=tok_path, max_seq_len=128)
    jm.params = jquantize_params(jm.params, layout="planes")
    jm.save_pretrained(str(tmp_path / "jax"))
    tm = MetaModel.from_pretrained(str(tmp_path / "jax"), max_seq_len=128, dtype="float32",
                                   device="cpu")
    assert tm.llama_type == "mixtral" and tm.args.num_experts == 4
    ff = tm.params["layers"][1]["feed_forward"]
    assert isinstance(ff["w2"]["weight"], tuple) and len(ff["w2"]["weight"]) == 4
    assert all(isinstance(w, qtensor.QuantizedWeight) and w.layout == "folded"
               for w in ff["w2"]["weight"])
    assert ff["gate"]["weight"].dtype == torch.float32
    toks = np.random.RandomState(5).randint(0, cfg["vocab_size"], size=(2, 12))
    want, _ = jmixtral.forward(jm.params, jm.args, jnp.asarray(toks))
    got, _ = mixtral.forward(tm.params, tm.args, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    tm.save_pretrained(str(tmp_path / "port"))
    back = dict(_leaves(jload_checkpoint(str(tmp_path / "port"))))
    orig = dict(_leaves(jm.params))
    assert set(back) == set(orig) and len(orig) > 10
    for path, w in orig.items():
        g = back[path]
        if isinstance(w, jq.QuantizedWeight):
            assert (g.layout, g.tile_k, g.in_dim, g.out_dim, g.bits, g.group_size) == \
                (w.layout, w.tile_k, w.in_dim, w.out_dim, w.bits, w.group_size), path
            for f in ("packed", "scales", "zeros"):
                a, b = np.asarray(getattr(g, f)), np.asarray(getattr(w, f))
                assert a.dtype == b.dtype and np.array_equal(a, b), (path, f)
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), path
    assert orig["/layers/feed_forward/w1/weight"].packed.ndim == 4
