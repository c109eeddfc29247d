"""Port parity, LLaMA-Adapter (``models/llama_adapter.py``) against the JAX
package's ``accessory_tpu/models/llama_adapter.py`` on the same weights and
tokens: the cache-free forward with zero gates (the LLaMA base, bit for
bit in the port) and with open gates on the last ``prefix_layers`` of 4
layers; the stacked-cache prefill and decode against the JAX forward and
the port's cache-free one; the visual prefix (``encode_visual_prefix`` and
``forward(images=)``); the trainable filter; ``init_kv_cache`` keeping the
activation dtype under ``kv_dtype="int8"``; a W4 forward (the JAX package's
planes weights); greedy ``MetaModel.generate`` text (the Generator's stacked
route, as the JAX Generator takes for a module without
``SUPPORTS_UNROLLED_DECODE``); ``compute_logits(images=)``; checkpoints both
ways; and ROADMAP C12 (``_clip_cfg``'s ViT at the default widths).

A 4-layer f32 decoder of width 64 (4 query / 2 KV heads), prefix_len 4 on
the last 2 layers; the visual branch 32 wide, 2 projector blocks, its ViT at
patch 56. JAX's params are drawn by its ``init_params``, perturbed with
seeded numpy noise, the gates drawn normal (open) or zero, and carried
across with ``params_from_jax``. f32 on both sides, summation order apart: logits to
2e-4 (the JAX package's own tolerance for its cached adapter forward),
greedy text exactly. W4 at width 256 to 2e-4 (the same planes weights).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.checkpoint.native import load_checkpoint as jload_checkpoint
from accessory_tpu.config import AdapterArgs as JArgs
from accessory_tpu.engine.generate import Generator as JGenerator
from accessory_tpu.meta import MetaModel as JMetaModel
from accessory_tpu.models import llama_adapter as jadapter
from accessory_tpu.quant.quantize import quantize_params as jquantize_params

from accessory_tpu_torch.checkpoint import read_safetensors
from accessory_tpu_torch.config import AdapterArgs, LLaMAArgs
from accessory_tpu_torch.convert import params_from_jax, params_to_jax
from accessory_tpu_torch.engine.generate import Generator
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.models import get_model_module, llama, llama_adapter

from test_torch_generate import one_torch_thread, to_numpy_tree, tok_path  # noqa: F401
from test_torch_visual import perturbed, to_jax

TINY = dict(dim=64, n_layers=4, n_heads=4, n_kv_heads=2, vocab_size=96, multiple_of=32,
            max_seq_len=128, dtype="float32", prefix_layers=2, prefix_len=4,
            v_embed_dim=32, v_depth=2, v_num_heads=2)
W4 = dict(TINY, dim=256, n_layers=2, prefix_layers=1)
TOL = dict(rtol=2e-4, atol=2e-4)
CACHE_LEN = 128


def _pair(cfg, seed=0, gates=True, with_visual=True, quant=False):
    """(JAX args, JAX params, port args, port params) on the same weights."""
    jargs, targs = JArgs(**cfg), AdapterArgs(**cfg)
    jp = jadapter.init_params(jax.random.PRNGKey(seed), jargs, with_visual=with_visual)
    np_tree = perturbed(to_numpy_tree(jp), seed=seed + 1, scale=0.02)
    gate = np_tree["adapter"]["gate"]
    np_tree["adapter"]["gate"] = (np.random.RandomState(seed + 2).randn(*gate.shape)
                                  .astype(np.float32) if gates else np.zeros_like(gate))
    jp = to_jax(np_tree)
    if quant:
        jp = jquantize_params(jp, layout="planes")
    return jargs, jp, targs, params_from_jax(to_numpy_tree(jp), targs, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair(TINY)


def _tokens(seed, shape, vocab=TINY["vocab_size"]):
    return np.random.RandomState(seed).randint(0, vocab, size=shape)


def _images(b, seed=3):
    return np.random.RandomState(seed).randn(b, 3, 224, 224).astype(np.float32)


def test_registry_args_and_flags():
    """llama_adapter resolves in both packages to the adapter module; the
    args' fields and defaults are the JAX package's; neither module sets
    SUPPORTS_UNROLLED_DECODE or SUPPORTS_KV_INT8."""
    assert get_model_module("llama_adapter") is llama_adapter
    assert [(f.name, f.default) for f in dataclasses.fields(AdapterArgs)] == \
        [(f.name, f.default) for f in dataclasses.fields(JArgs)]
    for name in ("SUPPORTS_UNROLLED_DECODE", "SUPPORTS_KV_INT8", "SUPPORTS_FUSED_QKV"):
        assert not getattr(llama_adapter, name, False)
        assert not getattr(jadapter, name, False)


@pytest.mark.parametrize("gates", ["zero", "open"])
def test_forward_without_cache(gates):
    """The cache-free forward against JAX's (2e-4). Zero gates: equal bit for
    bit to the port's LLaMA forward on the base params. Open gates on the
    last 2 of 4 layers: the prefix changes the logits."""
    jargs, jp, targs, tp = _pair(TINY, gates=gates == "open", with_visual=False)
    toks = _tokens(1, (2, 10))
    want, _ = jadapter.forward(jp, jargs, jnp.asarray(toks))
    got, cache = llama_adapter.forward(tp, targs, torch.from_numpy(toks))
    assert cache is None and got.shape == (2, 10, TINY["vocab_size"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    base = {k: v for k, v in tp.items() if k != "adapter"}
    plain, _ = llama.forward(base, LLaMAArgs(**{k: v for k, v in TINY.items()
                                                if k in LLaMAArgs.__dataclass_fields__}),
                             torch.from_numpy(toks))
    if gates == "zero":
        assert torch.equal(got, plain)
    else:
        assert (got - plain).abs().max() > 1e-3


def test_cached_decode(pair):
    """A 6-token prefill at position 0 and 4 decode steps over the stacked
    cache: each step's logits against the JAX cached forward and against
    the port's cache-free forward of the whole sequence (2e-4)."""
    jargs, jp, targs, tp = pair
    toks = _tokens(2, (2, 10))
    full, _ = llama_adapter.forward(tp, targs, torch.from_numpy(toks))
    jcache = jadapter.init_kv_cache(jargs, 2, max_len=CACHE_LEN)
    tcache = llama_adapter.init_kv_cache(targs, 2, CACHE_LEN, device="cpu")
    assert isinstance(tcache["k"], torch.Tensor) and tcache["k"].shape[0] == TINY["n_layers"]
    for lo, hi in [(0, 6)] + [(p, p + 1) for p in range(6, 10)]:
        want, jcache = jadapter.forward(jp, jargs, jnp.asarray(toks[:, lo:hi]), cache=jcache,
                                        cur_pos=lo)
        got, tcache = llama_adapter.forward(tp, targs, torch.from_numpy(toks[:, lo:hi]),
                                            cache=tcache, cur_pos=lo)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), full[:, lo:hi].numpy(), **TOL)


def test_visual_prefix(pair):
    """encode_visual_prefix (b, prefix_len, dim) against JAX's (1e-4), and
    forward(images=) with open gates against JAX's (2e-4); with zero gates
    the image cannot move the logits (the zero-init property)."""
    jargs, jp, targs, tp = pair
    x = _images(2)
    want = jadapter.encode_visual_prefix(jp, jargs, jnp.asarray(x))
    got = llama_adapter.encode_visual_prefix(tp, targs, torch.from_numpy(x))
    assert got.shape == (2, TINY["prefix_len"], TINY["dim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    toks = _tokens(4, (2, 8))
    want, _ = jadapter.forward(jp, jargs, jnp.asarray(toks), images=jnp.asarray(x))
    got, _ = llama_adapter.forward(tp, targs, torch.from_numpy(toks), images=torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    text, _ = llama_adapter.forward(tp, targs, torch.from_numpy(toks))
    assert (got - text).abs().max() > 1e-3
    closed = dict(tp, adapter=dict(tp["adapter"], gate=torch.zeros_like(tp["adapter"]["gate"])))
    a, _ = llama_adapter.forward(closed, targs, torch.from_numpy(toks), images=torch.from_numpy(x))
    b, _ = llama_adapter.forward(closed, targs, torch.from_numpy(toks))
    assert torch.equal(a, b)


def test_trainable_filter_and_cache_dtype():
    """Only adapter leaves train (the JAX filter's answers on the port's
    names); init_kv_cache is stacked and in the activation dtype whatever
    kv_dtype says (bf16 model: bf16 pools under "int8", no scale pools)."""
    targs, jargs = AdapterArgs(**TINY), JArgs(**TINY)
    names = [n for n, _ in _named(llama_adapter.init_params(targs, device="cpu",
                                                            with_visual=True))]
    assert "adapter/prefix" in names and "visual/query" in names
    f, jf = llama_adapter.get_trainable_params_filter(targs), \
        jadapter.get_trainable_params_filter(jargs)
    assert [f(n) for n in names] == [jf(n) for n in names]
    assert sorted(n for n in names if f(n)) == ["adapter/gate", "adapter/prefix"]
    bf16 = AdapterArgs(**dict(TINY, dtype="bfloat16"))
    cache = llama_adapter.init_kv_cache(bf16, 2, 32, kv_dtype="int8", device="cpu")
    jcache = jadapter.init_kv_cache(JArgs(**dict(TINY, dtype="bfloat16")), 2, max_len=32,
                                    kv_dtype="int8")
    assert sorted(cache) == sorted(jcache) == ["k", "v"]
    assert cache["k"].dtype == torch.bfloat16 and jcache["k"].dtype == jnp.bfloat16
    assert cache["k"].shape == (TINY["n_layers"], 2, 2, 32, 16)


def _named(tree, prefix=""):
    from accessory_tpu_torch.train.tree import named_leaves

    return named_leaves(tree, prefix)


def test_w4_forward():
    """W4 g128 (the JAX package's planes weights, the port's folded ones):
    the cache-free forward and a prefill + 2 decode steps against JAX (2e-4)."""
    jargs, jp, targs, tp = _pair(W4, seed=5, with_visual=False, quant=True)
    assert type(tp["layers"][0]["attention"]["wq"]["weight"]).__name__ == "QuantizedWeight"
    toks = _tokens(6, (2, 8), W4["vocab_size"])
    want, _ = jadapter.forward(jp, jargs, jnp.asarray(toks))
    got, _ = llama_adapter.forward(tp, targs, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jcache = jadapter.init_kv_cache(jargs, 2, max_len=CACHE_LEN)
    tcache = llama_adapter.init_kv_cache(targs, 2, CACHE_LEN, device="cpu")
    for lo, hi in ((0, 6), (6, 7), (7, 8)):
        want, jcache = jadapter.forward(jp, jargs, jnp.asarray(toks[:, lo:hi]), cache=jcache,
                                        cur_pos=lo)
        got, tcache = llama_adapter.forward(tp, targs, torch.from_numpy(toks[:, lo:hi]),
                                            cache=tcache, cur_pos=lo)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def metas(tok_path):  # noqa: F811
    """(port MetaModel, JAX MetaModel) of llama_adapter on the same params
    (open gates; the MetaModel's params carry no visual branch, as JAX's)."""
    cfg = {k: v for k, v in TINY.items() if k != "max_seq_len"}
    tm = MetaModel("llama_adapter", cfg, tokenizer_path=tok_path, max_seq_len=CACHE_LEN,
                   device="cpu")
    jm = JMetaModel("llama_adapter", cfg, tokenizer_path=tok_path, max_seq_len=CACHE_LEN,
                    init_params=False)
    tree = perturbed(params_to_jax(tm.params), seed=7, scale=0.02)
    tm.params = params_from_jax(tree, tm.args, device="cpu")
    jm.params = to_jax(tree)
    return tm, jm


def test_generate_matches_jax(metas):
    """MetaModel.generate: greedy text equal to the JAX MetaModel's (two
    prompts of different lengths, 8 new tokens), through the stacked route
    (the Generator keeps unroll_decode off for this module); images refused
    at the call, the model having no encode_image."""
    tm, jm = metas
    assert "visual" not in tm.params and tm.generator.unroll_decode is False
    prompts = ["the quick brown fox", "hello"]
    want = jm.generate(prompts, max_gen_len=8)
    got = tm.generate(prompts, max_gen_len=8)
    assert got == want and any(got)
    with pytest.raises(NotImplementedError, match="compute_logits"):
        tm.generate(prompts, images=_images(2), max_gen_len=2)


def test_compute_logits_with_images(pair, tok_path):  # noqa: F811
    """A Generator over params with the visual branch: compute_logits(images=)
    is the cache-free forward with the visual prefix, as the JAX Generator's
    (2e-4); without images the text forward."""
    jargs, jp, targs, tp = pair
    tok = MetaModel("llama", {"dim": 64, "n_layers": 1, "n_heads": 4}, tokenizer_path=tok_path,
                    init_params=False, device="cpu").tokenizer
    gen = Generator(llama_adapter, targs, tp, tok, device="cpu")
    jgen = JGenerator(jadapter, jargs, jp, tok)
    toks, x = _tokens(8, (2, 8)), _images(2, seed=9)
    np.testing.assert_allclose(gen.compute_logits(toks, images=x).numpy(),
                               np.asarray(jgen.compute_logits(jnp.asarray(toks), images=x)),
                               **TOL)
    np.testing.assert_allclose(gen.compute_logits(toks).numpy(),
                               np.asarray(jgen.compute_logits(jnp.asarray(toks))), **TOL)


def test_checkpoint_round_trip(pair, tmp_path):
    """params_to_jax / params_from_jax bit for bit (the adapter and the
    visual branch's stacked blocks as they are); a checkpoint the port
    writes reads back bit for bit in the port and in the JAX package."""
    jargs, jp, targs, tp = pair
    from accessory_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    want = dict(_named(tp))
    save_checkpoint(str(tmp_path), tp)
    assert "adapter/prefix" in read_safetensors(str(tmp_path / "weights.safetensors"))
    for back in (params_from_jax(params_to_jax(tp), targs, device="cpu"),
                 load_checkpoint(str(tmp_path), targs, device="cpu")):
        got = dict(_named(back))
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[n], want[n]) for n in want)
    jtree = jload_checkpoint(str(tmp_path))
    for key in ("prefix", "gate"):
        np.testing.assert_array_equal(np.asarray(jtree["adapter"][key]),
                                      tp["adapter"][key].numpy())
    np.testing.assert_array_equal(np.asarray(jtree["visual"]["blocks"]["qkv"]["weight"]),
                                  tp["visual"]["blocks"]["qkv"]["weight"].numpy())
    np.testing.assert_array_equal(np.asarray(jtree["layers"]["attention"]["wq"]["weight"][1]),
                                  tp["layers"][1]["attention"]["wq"]["weight"].numpy())


def test_c12_clip_cfg_at_the_default_widths():
    """ROADMAP C12 pinned: at AdapterArgs' defaults (v_embed_dim 768) both
    packages' _clip_cfg give a 2-layer, 768-wide ViT at patch 14 with 16
    heads, not the CLIP ViT-L/14 (24 layers, 1024 wide) its comment names;
    at v_embed_dim 1024 it is ViT-L/14's shape."""
    for mod, cls in ((llama_adapter, AdapterArgs), (jadapter, JArgs)):
        cfg = mod._clip_cfg(cls())
        assert (cfg.width, cfg.layers, cfg.patch_size, cfg.heads) == (768, 2, 14, 16)
        cfg = mod._clip_cfg(cls(v_embed_dim=1024))
        assert (cfg.width, cfg.layers, cfg.patch_size, cfg.heads) == (1024, 24, 14, 16)
