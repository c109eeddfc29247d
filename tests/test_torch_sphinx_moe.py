"""Port parity, SPHINX-MoE (``models/sphinx_moe.py``, the
mixtral_sparse_ens families) against the JAX package's
``accessory_tpu/models/sphinx_moe.py`` on the same weights: the registry,
args and per-type visual defaults; ``encode_image`` and the image word
counts of both types; the cache-free ``forward(images=)`` (with the
load-balancing loss); the multimodal prefill over a per-layer cache and
decode steps at positions shifted by the image words; the Generator's
greedy tokens with images against a greedy chain of the JAX forward; the
ContinuousBatcher on text against the JAX batcher; the quant blocklist and
the trainable filter; and checkpoints both ways with W4 experts.

Tiny towers (patch 56: 17 tokens a tower; CLIP 32, DINOv2 48 wide, ConvNeXt
(8, 16, 32, 64), Q-Former 32) over a 2-layer f32 Mixtral of width 64 (4
experts of width 96, top 2). The params are drawn by the port, moved off
their init values with seeded numpy noise and handed to the JAX package
through ``params_to_jax``. f32 on both sides, summation order apart: image
tokens to 1e-4, logits to 5e-4 (test_torch_sphinx's tolerances; the routing
agrees on every token here), greedy tokens and text exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.checkpoint.native import load_checkpoint as jload_checkpoint
from accessory_tpu.config import SphinxMoEArgs as JArgs
from accessory_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from accessory_tpu.meta import MetaModel as JMetaModel
from accessory_tpu.models import sphinx_moe as jsmoe

from accessory_tpu_torch.config import SphinxMoEArgs
from accessory_tpu_torch.convert import params_from_jax, params_to_jax
from accessory_tpu_torch.engine.scheduler import ContinuousBatcher
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.models import get_model_module, mixtral, sphinx_moe
from accessory_tpu_torch.quant.qtensor import QuantizedWeight
from accessory_tpu_torch.train.tree import named_leaves

from test_torch_generate import one_torch_thread, tok_path  # noqa: F401  (fixtures)
from test_torch_visual import perturbed, to_jax

TINY = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=96, num_experts=4,
            dtype="float32", vit_patch=56, clip_width=32, clip_layers=2, clip_heads=2,
            dino_width=48, dino_layers=2, dino_heads=2, convnext_depths=(1, 1, 1, 1),
            convnext_dims=(8, 16, 32, 64), qformer_width=32, qformer_layers=2,
            qformer_heads=2)
MAX_SEQ = 640
TOKEN_TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)
# llama_type -> (visual, image size, image words at the tiny widths)
TYPES = {"mixtral_sparse_ens": ("ens", 224, 51), "mixtral_sparse_ens5": ("ens5", 448, 5 * 51)}

_PAIRS = {}


def pair(tok, llama_type):
    """(port MetaModel, JAX MetaModel) of one type on the same params."""
    if llama_type not in _PAIRS:
        tm = MetaModel(llama_type, TINY, tokenizer_path=tok, max_seq_len=MAX_SEQ, seed=1,
                       device="cpu")
        tm.params = params_from_jax(perturbed(params_to_jax(tm.params), seed=2, scale=0.02),
                                    tm.args, device="cpu")
        jm = JMetaModel(llama_type, TINY, tokenizer_path=tok, max_seq_len=MAX_SEQ,
                        init_params=False)
        jm.params = to_jax(params_to_jax(tm.params))
        _PAIRS[llama_type] = (tm, jm)
    return _PAIRS[llama_type]


def images(b, size, seed=3):
    return np.random.RandomState(seed).randn(b, 3, size, size).astype(np.float32)


def test_registry_args_and_flags():
    """Both types resolve to the module in the port as in the JAX package;
    SphinxMoEArgs' fields and defaults are the JAX package's; the capability
    flags and the cache / paged functions are Mixtral's."""
    for t in TYPES:
        assert get_model_module(t) is sphinx_moe
    assert [(f.name, f.default) for f in dataclasses.fields(SphinxMoEArgs)] == \
        [(f.name, f.default) for f in dataclasses.fields(JArgs)]
    for name in ("SUPPORTS_UNROLLED_DECODE", "SUPPORTS_KV_INT8", "SUPPORTS_CHUNKED_PREFILL",
                 "SUPPORTS_FUSED_QKV"):
        assert getattr(sphinx_moe, name, False) == getattr(jsmoe, name, False), name
    assert sphinx_moe.forward_paged is mixtral.forward_paged
    assert sphinx_moe.init_kv_cache is mixtral.init_kv_cache


@pytest.mark.parametrize("llama_type", sorted(TYPES))
def test_encode_image_and_forward(tok_path, llama_type):  # noqa: F811
    """Each type's visual / image_size defaults, crop count and image_words
    as the JAX package's; the image tokens within 1e-4 of JAX's
    encode_image; the cache-free forward(images=) with the load-balancing
    loss: text-position logits within 5e-4, the aux loss within 1e-5."""
    tm, jm = pair(tok_path, llama_type)
    visual, size, words = TYPES[llama_type]
    assert (tm.args.visual, tm.args.image_size) == (jm.args.visual, jm.args.image_size) \
        == (visual, size)
    assert tm.with_visual and jm.with_visual
    assert sphinx_moe.image_words(tm.args) == jsmoe.image_words(jm.args) == words
    assert sphinx_moe.n_crops(tm.args) == jsmoe.n_crops(jm.args)
    x = images(2, size)
    want = np.asarray(jsmoe.encode_image(jm.params, jm.args, jnp.asarray(x)))
    got = sphinx_moe.encode_image(tm.params, tm.args, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, words, TINY["dim"])
    np.testing.assert_allclose(got, want, **TOKEN_TOL)
    toks = np.random.RandomState(4).randint(0, tm.args.vocab_size, (2, 8))
    want, _, jaux = jsmoe.forward(jm.params, jm.args, jnp.asarray(toks), images=jnp.asarray(x),
                                  with_aux_loss=True)
    got, cache, aux = sphinx_moe.forward(tm.params, tm.args, torch.from_numpy(toks),
                                         images=torch.from_numpy(x), with_aux_loss=True)
    assert cache is None and got.shape == (2, 8, tm.args.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_prefill_and_decode_with_images(tok_path):  # noqa: F811
    """mixtral_sparse_ens over per-layer pools: the prefill of [BOS, image
    words, text] from the splice's embeddings (s + image_words rows) and
    three decode steps at positions s + image_words + i, each against the
    JAX forward (5e-4); the prefill's text rows equal the cache-free
    forward's."""
    tm, jm = pair(tok_path, "mixtral_sparse_ens")
    n_img, b, s, steps = 51, 2, 8, 3
    toks = np.random.RandomState(5).randint(0, tm.args.vocab_size, (b, s + steps))
    x = images(b, 224, seed=6)
    max_len = s + n_img + steps
    jcache = jsmoe.init_kv_cache(jm.args, b, max_len=max_len)
    tcache = sphinx_moe.init_kv_cache(tm.args, b, max_len, device="cpu")
    jemb = jnp.take(jm.params["tok_embeddings"]["weight"], jnp.asarray(toks[:, :s]), axis=0)
    jemb = jnp.concatenate([jemb[:, :1], jsmoe.encode_image(jm.params, jm.args, jnp.asarray(x)),
                            jemb[:, 1:]], axis=1)
    want, jcache = jsmoe.forward(jm.params, jm.args, jnp.asarray(toks[:, :s]), cache=jcache,
                                 cur_pos=0, embeds=jemb)
    temb = sphinx_moe.splice(tm.params, torch.from_numpy(toks[:, :s]),
                             sphinx_moe.encode_image(tm.params, tm.args, torch.from_numpy(x)))
    got, _ = sphinx_moe.forward(tm.params, tm.args, torch.from_numpy(toks[:, :s]), cache=tcache,
                                cur_pos=0, embeds=temb)
    assert got.shape == (b, s + n_img, tm.args.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    free, _ = sphinx_moe.forward(tm.params, tm.args, torch.from_numpy(toks[:, :s]),
                                 images=torch.from_numpy(x))
    np.testing.assert_allclose(got[:, n_img:].numpy(), free.numpy(), **LOGIT_TOL)
    for i in range(steps):
        pos, tok = s + n_img + i, toks[:, s + i:s + i + 1]
        want, jcache = jsmoe.forward(jm.params, jm.args, jnp.asarray(tok), cache=jcache,
                                     cur_pos=pos)
        got, _ = sphinx_moe.forward(tm.params, tm.args, torch.from_numpy(tok), cache=tcache,
                                    cur_pos=pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_generate_with_images_follows_a_jax_greedy_chain(tok_path):  # noqa: F811
    """MetaModel.generate(images=...) of mixtral_sparse_ens5 (255 image
    words): the Generator's greedy tokens equal a greedy chain of the JAX
    forward over [BOS, image words, prompt] with decode positions shifted by
    the image words; the stream of the same prompt ends on the same text."""
    tm, jm = pair(tok_path, "mixtral_sparse_ens5")
    n, steps, x = 255, 6, images(1, 448, seed=7)
    ids = tm.tokenizer.encode("the quick brown fox", bos=True, eos=False)
    jcache = jsmoe.init_kv_cache(jm.args, 1, max_len=len(ids) + n + steps)
    emb = jnp.take(jm.params["tok_embeddings"]["weight"], jnp.asarray([ids]), axis=0)
    emb = jnp.concatenate([emb[:, :1], jsmoe.encode_image(jm.params, jm.args, jnp.asarray(x)),
                           emb[:, 1:]], axis=1)
    out, jcache = jsmoe.forward(jm.params, jm.args, jnp.asarray([ids]), cache=jcache,
                                cur_pos=0, embeds=emb)
    want = [int(jnp.argmax(out[0, -1]))]
    for i in range(steps - 1):
        out, jcache = jsmoe.forward(jm.params, jm.args, jnp.asarray([want[-1:]]), cache=jcache,
                                    cur_pos=len(ids) + n + i)
        want.append(int(jnp.argmax(out[0, 0])))
    text = tm.generate(["the quick brown fox"], images=x, max_gen_len=steps)
    gen = tm.generator
    if tm.tokenizer.eos_id in want:
        want = want[:want.index(tm.tokenizer.eos_id) + 1]
    assert gen.last_tokens[0, len(ids):len(ids) + len(want)].tolist() == want
    stream = list(tm.stream_generate("the quick brown fox", images=x, max_gen_len=steps))
    assert stream[-1]["end_of_content"] and stream[-1]["text"] == text[0]


def test_batcher_on_text(tok_path):  # noqa: F811
    """The ContinuousBatcher takes a SPHINX-MoE model for text (Mixtral's
    forward_paged): greedy text equal to the JAX batcher's over the same
    model, and the allocator balanced after the run."""
    tm, jm = pair(tok_path, "mixtral_sparse_ens")
    prompts = ["the quick brown fox jumps", "hi", "hello world this"]
    kw = dict(slots=2, page_size=32)
    jb = JBatcher(jm.module, jm.args, jm.params, jm.tokenizer, **kw)
    tb = ContinuousBatcher(tm.module, tm.args, tm.params, tm.tokenizer, device="cpu", **kw)
    got = tb.run(prompts, max_gen_len=8)
    assert got == jb.run(prompts, max_gen_len=8) and all(got)
    assert tb.pool.free_pages == tb.total_pages - 1


def test_quant_blocklist_and_trainable_filter(tok_path):  # noqa: F811
    """get_quant_blocklist is the JAX package's (Mixtral's router and the
    visual modules); quantize() at width 128 makes each layer's experts a
    tuple of W4 weights and keeps the router and every visual leaf dense
    f32; the trainable filter (full and PEFT args) answers as JAX's on the
    port's names."""
    cfg = dict(TINY, dim=128, hidden_dim=128)
    tm = MetaModel("mixtral_sparse_ens", cfg, tokenizer_path=tok_path, max_seq_len=MAX_SEQ,
                   device="cpu").quantize()
    jargs = JMetaModel("mixtral_sparse_ens", cfg, init_params=False).args
    assert tm.get_quant_blocklist() == jsmoe.get_quant_blocklist(jargs)
    ff = tm.params["layers"][0]["feed_forward"]
    assert isinstance(ff["w1"]["weight"], tuple) and len(ff["w1"]["weight"]) == 4
    assert all(isinstance(w, QuantizedWeight) for w in ff["w1"]["weight"])
    assert ff["gate"]["weight"].dtype == torch.float32
    vis = [v for _, v in named_leaves(tm.params["visual"])]
    assert len(vis) > 30 and all(v.dtype == torch.float32 for v in vis)
    names = [n for n, _ in named_leaves(tm.params)]
    for extra in ({}, {"lora_rank": 4, "bias_tuning": True}):
        f = sphinx_moe.get_trainable_params_filter(SphinxMoEArgs(**dict(cfg, **extra)))
        jf = jsmoe.get_trainable_params_filter(JArgs(**dict(cfg, **extra)))
        names_ = names + ["layers/0/attention/wq/lora_a"]
        assert [f(n) for n in names_] == [jf(n) for n in names_]
        assert not any(f(n) for n in names if n.startswith("visual/"))


def test_checkpoint_round_trip(tok_path, tmp_path):  # noqa: F811
    """A W4 SPHINX-MoE (width 128) through save_pretrained and
    from_pretrained in the port: every leaf bit for bit, the experts a
    tuple of folded weights; the JAX
    package reads the experts (stacked (L, E, ...) std words), the router
    and the towers' leaves back bit for bit; params_to_jax / params_from_jax
    is exact on the same tree."""
    cfg = dict(TINY, dim=128, hidden_dim=128)
    tm = MetaModel("mixtral_sparse_ens", cfg, tokenizer_path=tok_path, max_seq_len=MAX_SEQ,
                   device="cpu").quantize()
    tm.save_pretrained(str(tmp_path))
    back = MetaModel.from_pretrained(str(tmp_path), max_seq_len=MAX_SEQ, dtype="float32",
                                     device="cpu")
    assert back.llama_type == "mixtral_sparse_ens" and back.with_visual
    again = params_from_jax(params_to_jax(tm.params), tm.args, device="cpu")
    want = dict(_flat(tm.params))
    for tree in (back.params, again):
        got = dict(_flat(tree))
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    w1 = back.params["layers"][1]["feed_forward"]["w1"]["weight"]
    assert all(w.layout == "folded" for w in w1)
    jtree = jload_checkpoint(str(tmp_path))
    jw1 = jtree["layers"]["feed_forward"]["w1"]["weight"]
    # in_dim 128 has no planes k-tile: the port writes std words (its own order)
    assert np.asarray(jw1.packed).shape[:2] == (2, 4) and jw1.layout == "std"
    np.testing.assert_array_equal(np.asarray(jw1.packed)[1, 2].view(np.int32),
                                  w1[2].packed.numpy())
    np.testing.assert_array_equal(np.asarray(jw1.scales)[1, 2], w1[2].scales.numpy())
    np.testing.assert_array_equal(np.asarray(jtree["layers"]["feed_forward"]["gate"]["weight"])[0],
                                  tm.params["layers"][0]["feed_forward"]["gate"]["weight"].numpy())
    np.testing.assert_array_equal(np.asarray(jtree["visual"]["dinov2"]["blocks"]["qkv"]["weight"]),
                                  tm.params["visual"]["dinov2"]["blocks"]["qkv"]["weight"].numpy())


def _flat(tree):
    """(path, tensor) of every tensor, a quantized weight's fields each."""
    for path, leaf in named_leaves(tree):
        if isinstance(leaf, QuantizedWeight):
            for f in ("packed", "scales", "zeros"):
                yield f"{path}#{f}", getattr(leaf, f)
        else:
            yield path, leaf
