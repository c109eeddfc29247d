"""Port parity, SPHINX served: ``encode_image`` of every word layout (ens,
ens_light, ens5, ens5_light, ens5p2 and the 3 x 3 + 1 grid of ens10: word
counts and values; the reference's ens5_light count, ROADMAP C11), the
multimodal prefill with the image words after the BOS and three decode steps
at positions shifted by the image words, the training forward that drops the
image positions, the quant blocklist, the visual subtree across
``params_from_jax`` / ``params_to_jax`` and the native checkpoint in both
directions, one greedy-text comparison of ``MetaModel.generate(images=...)``
with the JAX MetaModel's, and ``sphinx_api`` (``generate_response`` against
the JAX package's, ``batch_caption``).

Tiny towers (patch 56: 17 tokens a tower; CLIP 32, DINOv2 48 wide, ConvNeXt
(8, 16, 32, 64), Q-Former 32) over a 2-layer f32 decoder of width 64. The
params are drawn once by the port, each leaf then moved off its init value
with seeded numpy noise, and handed to the JAX package through
``params_to_jax``. f32 on both sides, summation order apart: image tokens
are held to 1e-4, logits to 5e-4 (the JAX package's own tolerance for its
cached multimodal forward), greedy text exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.meta import MetaModel as JMetaModel
from accessory_tpu.models import llama_qformerv2 as jqf
from accessory_tpu.models import sphinx as jsphinx
from accessory_tpu.sphinx_api import SPHINXModel as JSPHINXModel

from accessory_tpu_torch.checkpoint import read_safetensors
from accessory_tpu_torch.convert import params_from_jax, params_to_jax
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.models import llama_qformerv2, sphinx
from accessory_tpu_torch.quant.qtensor import QuantizedWeight
from accessory_tpu_torch.sphinx_api import SPHINXModel, batch_caption

from test_torch_generate import one_torch_thread, tok_path  # noqa: F401  (fixtures)
from test_torch_visual import perturbed, to_jax

TINY = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, multiple_of=32, dtype="float32",
            vit_patch=56, clip_width=32, clip_layers=2, clip_heads=2, dino_width=48,
            dino_layers=2, dino_heads=2, convnext_depths=(1, 1, 1, 1),
            convnext_dims=(8, 16, 32, 64), qformer_width=32, qformer_layers=2, qformer_heads=2)
MAX_SEQ = 640
TOKEN_TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)
# llama_type -> (visual, image size, image words at the tiny widths)
VARIANTS = {"llama_ens": ("ens", 224, 51), "llama_ens_light": ("ens_light", 224, 19),
            "llama_ens5": ("ens5", 448, 5 * 51), "llama_ens5p2": ("ens5p2", 448, 51 + 4 * 39),
            "llama_ens10": ("ens5", 672, 10 * 51),
            "llama_ens5_light": ("ens5_light", 448, 5 * 19)}
# ROADMAP C11: the JAX package's image_words counts the Q-Former's 32 words
# in ens5_light, whose encode_image has none
JAX_IMAGE_WORDS = {"llama_ens5_light": 5 * 51}


_PAIRS = {}


def pair(tok, llama_type):
    """(port MetaModel, JAX MetaModel) of one family on the same params."""
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


@pytest.mark.parametrize("llama_type", sorted(VARIANTS))
def test_encode_image_matches_jax(tok_path, llama_type):  # noqa: F811
    """Every word layout: the family's visual / image_size defaults, the
    crop count and image_words as the JAX package's (but for C11), and the
    image tokens (b, image_words, dim) within 1e-4 of JAX's encode_image."""
    tm, jm = pair(tok_path, llama_type)
    visual, size, words = VARIANTS[llama_type]
    assert (tm.args.visual, tm.args.image_size) == (jm.args.visual, jm.args.image_size) \
        == (visual, size)
    assert tm.with_visual and jm.with_visual
    assert sphinx.image_words(tm.args) == words
    assert jsphinx.image_words(jm.args) == JAX_IMAGE_WORDS.get(llama_type, words)
    assert sphinx.n_crops(tm.args) == jsphinx.n_crops(jm.args)
    x = images(1, size)
    want = np.asarray(jax.jit(lambda p, i: jsphinx.encode_image(p, jm.args, i))(
        jm.params, jnp.asarray(x)))
    got = sphinx.encode_image(tm.params, tm.args, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, words, TINY["dim"])
    np.testing.assert_allclose(got, want, **TOKEN_TOL)


def test_forward_with_images_and_decode(tok_path):  # noqa: F811
    """llama_ens: the cached prefill over [BOS, image words, text] (rows from
    the embeddings, s + image_words of them), three decode steps at
    positions s + image_words + i, and the cache-free forward, which drops
    the image positions, each against the JAX forward."""
    tm, jm = pair(tok_path, "llama_ens")
    n_img, b, s, steps = sphinx.image_words(tm.args), 2, 8, 3
    toks = np.random.RandomState(4).randint(0, tm.args.vocab_size, (b, s + steps))
    x = images(b, 224, seed=5)
    want_train, _ = jsphinx.forward(jm.params, jm.args, jnp.asarray(toks[:, :s]),
                                    images=jnp.asarray(x))
    got_train, _ = sphinx.forward(tm.params, tm.args, torch.from_numpy(toks[:, :s]),
                                  images=torch.from_numpy(x))
    assert got_train.shape == (b, s, tm.args.vocab_size)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train), **LOGIT_TOL)

    max_len = s + n_img + steps
    jcache = jsphinx.init_kv_cache(jm.args, b, max_len=max_len)
    tcache = sphinx.init_kv_cache(tm.args, b, max_len, device="cpu")
    jimg = jsphinx.encode_image(jm.params, jm.args, jnp.asarray(x))
    jemb = jnp.take(jm.params["tok_embeddings"]["weight"], jnp.asarray(toks[:, :s]), axis=0)
    jemb = jnp.concatenate([jemb[:, :1], jimg, jemb[:, 1:]], axis=1)
    want, jcache = jsphinx.forward(jm.params, jm.args, jnp.asarray(toks[:, :s]), cache=jcache,
                                   cur_pos=0, embeds=jemb)
    temb = sphinx.splice(tm.params, torch.from_numpy(toks[:, :s]),
                         sphinx.encode_image(tm.params, tm.args, torch.from_numpy(x)))
    got, _ = sphinx.forward(tm.params, tm.args, torch.from_numpy(toks[:, :s]), cache=tcache,
                            cur_pos=0, embeds=temb)
    assert got.shape == (b, s + n_img, tm.args.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(got[:, n_img:].numpy(), got_train.numpy(), **LOGIT_TOL)
    for i in range(steps):
        pos = s + n_img + i
        tok = toks[:, s + i:s + i + 1]
        want, jcache = jsphinx.forward(jm.params, jm.args, jnp.asarray(tok), cache=jcache,
                                       cur_pos=pos)
        got, _ = sphinx.forward(tm.params, tm.args, torch.from_numpy(tok), cache=tcache,
                                cur_pos=pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_generate_with_images_matches_jax(tok_path):  # noqa: F811
    """MetaModel.generate(images=...) of llama_ens: greedy text identical to
    the JAX MetaModel's (two prompts of different lengths, 8 new tokens);
    the stream of the first prompt with its image ends on the same text."""
    tm, jm = pair(tok_path, "llama_ens")
    prompts, x = ["the quick brown fox", "hello"], images(2, 224, seed=6)
    want = jm.generate(prompts, images=x, max_gen_len=8)
    got = tm.generate(prompts, images=x, max_gen_len=8)
    assert got == want and any(got)
    stream = list(tm.stream_generate(prompts[0], images=x[:1], max_gen_len=8))
    assert stream[-1]["end_of_content"] and stream[-1]["text"] == got[0]


def test_c11_ens5_light_word_count(tok_path):  # noqa: F811
    """ROADMAP C11 pinned: the JAX package's image_words for ens5_light
    (5 x 51) disagrees with its encode_image (5 x 19 words), so its
    Generator reads the prefill's logits and places the decode positions
    160 words off. The port counts 5 x 19 and its Generator takes the count
    from the embeddings: its greedy tokens equal a greedy chain of the JAX
    forward over [BOS, image words, text] with decode positions shifted by
    5 x 19; the cache-free forward returns the text positions only."""
    tm, jm = pair(tok_path, "llama_ens5_light")
    n, steps, x = 5 * 19, 4, images(1, 448, seed=8)
    jtok = jsphinx.encode_image(jm.params, jm.args, jnp.asarray(x))
    assert jtok.shape[1] == n != jsphinx.image_words(jm.args)
    ids = tm.tokenizer.encode("hi", bos=True, eos=False)
    logits, _ = sphinx.forward(tm.params, tm.args, torch.tensor([ids]),
                               images=torch.from_numpy(x))
    assert logits.shape == (1, len(ids), tm.args.vocab_size)

    jcache = jsphinx.init_kv_cache(jm.args, 1, max_len=len(ids) + n + steps)
    emb = jnp.take(jm.params["tok_embeddings"]["weight"], jnp.asarray([ids]), axis=0)
    emb = jnp.concatenate([emb[:, :1], jtok, emb[:, 1:]], axis=1)
    out, jcache = jsphinx.forward(jm.params, jm.args, jnp.asarray([ids]), cache=jcache,
                                  cur_pos=0, embeds=emb)
    want = [int(jnp.argmax(out[0, -1]))]
    for i in range(steps - 1):
        out, jcache = jsphinx.forward(jm.params, jm.args, jnp.asarray([want[-1:]]),
                                      cache=jcache, cur_pos=len(ids) + n + i)
        want.append(int(jnp.argmax(out[0, 0])))
    tm.generate(["hi"], images=x, max_gen_len=steps)
    assert tm.generator.last_decode_steps == steps
    assert tm.generator.last_tokens[0, len(ids):len(ids) + steps].tolist() == want


def test_quant_blocklist_and_trainable_filters(tok_path):  # noqa: F811
    """quantize() keeps every visual leaf a dense f32 tensor (the module's
    get_quant_blocklist, the JAX package's list) and quantizes the decoder;
    both families' trainable-name filters agree with the JAX package's."""
    tm = MetaModel("llama_ens_light", dict(TINY, dim=128), tokenizer_path=tok_path,
                   max_seq_len=MAX_SEQ, device="cpu").quantize()
    jargs = JMetaModel("llama_ens_light", dict(TINY, dim=128), init_params=False).args
    assert tm.get_quant_blocklist() == jsphinx.get_quant_blocklist(jargs)
    assert llama_qformerv2.get_quant_blocklist(tm.args) == jqf.get_quant_blocklist(jargs)
    leaves = jax.tree_util.tree_leaves(tm.params["visual"])
    assert len(leaves) > 30
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32 for v in leaves)
    assert isinstance(tm.params["layers"][0]["attention"]["wq"]["weight"], QuantizedWeight)
    names = ["visual/clip/blocks/qkv/weight", "visual/qformer_proj/linear/weight",
             "layers/0/attention/wq/weight", "output/weight"]
    for fam, jmod in (("llama_ens", jsphinx), ("llama_qformerv2", jqf)):
        mod = sphinx if fam == "llama_ens" else llama_qformerv2
        tf, jf = mod.get_trainable_params_filter(tm.args), jmod.get_trainable_params_filter(jargs)
        assert [tf(n) for n in names] == [jf(n) for n in names]


def _visual_leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("llama_type", ["llama_ens", "llama_qformerv2"])
def test_visual_subtree_crosses_over_bit_for_bit(tok_path, tmp_path, llama_type):  # noqa: F811
    """params_from_jax with a bf16 cast keeps the visual subtree f32 and
    bit-equal (ConvNeXt's stages a list), params_to_jax gives it back as it
    came; a port checkpoint of the family round-trips it through
    save_pretrained / from_pretrained(dtype="bfloat16"), stages under index
    keys in the file."""
    tm = MetaModel(llama_type, TINY, tokenizer_path=tok_path, max_seq_len=MAX_SEQ, seed=3,
                   device="cpu")
    tree = params_to_jax(tm.params)
    back = params_from_jax(tree, tm.args, device="cpu", cast=torch.bfloat16)
    assert back["tok_embeddings"]["weight"].dtype == torch.bfloat16
    want = _visual_leaves(tm.params["visual"])
    got = dict(_visual_leaves(back["visual"]))
    assert len(want) == len(got) > 30
    for path, w in want:
        assert got[path].dtype == torch.float32 and torch.equal(got[path], w), path
    again = dict(_visual_leaves(params_to_jax(back)["visual"]))
    for path, w in _visual_leaves(tree["visual"]):
        np.testing.assert_array_equal(again[path], w)

    tm.save_pretrained(str(tmp_path))
    keys = read_safetensors(str(tmp_path / "weights.safetensors"))
    if llama_type == "llama_ens":
        assert "visual/convnext/stages/3/blocks/dw" in keys
    loaded = MetaModel.from_pretrained(str(tmp_path), dtype="bfloat16", max_seq_len=MAX_SEQ,
                                       device="cpu")
    assert loaded.with_visual and dataclasses.asdict(loaded.args) == dict(
        dataclasses.asdict(tm.args), convnext_depths=list(tm.args.convnext_depths),
        convnext_dims=list(tm.args.convnext_dims))
    got = dict(_visual_leaves(loaded.params["visual"]))
    for path, w in want:
        assert got[path].dtype == torch.float32 and torch.equal(got[path], w), path


def test_jax_checkpoint_through_from_pretrained(tok_path, tmp_path):  # noqa: F811
    """llama_qformerv2 (a SPHINX family whose tree the JAX package can save):
    JAX's save_pretrained, the port's from_pretrained, every visual leaf
    bit-equal and f32; the port's save_pretrained, JAX's from_pretrained
    (dtype float32), every visual leaf bit-equal again. ROADMAP C10 pinned:
    the JAX package saves no ConvNeXt family (its stages list is one object
    leaf), and its from_pretrained casts the towers to its dtype (bf16 by
    default) where the port keeps them f32."""
    jm = JMetaModel("llama_qformerv2", TINY, tokenizer_path=tok_path, max_seq_len=MAX_SEQ,
                    init_params=False)
    jm.params = to_jax(params_to_jax(MetaModel(
        "llama_qformerv2", TINY, tokenizer_path=tok_path, max_seq_len=MAX_SEQ, seed=4,
        device="cpu").params))
    jm.save_pretrained(str(tmp_path / "jax"))
    tm = MetaModel.from_pretrained(str(tmp_path / "jax"), max_seq_len=MAX_SEQ, device="cpu")
    want = _visual_leaves(jax.tree.map(np.asarray, jm.params["visual"]))
    got = dict(_visual_leaves(tm.params["visual"]))
    assert len(want) == len(got) > 30
    for path, w in want:
        assert got[path].dtype == torch.float32
        np.testing.assert_array_equal(got[path].numpy(), w)
    tm.save_pretrained(str(tmp_path / "port"))
    back = JMetaModel.from_pretrained(str(tmp_path / "port"), max_seq_len=MAX_SEQ,
                                      dtype="float32")
    for path, w in _visual_leaves(jax.tree.map(np.asarray, back.params["visual"])):
        np.testing.assert_array_equal(w, got[path].numpy())
    cast = JMetaModel.from_pretrained(str(tmp_path / "port"), max_seq_len=MAX_SEQ)
    assert cast.params["visual"]["qformer"]["queries"].dtype == jnp.bfloat16       # C10
    ens = JMetaModel("llama_ens_light", TINY, tokenizer_path=tok_path, max_seq_len=MAX_SEQ,
                     init_params=False)
    ens.params = pair(tok_path, "llama_ens_light")[1].params
    with pytest.raises(Exception, match="object"):                                  # C10
        ens.save_pretrained(str(tmp_path / "ens"))


def test_sphinx_api_matches_jax(tok_path):  # noqa: F811
    """SPHINXModel.generate_response with a PIL image (padded to a square,
    resized to the family's image_size) gives the JAX SPHINXModel's greedy
    answer; the port takes a transformed (3, S, S) array as well, and
    batch_caption over three images in batches of two gives the answers of
    its two generate calls."""
    from PIL import Image

    tm, jm = pair(tok_path, "llama_ens_light")
    tsp = SPHINXModel("llama_ens_light", TINY, tokenizer_path=tok_path, max_seq_len=MAX_SEQ,
                      init_params=False, device="cpu")
    jsp = JSPHINXModel("llama_ens_light", TINY, tokenizer_path=tok_path, max_seq_len=MAX_SEQ,
                       init_params=False)
    tsp.params, jsp.params = tm.params, jm.params
    img = Image.new("RGB", (300, 200), (200, 30, 60))
    qas = [["What is in the image?", None]]
    want = jsp.generate_response(qas, image=img, max_gen_len=4)
    got = tsp.generate_response(qas, image=img, max_gen_len=4)
    assert got == want
    from accessory_tpu_torch.data.transform import padded_resize

    assert tsp.generate_response(qas, image=padded_resize(img, 224), max_gen_len=4) == got
    with pytest.raises(ValueError, match="None"):
        tsp.generate_response([["q", "a"]])
    x = list(images(3, 224, seed=7))
    caps = batch_caption(tsp, x, batch_size=2, max_gen_len=4)
    from accessory_tpu_torch.data.conversation import default_conversation

    conv = default_conversation()
    conv.load_qas([["Describe the image.", None]])
    sep = conv.response_end_signal
    direct = (tsp.generate([conv.get_prompt()] * 2, images=np.stack(x[:2]), max_gen_len=4,
                           additional_stop_symbols=(sep,))
              + tsp.generate([conv.get_prompt()], images=np.stack(x[2:]), max_gen_len=4,
                             additional_stop_symbols=(sep,)))
    assert caps == [r.split(sep)[0].strip() for r in direct] and len(caps) == 3
