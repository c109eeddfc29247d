"""Port parity, whole models in the new weight formats: W8 (the w8 layout, the
JAX side's W8 Pallas kernel in interpret mode), W3 (dequant + plain matmul on
both sides) and W3 nibble-packed (the W4 planes kernel), each served by the
port's Generator after ``params_from_jax`` against the JAX Generator: greedy
text identical, f32 logits to 1e-3 (as test_torch_generate). Checkpoints in
every layout: ``params_from_jax`` / ``params_to_jax``, and
``save_pretrained`` -> ``from_pretrained`` bit for bit, the JAX package
loading what the port wrote; ``from_pretrained(quant=True, quant_bits=8 |
3)``. CPU only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.checkpoint import load_checkpoint as jload_checkpoint
from accessory_tpu.config import LLaMAArgs as JArgs
from accessory_tpu.engine.generate import Generator as JGenerator
from accessory_tpu.models import llama as jllama
from accessory_tpu.quant import qtensor as jq
from accessory_tpu.quant.quantize import quantize_params as jquantize_params
from accessory_tpu.tokenizer import Tokenizer as JTokenizer

from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.convert import params_from_jax, params_to_jax
from accessory_tpu_torch.engine.generate import Generator
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.quant import qtensor as tq
from accessory_tpu_torch.tokenizer import Tokenizer

from test_torch_checkpoint import _both_logits, _leaves
from test_torch_generate import one_torch_thread, tok_path, to_numpy_tree  # noqa: F401


def _nibble_w3(params):
    """The JAX tree with every projection quantize_weight(bits=3,
    nibble_pack=True), layer by layer."""
    def visit(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if not (name.startswith("layers/") and name.endswith("/weight") and leaf.ndim == 3
                and "norm" not in name):
            return leaf
        qws = [jq.quantize_weight(leaf[i], 3, 128, act_dtype=leaf.dtype, nibble_pack=True)
               for i in range(leaf.shape[0])]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *qws)
    return jax.tree_util.tree_map_with_path(visit, params)


@pytest.mark.parametrize("route", ["w8", "w3", "w3_nibble"])
def test_quantized_model_generates_as_reference(tok_path, route):  # noqa: F811
    """W8 with the JAX side in the w8 layout (its kernel in interpret mode;
    the port's w8_qmm plain version, fused decode calls and all), W3 RTN and
    W3 nibble-packed (read into the port's folded W4 layout)."""
    jtok = JTokenizer(tok_path)
    cfg = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, multiple_of=128,
               vocab_size=jtok.n_words, max_seq_len=128, dtype="float32")
    jargs = JArgs(**cfg)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jargs)
    if route == "w8":
        jparams = jquantize_params(jparams, bits=8, layout="w8")
    elif route == "w3":
        jparams = jquantize_params(jparams, bits=3)
    else:
        jparams = _nibble_w3(jparams)
    tparams = params_from_jax(to_numpy_tree(jparams), LLaMAArgs(**cfg), device="cpu")
    w = tparams["layers"][0]["feed_forward"]["w2"]["weight"]
    assert (w.layout, w.bits) == {"w8": ("w8", 8), "w3": ("std", 3),
                                  "w3_nibble": ("folded", 4)}[route]
    tmodel = type("M", (), {"params": tparams, "args": LLaMAArgs(**cfg)})
    jmodel = type("M", (), {"params": jparams, "args": jargs})
    for want, got in _both_logits(jmodel, tmodel, steps=1):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    jgen = JGenerator(jllama, jargs, jparams, jtok, unroll_decode=True, kv_dtype="fp")
    tgen = Generator(llama, LLaMAArgs(**cfg), tparams, Tokenizer(tok_path), device="cpu")
    prompts = ["the quick brown", "hello world"]
    got = tgen.generate(prompts, max_gen_len=16)
    assert got == jgen.generate(prompts, max_gen_len=16) and any(got)


def _port_layout_model(tok_path, layout, dim=512, dtype="bfloat16"):
    """A 2-layer port MetaModel (dim 512 by default: the magic tile's four
    groups) whose projections are in one layout: w8 and W3 std through
    quantize(bits), std W4 with GPTQ-style zeros, and its magic repack."""
    cfg = dict(dim=dim, n_layers=2, n_heads=dim // 64, n_kv_heads=2, multiple_of=256,
               dtype=dtype)
    model = MetaModel("llama", cfg, tok_path, max_seq_len=64, seed=2, device="cpu")
    if layout in ("w8", "w3"):
        return model.quantize(bits=8 if layout == "w8" else 3)
    rng = np.random.RandomState(0)
    for layer in model.params["layers"]:
        for part in ("attention", "feed_forward"):
            for mod in layer[part].values():
                k, n = mod["weight"].shape
                qw = tq.QuantizedWeight(
                    tq.pack_int(torch.from_numpy(rng.randint(0, 16, (k, n))), 4),
                    torch.from_numpy((rng.rand(k // 128, n) * 0.01 + 1e-3).astype(np.float32)),
                    torch.from_numpy(rng.randint(1, 17, (k // 128, n)).astype(np.float32)),
                    4, 128, k, n, act_dtype=getattr(torch, dtype))
                mod["weight"] = tq.to_magic_layout(qw) if layout == "magic" else qw
    return model


@pytest.mark.parametrize("layout", ["w8", "w3", "std", "magic"])
def test_checkpoint_round_trip_every_layout(tmp_path, tok_path, layout):  # noqa: F811
    """save_pretrained -> from_pretrained in the port: every leaf bit for bit,
    each quantized leaf in the layout (and K tile) it was saved in; the JAX
    package loads the same files: the same words, and for std / w8 the same
    dequantized weights; params_to_jax / params_from_jax carry them alike."""
    model = _port_layout_model(tok_path, layout)
    model.save_pretrained(str(tmp_path))
    back = MetaModel.from_pretrained(str(tmp_path), max_seq_len=64, dtype="bfloat16",
                                     device="cpu")
    want, got = dict(_leaves(model.params)), dict(_leaves(back.params))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if isinstance(w, tq.QuantizedWeight):
            assert (g.layout, g.bits, g.tile_k, g.in_dim, g.out_dim) == \
                (w.layout, w.bits, w.tile_k, w.in_dim, w.out_dim)
            for f in ("packed", "scales", "zeros"):
                assert torch.equal(getattr(g, f), getattr(w, f)), (path, f)
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), path
    wq = model.params["layers"][1]["attention"]["wq"]["weight"]
    assert wq.layout == {"w3": "std"}.get(layout, layout)
    jw = jax.tree.map(lambda x: x[1], jload_checkpoint(str(tmp_path))["layers"]["attention"][
        "wq"]["weight"])
    assert (jw.layout, jw.bits, jw.tile_k) == (wq.layout, wq.bits, wq.tile_k)
    words = wq.packed.numpy() if layout == "w8" else wq.packed.numpy().view(np.uint32)
    np.testing.assert_array_equal(np.asarray(jw.packed), words)
    if layout != "magic":
        np.testing.assert_array_equal(np.asarray(jq.dense_weight(jw, jnp.float32)),
                                      tq.dense_weight(wq, torch.float32).numpy())
    again = params_from_jax(params_to_jax(model.params), model.args, device="cpu")
    assert torch.equal(again["layers"][1]["attention"]["wq"]["weight"].packed, wq.packed)


@pytest.mark.parametrize("bits,layout", [(8, "w8"), (3, "std")])
def test_from_pretrained_quantizes_to_w8_and_w3(tmp_path, tok_path, bits, layout):  # noqa: F811
    """from_pretrained(quant=True, quant_bits=8 | 3) on a dense checkpoint:
    every projection in the bit width's layout, the rest dense."""
    MetaModel("llama", dict(dim=256, n_layers=1, n_heads=4, multiple_of=128), tok_path,
              max_seq_len=64, device="cpu").save_pretrained(str(tmp_path))
    model = MetaModel.from_pretrained(str(tmp_path), max_seq_len=64, quant=True,
                                      quant_bits=bits, device="cpu")
    layer = model.params["layers"][0]
    for mod in list(layer["attention"].values()) + list(layer["feed_forward"].values()):
        assert (mod["weight"].layout, mod["weight"].bits) == (layout, bits)
    assert isinstance(model.params["output"]["weight"], torch.Tensor)
    assert len(model.generate(["hello"], max_gen_len=4)) == 1


@pytest.mark.parametrize("layout", ["w8", "std"])
def test_new_layouts_on_the_stacked_and_paged_paths(tok_path, layout):  # noqa: F811
    """The stacked-cache path (separate projections) and the continuous
    batcher (forward_paged over a page pool) go through the same quantized
    matmul: on w8 and std weights they give the static unrolled Generator's
    greedy text (f32 activations)."""
    from accessory_tpu_torch.engine.scheduler import ContinuousBatcher

    model = _port_layout_model(tok_path, layout, dim=256, dtype="float32")
    prompts = ["the quick brown", "hello world this is"]
    want = Generator(llama, model.args, model.params, model.tokenizer,
                     device="cpu").generate(prompts, max_gen_len=12)
    stacked = Generator(llama, model.args, model.params, model.tokenizer, device="cpu",
                        unroll_decode=False).generate(prompts, max_gen_len=12)
    paged = ContinuousBatcher(llama, model.args, model.params, model.tokenizer, slots=2,
                              page_size=16, device="cpu").run(prompts, max_gen_len=12)
    assert stacked == want and paged == want
