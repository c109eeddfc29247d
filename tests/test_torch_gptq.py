"""Port parity, GPTQ / OmniQuant imports: ``quant/omniquant.py``.

A tiny AutoGPTQ-format directory (``model.layers.{i}.self_attn.q_proj.qweight``
/ ``.qzeros`` / ``.scales``, int32 words, f16 scales) is written with
``safetensors.numpy`` and with the port's own writer; the port's
``load_gptq_dir`` + ``install_gptq_weights`` read it to the same weights as
the JAX package's, rotary un-permuted, MHA and GQA. W3 is read where the
reference reads it (K = N = 1280) and raises where the reference breaks (K =
2048; the reference's own failure is asserted as a record, ROADMAP C3). The
imported std weights (row 24) and their magic repack (row 25) serve through
the port's Generator with the JAX Generator's greedy text and its logits to
1e-3 (f32 activations, as test_torch_generate). CPU only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.config import LLaMAArgs as JArgs
from accessory_tpu.engine.generate import Generator as JGenerator
from accessory_tpu.models import llama as jllama
from accessory_tpu.quant import omniquant as jomni
from accessory_tpu.quant import qtensor as jq
from accessory_tpu.tokenizer import Tokenizer as JTokenizer

from accessory_tpu_torch.checkpoint.native import write_safetensors
from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.convert import params_from_jax
from accessory_tpu_torch.engine.generate import Generator
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.quant import omniquant as tomni
from accessory_tpu_torch.quant import qtensor as tq
from accessory_tpu_torch.tokenizer import Tokenizer

from test_torch_checkpoint import _both_logits
from test_torch_generate import one_torch_thread, tok_path, to_numpy_tree  # noqa: F401

def _pack(q: np.ndarray, bits: int, axis: int) -> np.ndarray:
    """Pack small ints 32 // bits to a 32-bit word along ``axis`` (the
    reference's GPTQ reading: little-endian, the last word zero-padded)."""
    pw = 32 // bits
    q = np.moveaxis(q.astype(np.uint32), axis, 0)
    q = np.pad(q, ((0, (-q.shape[0]) % pw), (0, 0)))
    shifts = (np.arange(pw, dtype=np.uint32) * bits)[None, :, None]
    words = np.bitwise_or.reduce(q.reshape(-1, pw, q.shape[1]) << shifts, axis=1)
    return np.moveaxis(words, 0, axis).view(np.int32)


def _gptq_module(rng, k, n, bits=4, gs=128):
    qmax = 2 ** bits - 1
    return {"qweight": _pack(rng.randint(0, qmax + 1, (k, n)), bits, 0),
            # stored zero points: the +1 of classic GPTQ makes them 1..qmax + 1
            "qzeros": _pack(rng.randint(0, qmax + 1, (k // gs, n)), bits, 1),
            "scales": (rng.rand(k // gs, n) * 0.01 + 2e-3).astype(np.float16)}


def _write_dir(path, shapes, n_layers, writer, bits=4, seed=0):
    rng = np.random.RandomState(seed)
    tensors = {}
    for i in range(n_layers):
        for mod, (k, n) in shapes.items():
            for field, arr in _gptq_module(rng, k, n, bits).items():
                tensors[f"model.layers.{i}.{mod}.{field}"] = arr
    tensors["model.embed_tokens.weight"] = np.zeros((4, 4), np.float16)   # not a GPTQ leaf
    path.mkdir(parents=True, exist_ok=True)
    if writer == "safetensors":
        from safetensors.numpy import save_file

        save_file(tensors, str(path / "model.safetensors"))
    else:
        write_safetensors(str(path / "model.safetensors"), tensors)
    return str(path)


def _llama_shapes(dim, nq, nkv, hidden):
    hd = dim // nq
    return {"self_attn.q_proj": (dim, nq * hd), "self_attn.k_proj": (dim, nkv * hd),
            "self_attn.v_proj": (dim, nkv * hd), "self_attn.o_proj": (nq * hd, dim),
            "mlp.gate_proj": (dim, hidden), "mlp.up_proj": (dim, hidden),
            "mlp.down_proj": (hidden, dim)}


def _same_weights(tqws, jqws):
    assert sorted(tqws) == sorted(jqws)
    for path in tqws:
        assert sorted(tqws[path]) == sorted(jqws[path])
        for i, tw in tqws[path].items():
            jw = jqws[path][i]
            assert tw.layout == "std" and (tw.in_dim, tw.out_dim, tw.bits) == \
                (jw.in_dim, jw.out_dim, jw.bits)
            np.testing.assert_array_equal(tw.packed.numpy().view(np.uint32),
                                          np.asarray(jw.packed))
            np.testing.assert_array_equal(tw.zeros.numpy(), np.asarray(jw.zeros))
            np.testing.assert_array_equal(tq.dequantize_weight(tw, torch.float32).numpy(),
                                          np.asarray(jq.dequantize_weight(jw, jnp.float32)))


def _read(path, i, mod):
    from accessory_tpu_torch.checkpoint.native import read_safetensors

    t = read_safetensors(f"{path}/model.safetensors")
    return [t[f"model.layers.{i}.{mod}.{f}"] for f in ("qweight", "qzeros", "scales")]


@pytest.mark.parametrize("writer", ["safetensors", "port"])
@pytest.mark.parametrize("nkv", [4, 2])
def test_load_gptq_dir_matches_reference(tmp_path, writer, nkv):
    """Both readers on one directory: the same words, unpacked zeros (+1) and
    dequantized weights, q / k columns un-permuted for interleaved RoPE, MHA
    (4 KV heads) and GQA (2); install_gptq_weights puts each layer's weight
    in place."""
    path = _write_dir(tmp_path / writer, _llama_shapes(256, 4, nkv, 512), 2, writer)
    kw = dict(n_heads=4, n_kv_heads=nkv)
    got = tomni.load_gptq_dir(path, act_dtype=torch.float32, device="cpu", **kw)
    want = jomni.load_gptq_dir(path, act_dtype=jnp.float32, **kw)
    _same_weights(got, {p.replace("layers/", "", 1): v for p, v in want.items()})
    # the un-permutation moved columns: the HF half-split order is not kept
    raw = tomni.from_gptq(*(np.asarray(x) for x in _read(path, 1, "self_attn.k_proj")),
                          device="cpu")
    assert not torch.equal(raw.packed, got["attention/wk/weight"][1].packed)
    params = {"layers": [{"attention": {m: {"weight": None} for m in ("wq", "wk", "wv", "wo")},
                          "feed_forward": {m: {"weight": None} for m in ("w1", "w2", "w3")}}
                         for _ in range(2)]}
    tomni.install_gptq_weights(params, got)
    assert params["layers"][1]["feed_forward"]["w2"]["weight"] is \
        got["feed_forward/w2/weight"][1]


def test_w3_gptq_where_the_reference_reads_it_and_where_it_breaks(tmp_path):
    """W3 at K = N = 1280 (10 values a word fill the words exactly): both
    readers agree. At K = 2048 the words hold 2050 rows: the reference fails
    its shape assertion (asserted here as a record of ROADMAP C3) and the
    port raises ValueError naming C3."""
    shapes = {"self_attn.q_proj": (1280, 1280)}
    ok = _write_dir(tmp_path / "ok", shapes, 1, "port", bits=3)
    got = tomni.load_gptq_dir(ok, bits=3, act_dtype=torch.float32, n_heads=10, device="cpu")
    want = jomni.load_gptq_dir(ok, bits=3, act_dtype=jnp.float32, n_heads=10)
    _same_weights(got, {p.replace("layers/", "", 1): v for p, v in want.items()})
    bad = _write_dir(tmp_path / "bad", {"self_attn.q_proj": (2048, 256)}, 1, "port", bits=3)
    with pytest.raises(AssertionError):
        jomni.load_gptq_dir(bad, bits=3, n_heads=4)
    with pytest.raises(ValueError, match="C3"):
        tomni.load_gptq_dir(bad, bits=3, n_heads=4, device="cpu")


@pytest.mark.parametrize("route", ["std", "magic"])
def test_gptq_model_generates_as_reference(tmp_path, tok_path, route):  # noqa: F811
    """A 2-layer model whose projections come from a GPTQ directory: the
    imported std weights (dim 256; the std kernel's plain version) and their
    magic repack (dim 512: the magic tile needs four groups of K) through
    the port's Generator, against the JAX Generator on the JAX package's
    import of the same files (its std route on the CPU is the XLA dequant +
    dot, its magic route the Pallas kernel in interpret mode). Greedy text
    identical, f32 logits to 1e-3."""
    jtok = JTokenizer(tok_path)
    dim, nq = (256, 4) if route == "std" else (512, 8)
    cfg = dict(dim=dim, n_layers=2, n_heads=nq, n_kv_heads=2, multiple_of=256,
               vocab_size=jtok.n_words, max_seq_len=128, dtype="float32")
    jargs = JArgs(**cfg)
    hidden = jllama.init_params(jax.random.PRNGKey(0), jargs)["layers"]["feed_forward"][
        "w1"]["weight"].shape[-1]
    path = _write_dir(tmp_path, _llama_shapes(dim, nq, 2, hidden), 2, "port", seed=1)
    kw = dict(n_heads=nq, n_kv_heads=2)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jargs)
    tparams = params_from_jax(to_numpy_tree(jparams), LLaMAArgs(**cfg), device="cpu")
    jparams = jomni.install_gptq_weights(jparams, jomni.load_gptq_dir(
        path, act_dtype=jnp.float32, **kw))
    tomni.install_gptq_weights(tparams, tomni.load_gptq_dir(
        path, act_dtype=torch.float32, device="cpu", **kw))
    if route == "magic":
        jparams = jax.tree.map(lambda x: jq.to_magic_layout(x) if isinstance(
            x, jq.QuantizedWeight) else x, jparams,
            is_leaf=lambda x: isinstance(x, jq.QuantizedWeight))
        for layer in tparams["layers"]:
            for part in ("attention", "feed_forward"):
                for mod in layer[part].values():
                    mod["weight"] = tq.to_magic_layout(mod["weight"])
    wq = tparams["layers"][0]["attention"]["wq"]["weight"]
    assert wq.layout == route and wq.bits == 4
    tmodel = type("M", (), {"params": tparams, "args": LLaMAArgs(**cfg)})
    jmodel = type("M", (), {"params": jparams, "args": jargs})
    for want, got in _both_logits(jmodel, tmodel, steps=1):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    jgen = JGenerator(jllama, jargs, jparams, jtok, unroll_decode=True, kv_dtype="fp")
    tgen = Generator(llama, LLaMAArgs(**cfg), tparams, Tokenizer(tok_path), device="cpu")
    prompts = ["the quick brown", "hello world"]
    got = tgen.generate(prompts, max_gen_len=16)
    assert got == jgen.generate(prompts, max_gen_len=16) and any(got)


def test_new_modules_are_in_the_hygiene_scan_and_default_to_cuda():
    """tests/test_torch_hygiene.py imports every module it walks in a fresh
    interpreter without JAX and scans every source for JAX imports: the new
    modules are among them. The import entry points default to the card."""
    import inspect

    from test_torch_hygiene import _modules

    mods = _modules()
    for name in ("quant.omniquant", "ops.quant_matmul_w8", "ops.quant_matmul_pallas",
                 "ops.quant_matmul_magic"):
        assert "accessory_tpu_torch." + name in mods
    for fn in (tomni.load_gptq_dir, tomni.from_gptq):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
