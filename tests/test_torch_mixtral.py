"""Port parity, the Mixtral model (``models/mixtral.py``) against the JAX
package's ``accessory_tpu/models/mixtral.py`` on the same weights and tokens:
the cache-free forward (dense and W4 experts, with the load-balancing loss),
the static cache on both of its paths (per-layer pools with the fused decode
write, and a stacked cache read in each layer and written once a forward)
with the float and the int8 cache, PEFT leaves that start as the identity,
the trainable filter and the quant blocklist, per-expert quantization, and
a decode step's quantized products counted against the routing it took:
4 + 3 x touched experts a layer. A 2-layer f32 model (dim 256, 4 query / 2
KV heads, head_dim 64, 4 experts of width 256, top 2), W4 g128 built by
the JAX package in its planes layout; the JAX Pallas kernels run in
interpret mode (cache length 128). CPU only; tolerances at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.config import MixtralArgs as JArgs
from accessory_tpu.models import llama as jllama
from accessory_tpu.models import mixtral as jmixtral
from accessory_tpu.quant.quantize import quantize_params as jquantize_params

from accessory_tpu_torch.config import MixtralArgs
from accessory_tpu_torch.convert import params_from_jax
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.models import get_model_module, mixtral
from accessory_tpu_torch.ops import linear as tlinear
from accessory_tpu_torch.ops import moe as tmoe
from accessory_tpu_torch.quant import qtensor
from accessory_tpu_torch.quant.quantize import DEFAULT_BLOCKLIST, quantize_params

from test_torch_generate import one_torch_thread, to_numpy_tree  # noqa: F401  (fixture)

CFG = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=256, num_experts=4,
           vocab_size=97, max_seq_len=128, dtype="float32")
DECODE = [(0, 64)] + [(p, p + 1) for p in range(64, 68)]


@pytest.fixture(scope="module")
def models():
    """The JAX model's dense and planes-W4 params, and the port's copies."""
    jargs, targs = JArgs(**CFG), MixtralArgs(**CFG)
    dense = jmixtral.init_params(jax.random.PRNGKey(0), jargs)
    w4 = jquantize_params(dense, layout="planes")
    return {kind: (jargs, p, targs, params_from_jax(to_numpy_tree(p), targs, device="cpu"))
            for kind, p in (("dense", dense), ("w4", w4))}


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"], size=shape)


def test_registry_and_flags():
    """Every Mixtral llama_type maps to the module; its capability flags are
    the reference's (no SUPPORTS_FUSED_QKV)."""
    for name in ("mixtral", "mixtral_peft", "mixtral_sparse"):
        assert get_model_module(name) is mixtral
    for name in ("SUPPORTS_UNROLLED_DECODE", "SUPPORTS_UNROLLED_PAGED",
                 "SUPPORTS_CHUNKED_PREFILL", "SUPPORTS_KV_INT8", "SUPPORTS_FUSED_QKV"):
        assert getattr(mixtral, name, False) == getattr(jmixtral, name, False), name
    args = MixtralArgs(**CFG)
    assert (args.head_dim, args.kv_heads) == (64, 2)
    assert MixtralArgs().kv_heads == 8 and MixtralArgs().rope_theta == 1e6


@pytest.mark.parametrize("kind", ["dense", "w4"])
def test_forward_without_cache(models, kind):
    """The training forward with ``with_aux_loss``: f32 logits to 1e-4 (each
    op agrees to ~1e-6, carried through two layers), the summed
    load-balancing loss to 1e-6 relative; with ``remat`` the same bits."""
    jargs, jparams, targs, tparams = models[kind]
    toks = _tokens(0, (2, 24))
    want, _, jaux = jmixtral.forward(jparams, jargs, jnp.asarray(toks), with_aux_loss=True)
    got, cache, aux = mixtral.forward(tparams, targs, torch.from_numpy(toks),
                                      with_aux_loss=True)
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    plain, _ = mixtral.forward(tparams, targs, torch.from_numpy(toks), remat=True)
    assert torch.equal(plain, got)


def _pairs(models, chunks, path, kv_dtype):
    """The same chunks through both forwards over a W4 model: ``unrolled``
    (per-layer params and pools on both sides) or ``stacked`` (the JAX scan
    over stacked params and cache; the port's per-layer params over its
    stacked cache). [(jax logits, port logits)]."""
    jargs, jparams, targs, tparams = models["w4"]
    stacked = path == "stacked"
    if not stacked:
        jparams = jllama.unstack_layers(jparams)
    jcache = jmixtral.init_kv_cache(jargs, 2, 128, None, stacked, kv_dtype or "fp")
    tcache = mixtral.init_kv_cache(targs, 2, 128, None, stacked, kv_dtype, device="cpu")
    toks = _tokens(1, (2, max(hi for _, hi in chunks)))
    out = []
    for lo, hi in chunks:
        jl, jcache = jmixtral.forward(jparams, jargs, jnp.asarray(toks[:, lo:hi]), cache=jcache,
                                      cur_pos=lo)
        tl, _ = mixtral.forward(tparams, targs, torch.from_numpy(toks[:, lo:hi]), cache=tcache,
                                cur_pos=lo)
        out.append((np.asarray(jl), tl.numpy()))
    return out


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("path", ["unrolled", "stacked"])
def test_static_cache_logits(models, path, kv_dtype):
    """A 64-token prefill (flash attention and a slab write a layer, or one
    stacked write), a 12-token chunk after it on the stacked path, then
    decode steps (the fused attention + write per layer; read-only
    attention and one stacked write). f32 logits to 1e-3 with the float
    cache and, with the int8 cache, 1e-2 from the first step that reads
    quantized k/v (a value that differs in its last bits can round to the
    neighbouring int8 step): the tolerances of test_torch_static_paths."""
    chunks = DECODE if path == "unrolled" else [(0, 64), (64, 76)] + [
        (p, p + 1) for p in range(76, 79)]
    for i, (want, got) in enumerate(_pairs(models, chunks, path, kv_dtype)):
        assert got.shape == want.shape
        tol = 1e-2 if kv_dtype and i > 0 else 1e-3
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_decode_products_follow_the_routing(models, monkeypatch):
    """Each decode step of the W4 model makes exactly sum over layers of
    (4 + 3 x touched experts) quantized products (wq, wk, wv, wo and three
    for each expert a row chose), the count the card's launch gate holds
    row 1 to; the recorded routing has one entry a layer a step."""
    _, _, targs, tparams = models["w4"]
    calls = []

    def counting(x, qw, **kw):
        calls.append(qw.out_dim)
        return qtensor.quant_matmul(x, qw, **kw)

    monkeypatch.setattr(tlinear, "quant_matmul", counting)
    monkeypatch.setattr(tmoe, "quant_matmul", counting)
    toks = torch.from_numpy(_tokens(2, (2, 40)))
    cache = mixtral.init_kv_cache(targs, 2, 128, device="cpu")
    mixtral.forward(tparams, targs, toks[:, :32], cache=cache)
    for pos in range(32, 40):
        calls.clear()
        with tmoe.record_routing() as log:
            mixtral.forward(tparams, targs, toks[:, pos:pos + 1], cache=cache, cur_pos=pos)
        assert len(log) == targs.n_layers
        touched = [sum(r["touched"]) for r in log]
        assert all(r["rows"] == 2 and "idx" not in r for r in log)
        assert all(2 <= t <= 4 for t in touched)
        assert len(calls) == sum(4 + 3 * t for t in touched)


def test_peft_identity_and_filter():
    """LoRA (lora_b zero) and bias leaves (zero) on the attention projections
    leave the logits bit for bit as they are; the trainable filter names
    the same leaves as the reference's, over every path of the port's tree."""
    peft = MixtralArgs(**dict(CFG, lora_rank=4, bias_tuning=True))
    plain = MixtralArgs(**CFG)
    p = mixtral.init_params(peft, seed=3, device="cpu")
    p0 = mixtral.init_params(plain, seed=3, device="cpu")
    att = p["layers"][0]["attention"]["wq"]
    assert set(att) == {"weight", "lora_a", "lora_b", "bias"}
    assert "lora_a" not in p["layers"][0]["feed_forward"]["w1"]
    toks = torch.from_numpy(_tokens(3, (1, 8)))
    a, _ = mixtral.forward(p, peft, toks)
    b, _ = mixtral.forward(p0, plain, toks)
    assert torch.equal(a, b)
    jpeft = JArgs(**dict(CFG, lora_rank=4, bias_tuning=True, norm_tuning=True))
    tf = mixtral.get_trainable_params_filter(MixtralArgs(**dict(
        CFG, lora_rank=4, bias_tuning=True, norm_tuning=True)))
    jf = jmixtral.get_trainable_params_filter(jpeft)
    names = [f"layers/attention/{m}/{leaf}" for m in ("wq", "wk", "wv", "wo")
             for leaf in ("weight", "lora_a", "lora_b", "bias")]
    names += [f"layers/feed_forward/{m}/weight" for m in ("gate", "w1", "w2", "w3")]
    names += ["layers/attention_norm/weight", "norm/weight", "output/weight"]
    assert [tf(n) for n in names] == [jf(n) for n in names]
    assert tf("layers/attention/wq/lora_b") and not tf("layers/feed_forward/w1/weight")
    full = mixtral.get_trainable_params_filter(plain)
    assert all(full(n) for n in names)


def test_quantize_experts_per_expert(models):
    """``quantize_params`` turns each (E, in, out) expert leaf into a tuple of
    E W4 weights bit-equal to the JAX package's per-expert quantization (its
    4-D path, converted by params_from_jax); the router gate (the model's
    blocklist) and the norms stay dense, and the gate stays f32, also
    through ``MetaModel("mixtral").quantize()``."""
    _, _, targs, tdense = models["dense"]
    _, _, _, tw4 = models["w4"]
    block = tuple(DEFAULT_BLOCKLIST) + tuple(mixtral.get_quant_blocklist(targs))
    mine = quantize_params(tdense, blocklist=block)
    for layer, want in zip(mine["layers"], tw4["layers"]):
        ff = layer["feed_forward"]
        assert ff["gate"]["weight"].dtype == torch.float32
        assert torch.equal(ff["gate"]["weight"], want["feed_forward"]["gate"]["weight"])
        for name in ("w1", "w2", "w3"):
            got, ref = ff[name]["weight"], want["feed_forward"][name]["weight"]
            assert isinstance(got, tuple) and isinstance(ref, tuple) and len(got) == 4
            for g, r in zip(got, ref):
                assert (g.layout, g.in_dim, g.out_dim) == (r.layout, r.in_dim, r.out_dim)
                assert torch.equal(g.packed, r.packed) and torch.equal(g.scales, r.scales)
                assert torch.equal(g.zeros, r.zeros)
        assert isinstance(layer["attention"]["wq"]["weight"], qtensor.QuantizedWeight)
    assert mixtral.get_quant_blocklist(targs) == ["gate"]
    meta = MetaModel("mixtral", dict(CFG, n_layers=1), max_seq_len=64, device="cpu").quantize()
    assert meta.get_quant_blocklist() == ["gate"]
    ff = meta.params["layers"][0]["feed_forward"]
    assert ff["gate"]["weight"].dtype == torch.float32
    assert isinstance(ff["w2"]["weight"], tuple) and len(ff["w2"]["weight"]) == 4
