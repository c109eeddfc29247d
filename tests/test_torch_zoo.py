"""Port parity, InternLM and Falcon (``models/internlm.py``,
``models/falcon.py``) against the JAX package's modules on the same numpy
params (``params_from_jax``) and tokens, for each topology: ``internlm``
(RMSNorm, SwiGLU, MHA), ``internlm_ln`` (LayerNorm, tanh GELU), ``falcon``
(new decoder architecture: two layernorms, GQA, biases), ``falcon_mqa``
(``parallel_attn``, one KV head) and ``falcon_seq`` (sequential, MHA).
Covered: ``layer_norm`` and the tanh GELU; the cache-free forward (dense
and W4); the static cache on the unrolled route (per-layer pools: the
fused decode attention + write, and with ``fused_attn_write=False`` the
read-only attention and a one-token write, the JAX side then under
ACCESSORY_FUSED_ATTN_WRITE=0) and on the stacked route (read in each
layer, written once a forward), each over the float and the int8 cache;
a JAX cache carried across by ``cache_from_jax`` and params by
``params_to_jax``. Hidden 256, head_dim 64, 2 layers, vocab 256; W4 g128 built by the JAX
package in its planes layout with ``word_embeddings`` blocked (ROADMAP C8);
the JAX Pallas kernels run in interpret mode (cache length 128). CPU only;
tolerances at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from accessory_tpu.config import FalconArgs as JFalconArgs
from accessory_tpu.config import InternLMArgs as JInternLMArgs
from accessory_tpu.models import falcon as jfalcon
from accessory_tpu.models import internlm as jinternlm
from accessory_tpu.models import llama as jllama
from accessory_tpu.ops.norms import layer_norm as jlayer_norm
from accessory_tpu.quant.quantize import DEFAULT_BLOCKLIST as JBLOCK
from accessory_tpu.quant.quantize import quantize_params as jquantize_params

from accessory_tpu_torch.config import FalconArgs, InternLMArgs
from accessory_tpu_torch.convert import cache_from_jax, params_from_jax, params_to_jax
from accessory_tpu_torch.models import falcon, get_model_module, internlm
from accessory_tpu_torch.ops.norms import layer_norm

from test_torch_generate import to_numpy_tree

_BASE = dict(num_layers=2, hidden_size=256, num_attention_heads=4, vocab_size=256,
             max_seq_len=128)
TOPOLOGIES = {
    "internlm": ("internlm", dict(_BASE, multiple_of=256)),
    "internlm_ln": ("internlm", dict(_BASE, multiple_of=256, norm_type="layernorm",
                                     use_swiglu=False)),
    "falcon": ("falcon", dict(_BASE, num_kv_heads=2, bias=True)),
    "falcon_mqa": ("falcon", dict(_BASE, new_decoder_architecture=False, multi_query=True,
                                  parallel_attn=True)),
    "falcon_seq": ("falcon", dict(_BASE, new_decoder_architecture=False, multi_query=False,
                                  parallel_attn=False, bias=True)),
}
_FAMILY = {"internlm": (JInternLMArgs, InternLMArgs, jinternlm, internlm),
           "falcon": (JFalconArgs, FalconArgs, jfalcon, falcon)}
# the JAX side's blocklist keeps the embedding table dense (C8)
JAX_BLOCKLIST = tuple(JBLOCK) + ("word_embeddings",)
DECODE = [(0, 32)] + [(p, p + 1) for p in range(32, 36)]
STACKED = [(0, 32), (32, 44)] + [(p, p + 1) for p in range(44, 47)]


def _build(topology, dtype="float32", w4=True, seed=0):
    """(jargs, JAX params (stacked), port args, port params (per-layer), jmod, tmod)."""
    family, cfg = TOPOLOGIES[topology]
    jcls, tcls, jmod, tmod = _FAMILY[family]
    cfg = dict(cfg, dtype=dtype)
    jargs, targs = jcls(**cfg), tcls(**cfg)
    jparams = jmod.init_params(jax.random.PRNGKey(seed), jargs)
    if w4:
        jparams = jquantize_params(jparams, layout="planes", blocklist=JAX_BLOCKLIST)
    return (jargs, jparams, targs, params_from_jax(to_numpy_tree(jparams), targs, device="cpu"),
            jmod, tmod)


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, _BASE["vocab_size"], size=shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_and_tanh_gelu(dtype, bias):
    """``layer_norm`` against the JAX op (f32 inside, the result in x's dtype):
    f32 to 1e-6, bf16 to one bf16 step; ``F.gelu(approximate="tanh")``
    against ``jax.nn.gelu``'s default (tanh) form to 1e-6, while the erf
    form differs by more."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 256).astype(np.float32) * 3 + 0.5
    w = rng.randn(256).astype(np.float32)
    b = rng.randn(256).astype(np.float32) if bias else None
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jlayer_norm(jnp.asarray(x, jd), jnp.asarray(w, jd),
                                  None if b is None else jnp.asarray(b, jd), 1e-5)
                      .astype(jnp.float32))
    got = layer_norm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                     None if b is None else torch.from_numpy(b).to(td), 1e-5)
    assert got.dtype == td
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    g_want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(F.gelu(torch.from_numpy(x), approximate="tanh").numpy(), g_want,
                               atol=1e-6, rtol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - g_want).max() > 1e-4


def test_registry_config_and_flags():
    """Both families are registered with the reference's capability flags
    (no SUPPORTS_FUSED_QKV); the args' derived sizes are the reference's
    (InternLM's FFN width, Falcon's KV heads per topology)."""
    assert get_model_module("internlm") is internlm and get_model_module("falcon") is falcon
    for tmod, jmod in ((internlm, jinternlm), (falcon, jfalcon)):
        for name in ("SUPPORTS_UNROLLED_DECODE", "SUPPORTS_UNROLLED_PAGED",
                     "SUPPORTS_CHUNKED_PREFILL", "SUPPORTS_KV_INT8", "SUPPORTS_FUSED_QKV"):
            assert getattr(tmod, name, False) == getattr(jmod, name, False), name
    assert internlm._hidden_dim(InternLMArgs()) == jinternlm._hidden_dim(JInternLMArgs()) == 11008
    for topology, (family, cfg) in TOPOLOGIES.items():
        jcls, tcls = _FAMILY[family][:2]
        if family == "falcon":
            assert tcls(**cfg).kv_heads == jcls(**cfg).kv_heads
            assert tcls(**cfg).head_dim == jcls(**cfg).head_dim == 64
    assert FalconArgs(num_kv_heads=8, hidden_size=8192, num_attention_heads=128).kv_heads == 8


@pytest.mark.parametrize("w4", [False, True])
@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_forward_without_cache(topology, w4):
    """The training forward: f32 logits within 1e-4 of the logits' scale
    (each op agrees to ~1e-6, carried through two layers); with ``remat``
    the same bits."""
    jargs, jparams, targs, tparams, jmod, tmod = _build(topology, w4=w4)
    toks = _tokens(0, (2, 24))
    want, _ = jmod.forward(jparams, jargs, jnp.asarray(toks))
    got, cache = tmod.forward(tparams, targs, torch.from_numpy(toks))
    assert cache is None and got.dtype == torch.float32 and got.shape == (2, 24, 256)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)
    again, _ = tmod.forward(tparams, targs, torch.from_numpy(toks), remat=True)
    assert torch.equal(again, got)


def _pairs(built, chunks, route, kv_dtype, monkeypatch):
    """The same chunks through both forwards over a W4 model on one route:
    ``fused`` / ``unfused`` (per-layer params and pools on both sides) or
    ``stacked`` (the JAX scans over stacked params and cache; the port's
    per-layer params over its stacked cache). [(jax logits, port logits)]."""
    jargs, jparams, targs, tparams, jmod, tmod = built
    stacked = route == "stacked"
    if not stacked:
        jparams = jllama.unstack_layers(jparams)
    if route == "unfused":
        monkeypatch.setenv("ACCESSORY_FUSED_ATTN_WRITE", "0")
    jcache = jmod.init_kv_cache(jargs, 2, 128, None, stacked, kv_dtype or "fp")
    tcache = tmod.init_kv_cache(targs, 2, 128, None, stacked, kv_dtype, device="cpu")
    toks = _tokens(1, (2, max(hi for _, hi in chunks)))
    out = []
    for lo, hi in chunks:
        jl, jcache = jmod.forward(jparams, jargs, jnp.asarray(toks[:, lo:hi]), cache=jcache,
                                  cur_pos=lo)
        tl, _ = tmod.forward(tparams, targs, torch.from_numpy(toks[:, lo:hi]), cache=tcache,
                             cur_pos=lo, fused_attn_write=route != "unfused")
        out.append((np.asarray(jl), tl.float().numpy()))
    return out


def _check(pairs, dtype, int8):
    """f32: 1e-3 with the float cache and, with the int8 cache, 1e-2 from the
    first step that reads quantized k/v (a value that differs in its last
    bits can round to the neighbouring int8 step); bf16: 3% relative L2 and
    0.1 absolute (the packages round to bf16 at different points). The
    limits of test_torch_static_paths."""
    for i, (want, got) in enumerate(pairs):
        assert got.shape == want.shape and np.isfinite(got).all()
        if dtype == "float32":
            tol = 1e-2 if int8 and i > 0 else 1e-3
            np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        else:
            assert np.linalg.norm(got - want) / np.linalg.norm(want) < 3e-2
            np.testing.assert_allclose(got, want, atol=0.1, rtol=0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("route", ["fused", "unfused", "stacked"])
@pytest.mark.parametrize("topology", ["internlm", "falcon"])
def test_static_cache_routes(topology, route, kv_dtype, monkeypatch):
    """The main topologies (MHA and GQA) over every route and cache type:
    a 32-token prefill (flash attention and a slab write a layer, or one
    stacked write), a 12-token chunk after it on the stacked route, then
    decode steps."""
    built = _build(topology)
    chunks = STACKED if route == "stacked" else DECODE
    _check(_pairs(built, chunks, route, kv_dtype, monkeypatch), "float32", kv_dtype == "int8")


@pytest.mark.parametrize("route,kv_dtype", [("fused", None), ("stacked", "int8")])
@pytest.mark.parametrize("topology", ["internlm_ln", "falcon_mqa", "falcon_seq"])
def test_static_cache_other_topologies(topology, route, kv_dtype, monkeypatch):
    """LayerNorm + GELU, MQA and the sequential block through the cached
    forward: the unrolled route over the float cache, the stacked one over
    int8."""
    built = _build(topology)
    chunks = STACKED if route == "stacked" else DECODE
    _check(_pairs(built, chunks, route, kv_dtype, monkeypatch), "float32", kv_dtype == "int8")


@pytest.mark.parametrize("topology", ["internlm", "falcon"])
def test_static_cache_bf16(topology, monkeypatch):
    """The card's dtype: a bf16 W4 model on the unrolled route over the bf16
    cache (the serving path), and greedy tokens agreeing wherever the JAX
    side's top two logits lie further apart than the tolerance."""
    pairs = _pairs(_build(topology, dtype="bfloat16"), DECODE, "fused", None, monkeypatch)
    _check(pairs, "bfloat16", False)
    for want, got in pairs:
        top2 = np.sort(want[:, -1], axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 0.2
        assert (want[:, -1].argmax(-1) == got[:, -1].argmax(-1))[sure].all()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("topology", ["internlm", "falcon"])
def test_cache_and_params_carry_across(topology, kv_dtype):
    """``cache_from_jax`` takes the families' lane-major (L, B, NKV, HD, S)
    caches: the JAX side prefills 32 tokens into its stacked cache, the
    port decodes the next token from that cache (token-major, stacked) to
    the JAX side's logits (f32 1e-3; int8 1e-2, as ``_check``), and
    ``params_to_jax`` gives back a tree ``params_from_jax`` reads bit for
    bit."""
    jargs, jparams, targs, tparams, jmod, tmod = _build(topology)
    toks = _tokens(2, (2, 33))
    jcache = jmod.init_kv_cache(jargs, 2, 128, None, True, kv_dtype or "fp")
    _, jcache = jmod.forward(jparams, jargs, jnp.asarray(toks[:, :32]), cache=jcache)
    tcache = cache_from_jax({k: np.asarray(v) for k, v in jcache.items()}, device="cpu",
                            stacked=True)
    want, _ = jmod.forward(jparams, jargs, jnp.asarray(toks[:, 32:]), cache=jcache, cur_pos=32)
    got, _ = tmod.forward(tparams, targs, torch.from_numpy(toks[:, 32:]), cache=tcache,
                          cur_pos=32)
    _check([(np.asarray(want), got.numpy())], "float32", False)
    tree = params_to_jax(tparams)
    again = params_to_jax(params_from_jax(tree, targs, device="cpu"))
    flat = [jax.tree_util.tree_leaves_with_path(t) for t in (tree, again)]
    assert [p for p, _ in flat[0]] == [p for p, _ in flat[1]] and len(flat[0]) > 20
    for (_, a), (_, b) in zip(*flat):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("tmod,targs", [(internlm, InternLMArgs(**TOPOLOGIES["internlm"][1])),
                                        (falcon, FalconArgs(**TOPOLOGIES["falcon"][1]))])
def test_ffn_fuse_refused(tmod, targs):
    """``ffn_fuse`` names LLaMA's fused FFN kernel, which these FFNs do not
    take: the forward refuses it rather than run unfused."""
    params = tmod.init_params(targs, seed=0, device="cpu")
    with pytest.raises(ValueError, match="ffn_fuse"):
        tmod.forward(params, targs, torch.zeros((1, 4), dtype=torch.int64), ffn_fuse=True)
