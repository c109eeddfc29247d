"""Port parity, the static-cache paths as a whole: logits of a 3-layer narrow
GQA W4 model (dim 256, 4 query / 2 KV heads, head_dim 64), built and quantized
by the JAX package, through both packages' forwards on the same tokens: the
unrolled path over the int8 cache (fused GQA int8 decode), the stacked-cache
path (separate projections, read-only attention in each layer, one bulk write
per forward, a chunk after cached tokens) and the unfused per-layer route.
The JAX Pallas kernels run in interpret mode (cache length 128). CPU only;
tolerances in ``_check_pairs``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.config import LLaMAArgs as JArgs
from accessory_tpu.models import llama as jllama
from accessory_tpu.quant.fuse import fuse_for_decode as jfuse
from accessory_tpu.quant.quantize import quantize_params as jquantize_params
from accessory_tpu.tokenizer import Tokenizer as JTokenizer

from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.convert import params_from_jax
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.quant.fuse import fuse_for_decode

from test_torch_generate import to_numpy_tree, tok_path  # noqa: F401  (fixture)

CFG = dict(dim=256, n_layers=3, n_heads=4, n_kv_heads=2, multiple_of=128, max_seq_len=256)


def _models(tok_path, dtype):
    """A 3-layer dim-256 GQA model (4 query / 2 KV heads, head_dim 64), W4,
    built and quantized by the JAX package; its stacked params and the port's
    per-layer copy of them (unfused on both sides)."""
    jtok = JTokenizer(tok_path)
    cfg = dict(CFG, vocab_size=jtok.n_words, dtype=dtype)
    jargs, targs = JArgs(**cfg), LLaMAArgs(**cfg)
    qparams = jquantize_params(jllama.init_params(jax.random.PRNGKey(2), jargs), layout="planes")
    tparams = params_from_jax(to_numpy_tree(qparams), targs, device="cpu")
    return jargs, qparams, targs, tparams


@pytest.fixture(scope="module")
def models_f32(tok_path):  # noqa: F811
    return _models(tok_path, "float32")


def _run_logits(jargs, jparams, jcache, targs, tparams, tcache, chunks, **tkw):
    """The same token chunks through both forwards; [(jax logits, port logits)]."""
    rng = np.random.RandomState(0)
    toks = rng.randint(0, jargs.vocab_size, size=(2, max(hi for _, hi in chunks)))
    pairs = []
    for lo, hi in chunks:
        jl, jcache = jllama.forward(jparams, jargs, jnp.asarray(toks[:, lo:hi]), cache=jcache,
                                    cur_pos=lo)
        tl, _ = llama.forward(tparams, targs, torch.from_numpy(toks[:, lo:hi]), cache=tcache,
                              cur_pos=lo, **tkw)
        pairs.append((np.asarray(jl), tl.numpy()))
    return pairs


def _check_pairs(pairs, dtype, int8):
    """f32: logits to 1e-3 with the float cache (each op agrees to ~1e-5,
    carried through three layers) and, with the int8 cache, 1e-2 from the
    first step that reads quantized k/v (a value that differs in its last bits
    between the packages can round to the neighbouring int8 step). bf16: the
    packages round to bf16 at different points: 3% relative L2 and 0.1
    absolute. Same limits as test_torch_mha_int8."""
    for i, (want, got) in enumerate(pairs):
        assert got.shape == want.shape
        if dtype == "float32":
            tol = 1e-2 if int8 and i > 0 else 1e-3
            np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        else:
            assert np.linalg.norm(got - want) / np.linalg.norm(want) < 3e-2
            np.testing.assert_allclose(got, want, atol=0.1, rtol=0)


DECODE = [(0, 64)] + [(p, p + 1) for p in range(64, 68)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_int8_unrolled_logits(tok_path, dtype):  # noqa: F811
    """P1: fused wqkv / w13, per-layer int8 cache, the fused GQA int8 decode
    kernel on the JAX side (interpret mode): a 64-token prefill and four
    decode steps."""
    jargs, jparams, targs, tparams = _models(tok_path, dtype)
    jparams = jllama.unstack_layers(jfuse(jparams))
    jcache = jllama.init_kv_cache(jargs, 2, max_len=128, stacked=False, kv_dtype="int8")
    tcache = llama.init_kv_cache(targs, 2, 128, kv_dtype="int8", device="cpu")
    pairs = _run_logits(jargs, jparams, jcache, targs, fuse_for_decode(tparams), tcache, DECODE)
    _check_pairs(pairs, dtype, True)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_path_logits(tok_path, dtype, kv_dtype):  # noqa: F811
    """P3: separate projections, the stacked cache, read-only attention in
    each layer and one bulk write per forward (the JAX side scans its stacked
    params): a 64-token prefill, a 24-token chunk after it (pos > 0), then
    four decode steps."""
    jargs, jparams, targs, tparams = _models(tok_path, dtype)
    jcache = jllama.init_kv_cache(jargs, 2, max_len=128, stacked=True, kv_dtype=kv_dtype)
    tcache = llama.init_kv_cache(targs, 2, 128, kv_dtype=kv_dtype, device="cpu", stacked=True)
    assert isinstance(tcache["k"], torch.Tensor) and tcache["k"].shape == (3, 2, 2, 128, 64)
    chunks = [(0, 64), (64, 88)] + [(p, p + 1) for p in range(88, 92)]
    pairs = _run_logits(jargs, jparams, jcache, targs, tparams, tcache, chunks)
    _check_pairs(pairs, dtype, kv_dtype == "int8")


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_unfused_route_logits(models_f32, kv_dtype, monkeypatch):
    """P4: the per-layer path with read-only attention and the one-token
    write (ACCESSORY_FUSED_ATTN_WRITE=0 there, fused_attn_write=False here),
    f32."""
    monkeypatch.setenv("ACCESSORY_FUSED_ATTN_WRITE", "0")
    jargs, jparams, targs, tparams = models_f32
    jparams = jllama.unstack_layers(jfuse(jparams))
    jcache = jllama.init_kv_cache(jargs, 2, max_len=128, stacked=False, kv_dtype=kv_dtype)
    tcache = llama.init_kv_cache(targs, 2, 128, kv_dtype=kv_dtype, device="cpu")
    pairs = _run_logits(jargs, jparams, jcache, targs, fuse_for_decode(tparams), tcache, DECODE,
                        fused_attn_write=False)
    _check_pairs(pairs, "float32", kv_dtype == "int8")
