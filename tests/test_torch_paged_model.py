"""Port parity, the paged model path: ``models.llama.forward_paged`` against
the JAX package's ``forward_paged`` on the same weights and tokens, through
a fresh prefill, ragged one-token decode (each slot at its own position), a
continuation chunk of 5 tokens (the paged decode kernel's multi-query form)
and one of 20 (the gather + cached_attention route), over f32 and int8
pools, fused and separate projections; and the paged logits against the
port's own static-cache ``forward``. A 2-layer dense f32 GQA model (dim 256,
4 query / 2 KV heads, head_dim 64; over int8 pools 2 query / 1 KV head,
head_dim 128). The JAX side runs its XLA gather route and, where the port's
plain version follows the Pallas kernel's op order (int8 pools), its Pallas
paged kernels in interpret mode.

Why head_dim 128 for int8 pools: both int8 kernels round p * v_scale to
bf16, relative to the running max of the softmax. The JAX pools fold two
64-wide heads into one 128-lane row below head_dim 128, so its kernel
updates that max every half page, while the port's plain version updates it
every page; the bf16 roundings then differ by up to 4e-3 on these logits. At
head_dim 128 the JAX pools are not folded and the two orders are the same.
CPU only.

Over int8 pools the JAX package's jitted write quantizes with amax * (1 /
127), the port with amax / 127 (ROADMAP §C), and the k/v it quantizes come
out of two forwards that sum in another order: after every step the written
int8 values are held to one step in at most 0.1% of the entries and the
scales to 1e-5 relative, and the JAX side then continues from the port's
pools, so each step's logits compare the two forwards on the same pool
contents.

Tolerance: logits to 1e-4 absolute (f32; sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.config import LLaMAArgs as JArgs
from accessory_tpu.models import llama as jllama

from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.convert import paged_cache_from_jax, params_from_jax
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.quant.fuse import fuse_for_decode

from test_torch_generate import to_numpy_tree
from test_torch_paged import _np_cache

CFG = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=97, multiple_of=32,
           max_seq_len=128, dtype="float32")
CFG128 = dict(CFG, n_heads=2, n_kv_heads=1)    # head_dim 128: unfolded JAX pools
ATOL = 1e-4
SLOTS, PAGE, TOTAL = 2, 16, 2 * (128 // 16) + 1


def _models(cfg):
    jargs, targs = JArgs(**cfg), LLaMAArgs(**cfg)
    jparams = jllama.init_params(jax.random.PRNGKey(3), jargs)
    tparams = params_from_jax(to_numpy_tree(jparams), targs, device="cpu")
    return jargs, jparams, targs, tparams


@pytest.fixture(scope="module")
def models():
    return _models(CFG)


@pytest.fixture(scope="module")
def models128():
    return _models(CFG128)


def _steps():
    """(tokens lo, hi, mode, ragged lengths to set first or None)."""
    return [(0, 12, "prefill", None),
            (12, 13, "decode", [12, 7]), (13, 14, "decode", None), (14, 15, "decode", None),
            (15, 20, "continuation", None), (20, 40, "continuation", None),
            (40, 41, "decode", None)]


def _pools_to_jax(tpc, jpc):
    """The port's pools in the JAX layout of ``jpc`` (unfolded: head_dim 128;
    scales padded into their 128-lane rows)."""
    out = {}
    for f in ("k_pages", "v_pages", "ks_pages", "vs_pages"):
        t, like = getattr(tpc, f).numpy(), getattr(jpc, f)
        if t.ndim == 4:
            pad = np.zeros(t.shape[:3] + (like.shape[3] * like.shape[4],), np.float32)
            pad[..., :t.shape[3]] = t
            t = pad
        out[f] = jnp.asarray(t.reshape(like.shape), like.dtype)
    return dataclasses.replace(jpc, **out)


def _check_written8(jpc, tpc):
    """The written int8 pools agree up to the jitted quantizer and the f32
    noise of the two forwards (module docstring)."""
    conv = paged_cache_from_jax(_np_cache(jpc), device="cpu")
    for q, sc in (("k_pages", "ks_pages"), ("v_pages", "vs_pages")):
        d = np.abs(getattr(conv, q).numpy().astype(np.int32)
                   - getattr(tpc, q).numpy().astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        np.testing.assert_allclose(getattr(tpc, sc).numpy(), getattr(conv, sc).numpy(),
                                   rtol=1e-5, atol=0)


def _run(jargs, jparams, targs, tparams, kv_dtype, monkeypatch, kernel_mode="0"):
    """The same token schedule through both forward_paged; [(jax, port) logits]."""
    monkeypatch.setenv("ACCESSORY_PAGED_KERNEL", kernel_mode)
    toks = np.random.RandomState(0).randint(0, CFG["vocab_size"], size=(SLOTS, 41))
    jpc = jllama.init_paged_cache(jargs, slots=SLOTS, total_pages=TOTAL, page_size=PAGE,
                                  kv_dtype=kv_dtype)
    tpc = llama.init_paged_cache(targs, slots=SLOTS, total_pages=TOTAL, page_size=PAGE,
                                 kv_dtype=kv_dtype, device="cpu")
    assert (tpc.ks_pages is not None) == (kv_dtype == "int8")
    pairs = []
    for lo, hi, mode, lengths in _steps():
        if lengths is not None:
            jpc = dataclasses.replace(jpc, lengths=jnp.asarray(lengths, jnp.int32))
            tpc = dataclasses.replace(tpc, lengths=torch.tensor(lengths, dtype=torch.int32))
        kw = dict(continuation=mode == "continuation",
                  active_pages=None if mode == "prefill" else 4)
        jl, jpc = jllama.forward_paged(jparams, jargs, jnp.asarray(toks[:, lo:hi]), jpc, **kw)
        tl, tpc = llama.forward_paged(tparams, targs, torch.from_numpy(toks[:, lo:hi]), tpc, **kw)
        np.testing.assert_array_equal(tpc.lengths.numpy(), np.asarray(jpc.lengths))
        if kv_dtype == "int8":
            _check_written8(jpc, tpc)
            jpc = _pools_to_jax(tpc, jpc)
        pairs.append((np.asarray(jl), tl.numpy()))
    return pairs


@pytest.mark.parametrize("kv_dtype,fused,kernel_mode", [
    (None, False, "0"), (None, True, "0"), ("int8", False, "interpret"),
    ("int8", True, "interpret"),
])
def test_forward_paged_matches_jax(models, models128, monkeypatch, kv_dtype, fused,
                                   kernel_mode):
    """Every step's logits within 1e-4 of the JAX package's; the lengths
    advance alike. The port's fused params (wqkv / w13) against the JAX
    package's separate ones."""
    jargs, jparams, targs, tparams = models128 if kv_dtype == "int8" else models
    if fused:
        tparams = fuse_for_decode(tparams)
        assert "wqkv" in tparams["layers"][0]["attention"]
    for j, t in _run(jargs, jparams, targs, tparams, kv_dtype, monkeypatch, kernel_mode):
        assert t.shape == j.shape and t.dtype == np.float32
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)


def test_forward_paged_equals_static_forward(models):
    """Without ragged lengths the paged path computes what the port's
    static-cache forward computes: a prefill, decode steps and a chunk."""
    _, _, targs, tparams = models
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, 97, size=(SLOTS, 30)))
    pc = llama.init_paged_cache(targs, slots=SLOTS, total_pages=TOTAL, page_size=PAGE,
                                device="cpu")
    cache = llama.init_kv_cache(targs, SLOTS, 128, device="cpu")
    for lo, hi in ((0, 10), (10, 11), (11, 12), (12, 18), (18, 30)):
        sl, _ = llama.forward(tparams, targs, toks[:, lo:hi], cache=cache, cur_pos=lo)
        pl, pc = llama.forward_paged(tparams, targs, toks[:, lo:hi], pc, continuation=lo > 0)
        np.testing.assert_allclose(pl.numpy(), sl.numpy(), rtol=0, atol=ATOL)


def test_capability_flags_match_the_reference():
    for name in ("SUPPORTS_UNROLLED_PAGED", "SUPPORTS_CHUNKED_PREFILL", "SUPPORTS_FUSED_QKV",
                 "SUPPORTS_KV_INT8", "SUPPORTS_UNROLLED_DECODE"):
        assert getattr(llama, name) == getattr(jllama, name), name
