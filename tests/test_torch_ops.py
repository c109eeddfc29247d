"""Port parity, ops: each op's plain PyTorch version (the path a CPU tensor
takes through the kernel wrapper) against the JAX function on the same numpy
inputs, with the JAX Pallas kernels in interpret mode. CPU only.

Tolerances: f32 inputs agree to ~1e-5 relative (same op order, sums taken
in another order). bf16 inputs differ by bf16 roundings placed differently
(the JAX planes kernel rounds q*s to bf16 before its dot where the port
keeps q exact and scales after), so bf16 outputs are held to ~1e-2
relative to their scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.ops.attention import attention as jattention
from accessory_tpu.ops import decode_attention as jda
from accessory_tpu.ops import norms as jnorms
from accessory_tpu.ops import rope as jrope
from accessory_tpu.ops import sampling as jsampling
from accessory_tpu.ops.flash_attention import flash_attention_tpu
from accessory_tpu.ops.quant_matmul_planes import planes_qmm as jplanes_qmm
from accessory_tpu.quant import qtensor as jq

from accessory_tpu_torch.ops import attention as tatt
from accessory_tpu_torch.ops import decode_attention as tda
from accessory_tpu_torch.ops import norms as tnorms
from accessory_tpu_torch.ops import rope as trope
from accessory_tpu_torch.ops import sampling as tsampling
from accessory_tpu_torch.ops.flash_attention import flash_attention
from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm
from accessory_tpu_torch.quant import qtensor as tq

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, dtype, f32_tol=2e-5):
    got, want = f32(got), f32(want)
    scale = max(1.0, float(np.abs(want).max()))
    tol = f32_tol if dtype == "float32" else 1.5e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((3, 5, 256)) * 3
    w = rng.standard_normal(256)
    jx, tx = both(x, dtype)
    jw, tw = both(w, dtype)
    got = tnorms.rms_norm(tx, tw, 1e-5)
    assert got.dtype == tx.dtype
    assert_close(got, jnorms.rms_norm(jx, jw, 1e-5), dtype, f32_tol=1e-6)


@pytest.mark.parametrize("style", ["interleaved", "half"])
def test_rope(style):
    hd, nq, nkv = 64, 4, 2
    jc, js = jrope.precompute_rope(hd, 96, 10000.0, None)
    tc, ts = trope.precompute_rope(hd, 96, 10000.0, None, device="cpu")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 7, nq, hd))
    jx, tx = both(x, "float32")
    assert_close(trope.apply_rope(tx, tc[10:17], ts[10:17], style),
                 jrope.apply_rope(jx, jc[10:17], js[10:17], style), "float32")
    # decode rows for the flat fused-qkv output, one position
    jcr, jsr = jrope.rope_rows(jc[33], js[33], nq + nkv, nkv, hd, style)
    tcr, tsr = trope.rope_rows(tc[33], ts[33], nq + nkv, nkv, hd, style)
    np.testing.assert_allclose(tcr.numpy(), np.asarray(jcr), atol=2e-6)
    np.testing.assert_allclose(tsr.numpy(), np.asarray(jsr), atol=2e-6)
    y = rng.standard_normal((3, (nq + 2 * nkv) * hd))
    jy, ty = both(y, "float32")
    assert_close(trope.apply_rope_flat(ty, tcr, tsr, style, hd),
                 jrope.apply_rope_flat(jy, jcr, jsr, style, hd), "float32")


def _w4_pair(k, n, pad_in_to=None, seed=2):
    """The same W4 weight in the JAX planes layout and the port's folded one."""
    rng = np.random.RandomState(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    jqw = jq.to_planes_layout(jq.quantize_weight(jnp.asarray(w), 4, 128, jnp.float32,
                                                 pad_in_to=pad_in_to))
    tqw = tq.to_folded_layout(tq.quantize_weight(torch.from_numpy(w), 4, 128, torch.float32,
                                                 pad_in_to=pad_in_to))
    return jqw, tqw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fusion", ["none", "norm", "residual", "rope_interleaved",
                                    "rope_half", "all"])
def test_w4_matmul_plain_vs_planes_kernel(dtype, fusion):
    m, k, n, hd = 5, 256, 384, 64
    jqw, tqw = _w4_pair(k, n)
    rng = np.random.RandomState(3)
    jx, tx = both(rng.standard_normal((m, k)), dtype)
    jkw, tkw = {}, {}
    if fusion in ("norm", "all"):
        nw = rng.standard_normal(k).astype(np.float32)
        jkw["norm_weight"], tkw["norm_weight"] = jnp.asarray(nw), torch.from_numpy(nw)
    if fusion in ("residual", "all"):
        jkw["residual"], tkw["residual"] = both(rng.standard_normal((m, n)), dtype)
    style = {"rope_interleaved": "interleaved", "rope_half": "half",
             "all": "half"}.get(fusion, "")
    if style:
        jc, js = jrope.precompute_rope(hd, 64)
        jcr, jsr = jrope.rope_rows(jc[9], js[9], n // hd - 2, 2, hd, style)
        jkw.update(rope_cos=jcr, rope_sin=jsr, rope_style=style, rope_hd=hd)
        tkw.update(rope_cos=torch.tensor(np.asarray(jcr)), rope_sin=torch.tensor(np.asarray(jsr)),
                   rope_style=style, rope_hd=hd)
    want = jplanes_qmm(jx, jqw.packed, jqw.scales, jqw.zeros, group_size=128,
                       tk=jqw.tile_k, interpret=True, **jkw)
    got = planes_qmm(tx, tqw.packed, tqw.scales, tqw.zeros, in_dim=tqw.in_dim,
                     group_size=128, **tkw)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    assert_close(got, want, dtype, f32_tol=5e-5)


def test_quant_matmul_padded_in_dim():
    """x narrower than a padded in_dim (the w2 case): zero-padded, exact."""
    jqw, tqw = _w4_pair(384, 256, pad_in_to=512)
    assert tqw.in_dim == 512
    rng = np.random.RandomState(4)
    jx, tx = both(rng.standard_normal((2, 3, 384)), "float32")
    assert_close(tq.quant_matmul(tx, tqw), jq.quant_matmul(jx, jqw), "float32", f32_tol=5e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 77, 255])
def test_decode_attention_update(dtype, pos):
    """Fused attention + cache write against the JAX fused kernel
    (_kernel_bloop_w, interpret mode): output and the whole cache after."""
    b, nq, nkv, hd, s_len = 2, 8, 2, 64, 256
    rng = np.random.RandomState(pos)
    q = rng.standard_normal((b, 1, nq, hd))
    kn = rng.standard_normal((b, 1, nkv, hd))
    vn = rng.standard_normal((b, 1, nkv, hd))
    ck = rng.standard_normal((b, nkv, s_len, hd))  # port layout (b, nkv, S, hd)
    cv = rng.standard_normal((b, nkv, s_len, hd))
    jq_, tq_ = both(q, dtype)
    jkn, tkn = both(kn, dtype)
    jvn, tvn = both(vn, dtype)
    jck, tck = both(ck.transpose(0, 1, 3, 2), dtype)  # JAX lane-major (b, nkv, hd, S)
    jcv, tcv = both(cv.transpose(0, 1, 3, 2), dtype)
    tck, tcv = tck.transpose(2, 3).contiguous(), tcv.transpose(2, 3).contiguous()
    wout, wk, wv = jda.decode_attention_update(jq_, jkn, jvn, jck, jcv, pos)
    gout, gk, gv = tda.decode_attention_update(tq_, tkn, tvn, tck, tcv, pos)
    assert gout.shape == (b, 1, nq, hd) and gk is tck
    assert_close(gout, wout, dtype)
    np.testing.assert_array_equal(f32(gk), f32(wk).transpose(0, 1, 3, 2))
    np.testing.assert_array_equal(f32(gv), f32(wv).transpose(0, 1, 3, 2))


@pytest.mark.parametrize("s", [128, 200])
def test_prefill_attention(s):
    """Causal self-attention (the flash wrapper's CPU path) against the JAX
    splash kernel (interpret mode) and the JAX XLA attention."""
    b, nq, nkv, hd = 2, 4, 2, 64
    rng = np.random.RandomState(s)
    jqkv = [both(rng.standard_normal((b, s, h, hd)), "float32") for h in (nq, nkv, nkv)]
    (jq_, tq_), (jk, tk), (jv, tv) = jqkv
    got = flash_attention(tq_, tk, tv)
    assert_close(got, jattention(jq_, jk, jv, causal=True), "float32")
    assert_close(got, flash_attention_tpu(jq_, jk, jv, causal=True, interpret=True),
                 "float32", f32_tol=2e-3)
    # the model-facing dispatch takes the same path
    assert_close(tatt.attention(tq_, tk, tv, causal=True), got, "float32", f32_tol=0)


def test_grouped_attention_with_offset_and_kv_len():
    b, sq, skv, nq, nkv, hd = 2, 3, 10, 4, 2, 64
    rng = np.random.RandomState(9)
    jq_, tq_ = both(rng.standard_normal((b, sq, nq, hd)), "float32")
    jk, tk = both(rng.standard_normal((b, skv, nkv, hd)), "float32")
    jv, tv = both(rng.standard_normal((b, skv, nkv, hd)), "float32")
    kv_len = np.array([7, 10])
    want = jattention(jq_, jk, jv, causal=True, q_offset=4, kv_len=jnp.asarray(kv_len))
    got = tatt.attention(tq_, tk, tv, causal=True, q_offset=4, kv_len=torch.from_numpy(kv_len))
    assert_close(got, want, "float32")


@pytest.mark.parametrize("pos,sq", [(0, 128), (5, 7)])
def test_slab_write(pos, sq):
    b, nkv, hd, s_len = 2, 2, 64, 256
    rng = np.random.RandomState(pos)
    nk = rng.standard_normal((b, sq, nkv, hd))
    nv = rng.standard_normal((b, sq, nkv, hd))
    ck = rng.standard_normal((b, nkv, s_len, hd))
    cv = rng.standard_normal((b, nkv, s_len, hd))
    jk, jv = jda.write_kv_layer(jnp.asarray(ck.transpose(0, 1, 3, 2), jnp.float32),
                                jnp.asarray(cv.transpose(0, 1, 3, 2), jnp.float32),
                                jnp.asarray(nk, jnp.float32), jnp.asarray(nv, jnp.float32), pos)
    tck = torch.tensor(ck, dtype=torch.float32)
    tcv = torch.tensor(cv, dtype=torch.float32)
    gk, gv = tda.write_kv_layer(tck, tcv, torch.tensor(nk, dtype=torch.float32),
                                torch.tensor(nv, dtype=torch.float32), pos)
    assert gk is tck and gv is tcv
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk).transpose(0, 1, 3, 2))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv).transpose(0, 1, 3, 2))
    if pos % 128 == 0 and sq % 128 == 0:
        # the JAX slab DMA kernel itself (interpret mode) agrees as well
        ik, _ = jda._write_slab_layer(
            jnp.asarray(ck.transpose(0, 1, 3, 2), jnp.float32),
            jnp.asarray(cv.transpose(0, 1, 3, 2), jnp.float32),
            jnp.asarray(nk.transpose(0, 2, 3, 1), jnp.float32),
            jnp.asarray(nv.transpose(0, 2, 3, 1), jnp.float32), pos, interpret=True)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(ik).transpose(0, 1, 3, 2))


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a CUDA device has no path: raise."""
    x = torch.empty((2, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        planes_qmm(x, x, x, x, in_dim=256, group_size=128)
    q = torch.empty((1, 1, 4, 64), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tda.decode_attention_update(q, q, q, q, q, 0)
    with pytest.raises(RuntimeError, match="no kernel"):
        flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="no kernel"):
        tda.write_kv_layer(q, q, q, q, 0)


@pytest.mark.parametrize("temperature,top_p", [(0.0, 0.95), (0.8, 0.6), (1.0, 0.95)])
def test_sample_token(temperature, top_p):
    """Greedy picks the same ids. Top-p: the PRNG streams differ (a JAX key
    against a torch.Generator), so 4000 draws of one row from each must stay
    inside the nucleus and agree in frequency within 0.04 (5 standard
    errors)."""
    rng = np.random.RandomState(1)
    logits = rng.standard_normal((3, 12)).astype(np.float32) * 2
    want = np.asarray(jsampling.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0),
                                             temperature, top_p))
    got = tsampling.sample_token(torch.from_numpy(logits), torch.Generator().manual_seed(0),
                                 temperature, top_p)
    if temperature <= 0:
        np.testing.assert_array_equal(got.numpy(), want)
        return
    n = 4000
    rows = np.repeat(logits[:1], n, axis=0)
    jdraw = np.asarray(jsampling.sample_token(jnp.asarray(rows), jax.random.PRNGKey(1),
                                              temperature, top_p))
    tdraw = tsampling.sample_token(torch.from_numpy(rows), torch.Generator().manual_seed(1),
                                   temperature, top_p).numpy()
    z = np.exp((logits[0] - logits[0].max()) / temperature)
    probs = z / z.sum()
    order = np.argsort(-probs)
    nucleus = set(order[(np.cumsum(probs[order]) - probs[order]) <= top_p])
    assert 1 < len(nucleus) < 12
    assert set(jdraw) <= nucleus and set(tdraw) <= nucleus
    np.testing.assert_allclose(np.bincount(tdraw, minlength=12) / n,
                               np.bincount(jdraw, minlength=12) / n, atol=0.04)


def test_unported_paths_name_their_queue_item():
    """Paths of later slices raise and say which ROADMAP item lifts them."""
    from accessory_tpu_torch.config import LLaMAArgs
    from accessory_tpu_torch.models import get_model_module, llama

    args = LLaMAArgs(dim=128, n_layers=1, n_heads=2, vocab_size=32, max_seq_len=16)
    # the int8 cache is served: int8 k / v pools and their f32 scale pools
    cache = llama.init_kv_cache(args, 1, kv_dtype="int8", device="cpu")
    assert sorted(cache) == ["k", "ks", "v", "vs"]
    assert cache["k"][0].dtype == torch.int8 and cache["vs"][0].shape == (1, 2, 16)
    # every family of the JAX registry is served; the MoE loss trains, under
    # a context-parallel mesh of more than one rank it waits for A10
    assert get_model_module("llama_ens").__name__.endswith("models.sphinx")
    assert get_model_module("llama_adapter").__name__.endswith("models.llama_adapter")
    assert get_model_module("mixtral_sparse_ens").__name__.endswith("models.sphinx_moe")
    with pytest.raises(KeyError, match="unknown llama_type"):
        get_model_module("llama_nonesuch")
    from accessory_tpu_torch.parallel.context import make_cp_attn_fn
    from accessory_tpu_torch.train import make_train_step

    assert callable(make_train_step(llama, args, None, moe_aux=True, device="cpu"))

    class TwoRankMesh:
        mesh_dim_names, shape = ("dp", "cp"), (1, 2)

        def get_local_rank(self, axis):
            return 0

        def get_group(self, axis):
            return None

    with pytest.raises(NotImplementedError, match="A10"):
        make_train_step(llama, args, None, moe_aux=True, attn_fn=make_cp_attn_fn(TwoRankMesh()),
                        device="cpu")
    # per-row positions are served by the paged cache, whose path the message names
    q = torch.zeros((1, 1, 2, 64))
    with pytest.raises(NotImplementedError, match="paged_cached_attention"):
        tda.cached_attention_t(q, q, q, q.transpose(1, 2), q.transpose(1, 2), torch.tensor([3]))
