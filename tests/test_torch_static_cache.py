"""Port parity, the rest of the static KV cache: GQA int8 fused decode,
read-only decode attention (bf16 and int8), the chunk after cached tokens,
the one-token and the stacked cache writes, the unfused per-layer route, the
stacked-cache writes. Each plain PyTorch version (the path a CPU tensor takes
through the kernel wrapper) runs against the JAX entry on the same numpy
inputs, run as the JAX package's own tests run it on the CPU: the attention
entries with ``use_pallas=False`` (their Pallas kernels in interpret mode), the
writes with ``use_pallas=True`` (interpret mode off the TPU). The slice as a
whole is held in test_torch_static_paths.py (logits) and
test_torch_static_generate.py (text), files of their own so that the test
runner can spread them over its workers. CPU only.

Tolerances are stated at each test. The int8 comparisons feed both sides the
same random int8 pools and scales, so they do not rest on two quantizers
agreeing (the quantizer is held bit-equal in test_torch_mha_int8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.ops import decode_attention as jda

from accessory_tpu_torch.convert import cache_from_jax
from accessory_tpu_torch.ops import decode_attention as tda

from test_torch_mha_int8 import _int8_case
from test_torch_ops import both, f32

S_LEN = 256
POSITIONS = [0, 1, 127, 128, S_LEN - 1]


# f32 outputs over the int8 cache. Both sides round p * v_scale to bf16 before
# the value product; p comes from two exp implementations, so a rounding may
# flip on one side and move that token's term by 2^-8 of itself. With few
# cached tokens one term can be most of an output of size up to 127 * 0.02 =
# 2.5, so the bound is 1e-2; 7e-4 is the most measured over these cases, held
# at 2e-3. bf16 outputs: two of their rounding steps (4e-3).
INT8_ATOL = {"float32": 2e-3, "bfloat16": 4e-3}


def assert_written_close(got_q, want_q, got_s, want_s, rows):
    """test_torch_mha_int8.assert_written_close for the small pools of this
    file: the jitted JAX kernel's scale at token ``rows`` may differ from the
    port's in its last bit (2e-7 relative), and int8 values of such a vector
    (only of such a vector) may then land on the neighbouring step where the
    quotient sits on a tie, which bf16 inputs make common: at most 1% of the
    written entries; every other entry of the pools must be equal."""
    got_q, want_q = got_q.numpy().astype(np.int32), np.asarray(want_q).astype(np.int32)
    got_s, want_s = got_s.numpy(), np.asarray(want_s)
    d = np.abs(got_q - want_q)
    written = d[:, :, rows]
    assert d.max() <= 1 and (written > 0).mean() <= 1e-2
    same_scale = got_s[:, :, rows] == want_s[:, :, rows]
    assert not written[same_scale].any()
    d[:, :, rows] = 0
    assert not d.any()
    np.testing.assert_allclose(got_s[:, :, rows], want_s[:, :, rows], rtol=2e-7, atol=0)
    keep = np.ones(got_s.shape[2], bool)
    keep[rows] = False
    np.testing.assert_array_equal(got_s[:, :, keep], want_s[:, :, keep])


def _qkv(rng, b, nkv, r, hd, dtype):
    """q (b, 1, nq, hd), k_new / v_new (b, 1, nkv, hd) in both packages."""
    q = rng.standard_normal((b, 1, nkv * r, hd))
    kn, vn = (rng.standard_normal((b, 1, nkv, hd)) for _ in range(2))
    return [both(a, dtype) for a in (q, kn, vn)]


def _bf16_cache(rng, b, nkv, hd, dtype):
    """A lane-major JAX cache pair and the port's copy of it."""
    ck, cv = (rng.standard_normal((b, nkv, hd, S_LEN)).astype(np.float32) for _ in range(2))
    jpools = [both(a, dtype)[0] for a in (ck, cv)]
    tpools = [both(a.transpose(0, 1, 3, 2).copy(), dtype)[1] for a in (ck, cv)]
    return jpools, tpools


# ---------------------------------------------------------------- read-only decode attention


@pytest.mark.parametrize("entry", ["bloop", "grid"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("r", [1, 4, 8])
def test_read_only_decode_attention(entry, dtype, hd, r, monkeypatch):
    """cached_attention_t at one token against the JAX read-only kernels, both
    launch shapes (_kernel_bloop, and _kernel on the (B, NKV) grid), interpret
    mode, at positions 0, 1, 127, 128 and S - 1: f32 to 1e-5 absolute (sums in
    another order); bf16 to two bf16 rounding steps of outputs below 2 (1.6e-2:
    p is rounded to bf16 from two exp implementations). The cache is not
    touched."""
    if entry == "grid":
        monkeypatch.setenv("ACCESSORY_DECODE_ATTN", "grid")
    b, nkv = 2, 2
    rng = np.random.RandomState(hd + r)
    (jq_, tq_), (jkn, tkn), (jvn, tvn) = _qkv(rng, b, nkv, r, hd, dtype)
    jpools, tpools = _bf16_cache(rng, b, nkv, hd, dtype)
    keep = [p.clone() for p in tpools]
    for pos in POSITIONS:
        want = jda.cached_attention_t(jq_, jkn, jvn, *jpools, pos, use_pallas=False)
        got = tda.cached_attention_t(tq_, tkn, tvn, *tpools, pos)
        assert got.shape == (b, 1, nkv * r, hd) and got.dtype == tq_.dtype
        np.testing.assert_allclose(f32(got), f32(want), rtol=0,
                                   atol=1e-5 if dtype == "float32" else 1.6e-2)
    assert all(torch.equal(a, b_) for a, b_ in zip(tpools, keep))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("r", [1, 4, 8])
def test_read_only_decode_attention8(dtype, hd, r):
    """cached_attention_t8 at one token against the JAX int8 read-only kernel
    (_kernel_bloop8, interpret mode) on the same int8 pools and scales, at
    positions 0, 1, 127, 128 and S - 1: outputs to INT8_ATOL."""
    b, nkv = 2, 2
    rng = np.random.RandomState(hd + r)
    (jq_, tq_), (jkn, tkn), (jvn, tvn) = _qkv(rng, b, nkv, r, hd, dtype)
    pools = _int8_case(rng, b, nkv, hd, S_LEN)
    cache = cache_from_jax({k: [a] for k, a in zip(("k", "v", "ks", "vs"), pools)}, device="cpu")
    tpools = [cache[k][0] for k in ("k", "v", "ks", "vs")]
    for pos in POSITIONS:
        want = jda.cached_attention_t8(jq_, jkn, jvn, *(jnp.asarray(a) for a in pools), pos,
                                       use_pallas=False)
        got = tda.cached_attention_t8(tq_, tkn, tvn, *tpools, pos)
        np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=INT8_ATOL[dtype])
    for t, a in zip(tpools[:2], pools[:2]):
        np.testing.assert_array_equal(t.numpy(), a.transpose(0, 1, 3, 2))


# ---------------------------------------------------------------- fused GQA int8 decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("r", [4, 8])
@pytest.mark.parametrize("pos", POSITIONS)
def test_decode_attention_update8_gqa(dtype, hd, r, pos):
    """decode_attention_update8 with several query heads per KV head against
    the JAX fused GQA int8 kernel (_kernel_bloop_w8, interpret mode): output
    to INT8_ATOL; the four pools as
    assert_written_close says (equal but for the last bit of a scale the
    jitted JAX kernel wrote at ``pos``)."""
    b, nkv = 2, 2
    rng = np.random.RandomState(pos + r)
    (jq_, tq_), (jkn, tkn), (jvn, tvn) = _qkv(rng, b, nkv, r, hd, dtype)
    pools = _int8_case(rng, b, nkv, hd, S_LEN)
    cache = cache_from_jax({k: [a] for k, a in zip(("k", "v", "ks", "vs"), pools)}, device="cpu")
    tpools = [cache[k][0] for k in ("k", "v", "ks", "vs")]
    want = jda.decode_attention_update8(jq_, jkn, jvn, *(jnp.asarray(a) for a in pools), pos,
                                        use_pallas=False)
    got = tda.decode_attention_update8(tq_, tkn, tvn, *tpools, pos)
    assert got[1] is tpools[0] and got[4] is tpools[3]
    np.testing.assert_allclose(f32(got[0]), f32(want[0]), rtol=0, atol=INT8_ATOL[dtype])
    rows = slice(pos, pos + 1)
    assert_written_close(got[1], np.asarray(want[1]).transpose(0, 1, 3, 2), got[3], want[3], rows)
    assert_written_close(got[2], np.asarray(want[2]).transpose(0, 1, 3, 2), got[4], want[4], rows)


# ---------------------------------------------------------------- the unfused route


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("pos", [0, 1, 128, S_LEN - 1])
def test_unfused_route(int8, pos, monkeypatch):
    """fused_attn_write=False (the JAX package's ACCESSORY_FUSED_ATTN_WRITE=0):
    read-only attention, then the one-token write. On the CPU it gives exactly
    what the fused call gives; against the JAX package's unfused route: f32
    output to 1e-5 (float cache) / INT8_ATOL (int8), float pools equal, int8 pools as
    assert_written_close says."""
    monkeypatch.setenv("ACCESSORY_FUSED_ATTN_WRITE", "0")
    b, nkv, r, hd = 2, 2, 4, 64
    rng = np.random.RandomState(pos)
    (jq_, tq_), (jkn, tkn), (jvn, tvn) = _qkv(rng, b, nkv, r, hd, "float32")
    if int8:
        pools = _int8_case(rng, b, nkv, hd, S_LEN)
        jpools = [jnp.asarray(a) for a in pools]
        cache = cache_from_jax({k: [a] for k, a in zip(("k", "v", "ks", "vs"), pools)},
                               device="cpu")
        tpools = [cache[k][0] for k in ("k", "v", "ks", "vs")]
        jfn, tfn = jda.decode_attention_update8, tda.decode_attention_update8
    else:
        jpools, tpools = _bf16_cache(rng, b, nkv, hd, "float32")
        jfn, tfn = jda.decode_attention_update, tda.decode_attention_update
    want = jfn(jq_, jkn, jvn, *jpools, pos, use_pallas=False)
    fused = tfn(tq_, tkn, tvn, *[p.clone() for p in tpools], pos)
    got = tfn(tq_, tkn, tvn, *tpools, pos, fused_attn_write=False)
    assert all(torch.equal(g, f) for g, f in zip(got, fused))
    np.testing.assert_allclose(f32(got[0]), f32(want[0]), rtol=0,
                               atol=INT8_ATOL["float32"] if int8 else 1e-5)
    if int8:
        rows = slice(pos, pos + 1)
        for i in (1, 2):
            assert_written_close(got[i], np.asarray(want[i]).transpose(0, 1, 3, 2), got[i + 2],
                                 want[i + 2], rows)
    else:
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).transpose(0, 1, 3, 2))


# ---------------------------------------------------------------- a chunk after cached tokens


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,sq", [(1, 7), (128, 16), (200, 56)])
def test_chunk_after_cached_tokens(int8, dtype, pos, sq):
    """cached_attention_t / cached_attention_t8 for a chunk at pos > 0, plain
    PyTorch against the JAX package's XLA branch (all f32 inside): f32 to
    2e-5, bf16 outputs to one rounding step (8e-3)."""
    b, nkv, r, hd = 2, 2, 4, 64
    rng = np.random.RandomState(pos)
    q = rng.standard_normal((b, sq, nkv * r, hd))
    kn, vn = (rng.standard_normal((b, sq, nkv, hd)) for _ in range(2))
    (jq_, tq_), (jkn, tkn), (jvn, tvn) = (both(a, dtype) for a in (q, kn, vn))
    if int8:
        pools = _int8_case(rng, b, nkv, hd, S_LEN)
        jpools = [jnp.asarray(a) for a in pools]
        cache = cache_from_jax({k: [a] for k, a in zip(("k", "v", "ks", "vs"), pools)},
                               device="cpu")
        tpools = [cache[k][0] for k in ("k", "v", "ks", "vs")]
        jfn, tfn = jda.cached_attention_t8, tda.cached_attention_t8
    else:
        jpools, tpools = _bf16_cache(rng, b, nkv, hd, dtype)
        jfn, tfn = jda.cached_attention_t, tda.cached_attention_t
    want = jfn(jq_, jkn, jvn, *jpools, pos, use_pallas=False)
    got = tfn(tq_, tkn, tvn, *tpools, pos)
    assert got.shape == (b, sq, nkv * r, hd) and got.dtype == tq_.dtype
    np.testing.assert_allclose(f32(got), f32(want), rtol=0,
                               atol=2e-5 if dtype == "float32" else 8e-3)


def test_dequantize_kv():
    """dequantize_kv on the port's token-major pool equals the JAX package's
    on its lane-major pool, and inverts quantize_kv_chunk to half a step."""
    rng = np.random.RandomState(0)
    ck, _, ks, _ = _int8_case(rng, 2, 2, 64, 32)
    want = np.asarray(jda.dequantize_kv(jnp.asarray(ck), jnp.asarray(ks)))
    got = tda.dequantize_kv(torch.from_numpy(ck.transpose(0, 1, 3, 2).copy()),
                            torch.from_numpy(ks))
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 1, 3, 2))
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32))
    q, sc = tda.quantize_kv_chunk(x)
    assert float((tda.dequantize_kv(q, sc) - x).abs().max()) <= 0.5 * float(sc.max()) + 1e-7


# ---------------------------------------------------------------- cache writes


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("pos", POSITIONS)
def test_column_write(hd, pos):
    """write_kv_layer at one token against the JAX one-token kernel
    (_col_write_kernel4, interpret mode): both pools equal everywhere."""
    b, nkv = 2, 2
    rng = np.random.RandomState(pos)
    nk, nv = (rng.standard_normal((b, 1, nkv, hd)).astype(np.float32) for _ in range(2))
    jpools, tpools = _bf16_cache(rng, b, nkv, hd, "float32")
    want = jda.write_kv_layer(*jpools, jnp.asarray(nk), jnp.asarray(nv), pos, use_pallas=True)
    got = tda.write_kv_layer(*tpools, torch.from_numpy(nk), torch.from_numpy(nv), pos)
    assert got[0] is tpools[0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).transpose(0, 1, 3, 2))


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("pos", POSITIONS)
def test_column_write8(hd, pos):
    """write_kv_layer8 at one token against the JAX int8 one-token kernel
    (_col_write_kernel4_q8, interpret mode), the four pools held as
    assert_written_close says."""
    b, nkv = 2, 2
    rng = np.random.RandomState(pos)
    nk = rng.standard_normal((b, 1, nkv, hd)).astype(np.float32)
    nv = rng.standard_normal((b, 1, nkv, hd)).astype(np.float32) * 2
    pools = _int8_case(rng, b, nkv, hd, S_LEN)
    want = jda.write_kv_layer8(*(jnp.asarray(a) for a in pools), jnp.asarray(nk),
                               jnp.asarray(nv), pos, use_pallas=True)
    cache = cache_from_jax({k: [a] for k, a in zip(("k", "v", "ks", "vs"), pools)}, device="cpu")
    got = tda.write_kv_layer8(*(cache[k][0] for k in ("k", "v", "ks", "vs")),
                              torch.from_numpy(nk), torch.from_numpy(nv), pos)
    rows = slice(pos, pos + 1)
    assert_written_close(got[0], np.asarray(want[0]).transpose(0, 1, 3, 2), got[2], want[2], rows)
    assert_written_close(got[1], np.asarray(want[1]).transpose(0, 1, 3, 2), got[3], want[3], rows)


def _stacked_case(rng, n_layers, b, nkv, hd, sq):
    nk, nv = (rng.standard_normal((n_layers, b, sq, nkv, hd)).astype(np.float32)
              for _ in range(2))
    return nk, nv * 2


@pytest.mark.parametrize("pos,sq", [(0, 1), (1, 1), (127, 1), (128, 1), (S_LEN - 1, 1),
                                    (0, 128), (128, 128), (5, 7)])
def test_stacked_write(pos, sq):
    """write_kv_t against the JAX stacked writes: the one-token kernel
    (_col_write_kernel), the slab DMA kernel at an aligned position
    (_write_kernel), both in interpret mode, and its dynamic_update_slice for
    the rest: both pools equal everywhere."""
    n_layers, b, nkv, hd = 3, 2, 2, 64
    rng = np.random.RandomState(pos + sq)
    nk, nv = _stacked_case(rng, n_layers, b, nkv, hd, sq)
    ck, cv = (rng.standard_normal((n_layers, b, nkv, hd, S_LEN)).astype(np.float32)
              for _ in range(2))
    kernel = sq == 1 or (sq % 128 == 0 and pos % 128 == 0)
    want = jda.write_kv_t(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(nk), jnp.asarray(nv),
                          pos, use_pallas=kernel)
    cache = cache_from_jax({"k": ck, "v": cv}, device="cpu", stacked=True)
    assert cache["k"].shape == (n_layers, b, nkv, S_LEN, hd)
    got = tda.write_kv_t(cache["k"], cache["v"], torch.from_numpy(nk), torch.from_numpy(nv), pos)
    assert got[0] is cache["k"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).transpose(0, 1, 2, 4, 3))


@pytest.mark.parametrize("pos,sq", [(0, 1), (127, 1), (S_LEN - 1, 1), (0, 128), (5, 7)])
def test_stacked_write8(pos, sq):
    """write_kv_t8 against the JAX write_kv_t8 (eager quantizer, then
    dynamic_update_slice): the four stacked pools equal."""
    n_layers, b, nkv, hd = 3, 2, 2, 64
    rng = np.random.RandomState(pos + sq)
    nk, nv = _stacked_case(rng, n_layers, b, nkv, hd, sq)
    per_layer = [_int8_case(rng, b, nkv, hd, S_LEN) for _ in range(n_layers)]
    pools = [np.stack(p) for p in zip(*per_layer)]
    want = jda.write_kv_t8(*(jnp.asarray(a) for a in pools), jnp.asarray(nk), jnp.asarray(nv),
                           pos)
    cache = cache_from_jax(dict(zip(("k", "v", "ks", "vs"), pools)), device="cpu", stacked=True)
    assert cache["ks"].shape == (n_layers, b, nkv, S_LEN)
    got = tda.write_kv_t8(*(cache[k] for k in ("k", "v", "ks", "vs")), torch.from_numpy(nk),
                          torch.from_numpy(nv), pos)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).transpose(0, 1, 2, 4, 3))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_positions_are_one_int():
    """The static cache's paths share one position per batch: an int. A
    tensor raises and names the paged path, which serves per-row positions."""
    q = torch.zeros((1, 1, 2, 64))
    c = torch.zeros((1, 2, 8, 64))
    for fn, args in ((tda.cached_attention_t, (q, q, q, c, c)),
                     (tda.decode_attention_update, (q, q, q, c, c))):
        with pytest.raises(NotImplementedError, match="paged_cached_attention"):
            fn(*args, torch.tensor([3]))
