"""Port parity, second serving path: the many-row W4 matmul, MHA (one query
head per KV head) fused decode attention, and the int8 KV cache with its
quantizer, fused decode attention and slab write. Each plain PyTorch version
(the path a CPU tensor takes through the kernel wrapper) runs against the JAX
function on the same numpy inputs, the JAX Pallas kernels in interpret mode;
then the slice as a whole: a small MHA W4 model with a 1024-row prefill through
both Generators, with the bf16-typed and the int8 cache. CPU only.

Tolerances are stated at each test. The int8 comparisons feed both sides the
same random int8 pools and scales (through ``cache_from_jax``), so they do not
rest on two quantizers agreeing; the quantizer is held bit-equal on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.config import LLaMAArgs as JArgs
from accessory_tpu.engine.generate import Generator as JGenerator
from accessory_tpu.models import llama as jllama
from accessory_tpu.ops import decode_attention as jda
from accessory_tpu.ops.quant_matmul_bigm import planes_qmm_bigm as jplanes_qmm_bigm
from accessory_tpu.quant import qtensor as jq
from accessory_tpu.quant.quantize import quantize_params as jquantize_params
from accessory_tpu.tokenizer import Tokenizer as JTokenizer

from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.convert import cache_from_jax, params_from_jax
from accessory_tpu_torch.engine.generate import Generator
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.ops import decode_attention as tda
from accessory_tpu_torch.ops.linear import module_linear_nr
from accessory_tpu_torch.ops.norms import rms_norm
from accessory_tpu_torch.ops.quant_matmul_bigm import planes_qmm_bigm, planes_qmm_bigm_plain
from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm_plain
from accessory_tpu_torch.quant import qtensor as tq
from accessory_tpu_torch.tokenizer import Tokenizer
from accessory_tpu_torch.util import resolve_kv_dtype

from test_torch_generate import CORPUS, to_numpy_tree, tok_path  # noqa: F401  (fixture)
from test_torch_ops import DTYPES, both, f32


# ---------------------------------------------------------------- many-row W4 matmul


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n,gs,m,kx", [(1024, 256, 128, 256, 1024), (1024, 384, 64, 100, 1024),
                                         (2048, 512, 128, 1024, 2048),
                                         (1024, 256, 128, 130, 768)])
def test_bigm_plain_vs_bigm_kernel(dtype, k, n, gs, m, kx):
    """planes_qmm_bigm's plain version against the JAX kernel (interpret
    mode): the same bf16-rounded weights and an f32 sum over all of K on both
    sides, in another order, so f32 agrees to 5e-5 of the output scale and
    bf16 to one rounding step (2^-8, held at 6e-3). ``kx < k``: the port takes
    the narrow x, JAX gets it zero-padded as its quant_matmul does."""
    rng = np.random.RandomState(m)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    jqw = jq.to_planes_layout(jq.quantize_weight(jnp.asarray(w), 4, gs, DTYPES[dtype][0]))
    tqw = tq.to_folded_layout(tq.quantize_weight(torch.from_numpy(w), 4, gs, DTYPES[dtype][1]))
    x = rng.standard_normal((m, kx))
    jx, tx = both(x, dtype)
    jx = jnp.pad(jx, ((0, 0), (0, k - kx)))
    want = jplanes_qmm_bigm(jx, jqw.packed, jqw.scales, jqw.zeros, group_size=gs,
                            tk=jqw.tile_k, interpret=True)
    got = planes_qmm_bigm(tx, tqw.packed, tqw.scales, tqw.zeros, in_dim=k, group_size=gs)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    scale = float(np.abs(f32(want)).max())
    tol = 5e-5 if dtype == "float32" else 6e-3
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol * scale)


def test_bigm_and_planes_forms_differ_only_by_weight_rounding():
    """The two W4 forms stay apart: bigm rounds each weight to bf16, planes_qmm
    keeps q exact. On f32 activations they differ, by no more than the bf16
    rounding of the weights allows (2^-9 relative per weight)."""
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32) * 0.05)
    qw = tq.to_folded_layout(tq.quantize_weight(w, 4, 128, torch.float32))
    x = torch.from_numpy(rng.standard_normal((16, 256)).astype(np.float32))
    a = planes_qmm_bigm_plain(x, qw.packed, qw.scales, qw.zeros, in_dim=256, group_size=128)
    b = planes_qmm_plain(x, qw.packed, qw.scales, qw.zeros, in_dim=256, group_size=128)
    assert not torch.equal(a, b)
    bound = 2.0 ** -9 * (x.abs() @ tq.dequantize_weight(qw, torch.float32).abs())
    assert bool(((a - b).abs() <= bound + 1e-6).all())


@pytest.mark.parametrize("rows", [1023, 1024])
def test_quant_matmul_row_threshold(rows, monkeypatch):
    """quant_matmul sends BIGM_ROWS rows or more, without fusion operands, to
    planes_qmm_bigm and fewer to planes_qmm; module_linear_nr composes a
    many-row call unfused (rms_norm, product, residual) around it."""
    import accessory_tpu_torch.ops.quant_matmul_bigm as bigm_mod
    import accessory_tpu_torch.ops.quant_matmul_planes as planes_mod

    calls = []
    for mod, name in ((bigm_mod, "planes_qmm_bigm"), (planes_mod, "planes_qmm")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **kw: (calls.append(
            (_n, any(t is not None for t in a[4:]))), _fn(*a, **kw))[1])
    rng = np.random.RandomState(1)
    w = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32) * 0.05)
    qw = tq.to_folded_layout(tq.quantize_weight(w, 4, 128, torch.float32))
    x = torch.from_numpy(rng.standard_normal((rows // 8 + (rows % 8 > 0), 8, 256))
                         .astype(np.float32)).reshape(-1, 256)[:rows]
    res = torch.from_numpy(rng.standard_normal((rows, 128)).astype(np.float32))
    norm = {"weight": torch.from_numpy(rng.standard_normal(256).astype(np.float32))}
    got = module_linear_nr(x, {"weight": qw}, norm=norm, residual=res)
    want_kernel = "planes_qmm_bigm" if rows >= tq.BIGM_ROWS else "planes_qmm"
    assert calls == [(want_kernel, rows < tq.BIGM_ROWS)]   # fused below, unfused from 1024 on
    xn = rms_norm(x, norm["weight"], 1e-5)
    if rows >= tq.BIGM_ROWS:
        want = res + planes_qmm_bigm_plain(xn, qw.packed, qw.scales, qw.zeros, in_dim=256,
                                           group_size=128)
        assert torch.equal(got, want)
    else:
        want = res + planes_qmm_plain(xn, qw.packed, qw.scales, qw.zeros, in_dim=256,
                                      group_size=128)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


# ---------------------------------------------------------------- MHA fused decode attention


@pytest.mark.parametrize("pos", [0, 1, 131, 255])
def test_mha_decode_attention_update_vs_hgrp_kernel(pos):
    """decode_attention_update at one query head per KV head against the JAX
    head-grouped kernel (_kernel_hgrp_w, interpret mode), f32: the output to
    1e-5 absolute (sums in another order), the written pools equal."""
    b, nkv, hd, s_len = 4, 8, 64, 256
    rng = np.random.RandomState(pos)
    q = rng.standard_normal((b, nkv, 1, hd)).astype(np.float32)
    kn = rng.standard_normal((b, nkv, 1, hd)).astype(np.float32)
    vn = rng.standard_normal((b, nkv, 1, hd)).astype(np.float32)
    ck = rng.standard_normal((b, nkv, hd, s_len)).astype(np.float32)   # JAX lane-major
    cv = rng.standard_normal((b, nkv, hd, s_len)).astype(np.float32)
    lens = jnp.full((b,), pos, jnp.int32)
    wout, wk, wv = jda._decode_attn_hgrp_w(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                                           jnp.asarray(ck), jnp.asarray(cv), lens, pos,
                                           g_blk=8, interpret=True)
    cache = cache_from_jax({"k": [ck], "v": [cv]}, device="cpu")
    tq_, tkn, tvn = (torch.from_numpy(a.transpose(0, 2, 1, 3).copy()) for a in (q, kn, vn))
    gout, gk, gv = tda.decode_attention_update(tq_, tkn, tvn, cache["k"][0], cache["v"][0], pos)
    assert gout.shape == (b, 1, nkv, hd) and gk is cache["k"][0]
    np.testing.assert_allclose(gout.numpy()[:, 0], np.asarray(wout)[:, :, 0], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk).transpose(0, 1, 3, 2))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv).transpose(0, 1, 3, 2))


# ---------------------------------------------------------------- int8 KV


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_chunk_bit_equal(dtype):
    """Same scales and same int8 values as the JAX quantizer, bit for bit:
    random vectors, an all-zero vector (scale 1e-6 / 127, zeros) and vectors
    whose quotients land on .5 (round half to even)."""
    rng = np.random.RandomState(7)
    x = rng.standard_normal((3, 5, 4, 64)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = np.arange(64) * 0.5 / 127 * 127     # amax 31.5: quotients k * 2 + ...
    x[0, 2, 0, :] = 0.0
    x[0, 2, 0, :8] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 63.5]   # scale exactly 1
    jx, tx = both(x, dtype)
    wq, ws = jda.quantize_kv_chunk(jx)
    gq, gs = tda.quantize_kv_chunk(tx)
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32 and gs.shape == x.shape[:-1]
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    assert float(gs[0, 0, 0]) == np.float32(1e-6) / np.float32(127.0)
    assert not gq[0, 0, 0].any()
    assert gq[0, 2, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 64]


def assert_written_close(got_q, want_q, got_s, want_s, rows):
    """int8 pool (B, NKV, S, HD) and scale pool (B, NKV, S) against a JAX
    kernel that quantized token ``rows`` under jit. There XLA turns amax / 127
    into amax * (1 / 127), so the JAX package's jitted quantizer differs from
    its own eager one (and from the port, which divides) in the last bit of
    some scales, and a quotient near .5 may then land on the neighbouring
    step: the written scales are held to one f32 rounding (2e-7 relative),
    the written int8 values to one step in at most 0.1% of the entries;
    every other entry must be equal."""
    got_q, want_q = got_q.numpy().astype(np.int32), np.asarray(want_q).astype(np.int32)
    got_s, want_s = got_s.numpy(), np.asarray(want_s)
    d = np.abs(got_q - want_q)
    assert d.max() <= 1 and (d[:, :, rows] > 0).mean() < 1e-3
    d[:, :, rows] = 0
    assert not d.any()
    np.testing.assert_allclose(got_s[:, :, rows], want_s[:, :, rows], rtol=2e-7, atol=0)
    keep = np.ones(got_s.shape[2], bool)
    keep[rows] = False
    np.testing.assert_array_equal(got_s[:, :, keep], want_s[:, :, keep])


def _int8_case(rng, b, nkv, hd, s_len):
    ck = rng.randint(-127, 128, (b, nkv, hd, s_len)).astype(np.int8)
    cv = rng.randint(-127, 128, (b, nkv, hd, s_len)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (b, nkv, s_len)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (b, nkv, s_len)).astype(np.float32)
    return ck, cv, ks, vs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 131, 255])
def test_decode_attention_update8_vs_hgrp_w8_kernel(dtype, pos):
    """decode_attention_update8's plain version against the JAX int8
    head-grouped kernel (_kernel_hgrp_w8, interpret mode) on the same random
    int8 pools and scales: all five results. The int8 pools and the scale
    pools must agree as assert_written_close says (equal but for the last
    bit of a scale the jitted JAX kernel wrote). Both sides round p * v_scale to bf16 before the value
    product; p comes from two exp implementations, so a rounding may flip on
    one side: one flip moves an output by up to 2^-9 * (p vs) * 127 / denom
    ~ 3e-5 here, and outputs are ~0.1-0.5, so f32 outputs are held to 3e-4
    absolute and bf16 outputs to two of their rounding steps (4e-3)."""
    b, nkv, hd, s_len = 4, 8, 64, 256
    rng = np.random.RandomState(pos)
    q, kn, vn = (rng.standard_normal((b, nkv, 1, hd)) for _ in range(3))
    ck, cv, ks, vs = _int8_case(rng, b, nkv, hd, s_len)
    (jq_, tq_), (jkn, tkn), (jvn, tvn) = (both(a, dtype) for a in (q, kn, vn))
    lens = jnp.full((b,), pos, jnp.int32)
    want = jda._decode_attn_hgrp_w8(jq_, jkn, jvn, jnp.asarray(ck), jnp.asarray(cv),
                                    jnp.asarray(ks), jnp.asarray(vs), lens, pos, g_blk=8,
                                    interpret=True)
    cache = cache_from_jax({"k": [ck], "v": [cv], "ks": [ks], "vs": [vs]}, device="cpu")
    assert cache["k"][0].dtype == torch.int8 and cache["k"][0].shape == (b, nkv, s_len, hd)
    got = tda.decode_attention_update8(tq_.transpose(1, 2), tkn.transpose(1, 2),
                                       tvn.transpose(1, 2), cache["k"][0], cache["v"][0],
                                       cache["ks"][0], cache["vs"][0], pos)
    assert got[0].dtype == tq_.dtype and got[1] is cache["k"][0] and got[3] is cache["ks"][0]
    np.testing.assert_allclose(f32(got[0])[:, 0], f32(want[0])[:, :, 0], rtol=0,
                               atol=3e-4 if dtype == "float32" else 4e-3)
    rows = slice(pos, pos + 1)
    assert_written_close(got[1], np.asarray(want[1]).transpose(0, 1, 3, 2), got[3], want[3], rows)
    assert_written_close(got[2], np.asarray(want[2]).transpose(0, 1, 3, 2), got[4], want[4], rows)


def test_decode_attention_update8_plain_serves_gqa():
    """On the CPU the plain version serves any nq / nkv: against the JAX GQA
    int8 kernel (_kernel_bloop_w8, interpret mode), same tolerances."""
    b, nkv, r, hd, s_len, pos = 2, 2, 4, 64, 128, 77
    rng = np.random.RandomState(3)
    q = rng.standard_normal((b, nkv, r, hd))
    kn, vn = (rng.standard_normal((b, nkv, 1, hd)) for _ in range(2))
    ck, cv, ks, vs = _int8_case(rng, b, nkv, hd, s_len)
    (jq_, tq_), (jkn, tkn), (jvn, tvn) = (both(a, "bfloat16") for a in (q, kn, vn))
    want = jda._decode_attn_bloop_w8(jq_, jkn, jvn, jnp.asarray(ck), jnp.asarray(cv),
                                     jnp.asarray(ks), jnp.asarray(vs),
                                     jnp.full((b,), pos, jnp.int32), pos, b_blk=2, interpret=True)
    cache = cache_from_jax({"k": [ck], "v": [cv], "ks": [ks], "vs": [vs]}, device="cpu")
    got = tda.decode_attention_update8(tq_.reshape(b, 1, nkv * r, hd), tkn.transpose(1, 2),
                                       tvn.transpose(1, 2), cache["k"][0], cache["v"][0],
                                       cache["ks"][0], cache["vs"][0], pos)
    np.testing.assert_allclose(f32(got[0]).reshape(b, nkv, r, hd), f32(want[0]), rtol=0, atol=4e-3)
    assert_written_close(got[1], np.asarray(want[1]).transpose(0, 1, 3, 2), got[3], want[3],
                         slice(pos, pos + 1))


@pytest.mark.parametrize("pos,sq", [(0, 128), (5, 7), (128, 128)])
def test_slab_write8(pos, sq):
    """write_kv_layer8's plain version against the JAX write_kv_layer8 (XLA
    path) and, at an aligned position, its slab DMA kernel (interpret mode):
    all four pools equal."""
    b, nkv, hd, s_len = 2, 2, 64, 256
    rng = np.random.RandomState(pos + sq)
    nk = rng.standard_normal((b, sq, nkv, hd)).astype(np.float32)
    nv = rng.standard_normal((b, sq, nkv, hd)).astype(np.float32) * 2
    ck, cv, ks, vs = _int8_case(rng, b, nkv, hd, s_len)
    jpools = [jnp.asarray(a) for a in (ck, cv, ks, vs)]
    want = jda.write_kv_layer8(*jpools, jnp.asarray(nk), jnp.asarray(nv), pos, use_pallas=False)
    cache = cache_from_jax({"k": [ck], "v": [cv], "ks": [ks], "vs": [vs]}, device="cpu")
    pools = [cache[key][0] for key in ("k", "v", "ks", "vs")]
    got = tda.write_kv_layer8(*pools, torch.from_numpy(nk), torch.from_numpy(nv), pos)
    assert all(g is p for g, p in zip(got, pools))
    layouts = [lambda a: a.transpose(0, 1, 3, 2)] * 2 + [lambda a: a] * 2
    for g, w, lay in zip(got, want, layouts):
        np.testing.assert_array_equal(g.numpy(), lay(np.asarray(w)))
    if pos % 128 == 0 and sq % 128 == 0:
        qk, sk = jda.quantize_kv_chunk(jnp.asarray(nk))
        qv, sv = jda.quantize_kv_chunk(jnp.asarray(nv))
        slab = jda._write_slab_layer_q8(*jpools, qk.transpose(0, 2, 3, 1), qv.transpose(0, 2, 3, 1),
                                        sk.transpose(0, 2, 1), sv.transpose(0, 2, 1), pos,
                                        interpret=True)
        for g, w, lay in zip(got, slab, layouts):
            np.testing.assert_array_equal(g.numpy(), lay(np.asarray(w)))


def test_cache_from_jax_layouts():
    """bf16 (numpy's extension dtype), f32 and int8 pools, a list or a stacked
    array, come out (B, NKV, S, HD) contiguous; scale pools keep (B, NKV, S)."""
    args = JArgs(dim=128, n_layers=2, n_heads=2, vocab_size=32, max_seq_len=16)
    for kv_dtype, want in (("fp", torch.bfloat16), ("int8", torch.int8)):
        for stacked in (False, True):
            jc = jllama.init_kv_cache(args, 3, max_len=16, stacked=stacked, kv_dtype=kv_dtype)
            jc = {k: (np.asarray(v) if stacked else [np.asarray(a) for a in v])
                  for k, v in jc.items()}
            tc = cache_from_jax(jc, device="cpu")
            assert set(tc) == set(jc) and len(tc["k"]) == 2
            assert tc["k"][0].shape == (3, 2, 16, 64) and tc["k"][0].dtype == want
            assert tc["v"][1].is_contiguous()
            if kv_dtype == "int8":
                assert tc["ks"][0].shape == (3, 2, 16) and tc["vs"][1].dtype == torch.float32


def test_init_kv_cache_and_dtype_policy():
    """The port's KV-dtype policy: explicit wins, None is the activation
    dtype (int8 is opt-in here; the JAX package's accelerator default does
    not carry over); pools have the JAX cache's keys in the port's layout."""
    assert resolve_kv_dtype(None) is None and resolve_kv_dtype("fp") is None
    assert resolve_kv_dtype("bf16") is None and resolve_kv_dtype("int8") == "int8"
    assert resolve_kv_dtype("i8") == "int8"
    with pytest.raises(ValueError, match="kv_dtype"):
        resolve_kv_dtype("fp8")
    args = LLaMAArgs(dim=128, n_layers=2, n_heads=2, vocab_size=32, max_seq_len=16)
    fp = llama.init_kv_cache(args, 3, device="cpu")
    assert set(fp) == {"k", "v"} and fp["k"][0].dtype == torch.bfloat16
    c8 = llama.init_kv_cache(args, 3, kv_dtype="int8", device="cpu")
    assert set(c8) == {"k", "v", "ks", "vs"} and len(c8["ks"]) == 2
    assert c8["k"][1].shape == (3, 2, 16, 64) and c8["v"][0].dtype == torch.int8
    assert c8["ks"][0].shape == (3, 2, 16) and c8["vs"][1].dtype == torch.float32
    jc = jllama.init_kv_cache(JArgs(dim=128, n_layers=2, n_heads=2, vocab_size=32,
                                    max_seq_len=16), 3, stacked=False, kv_dtype="int8")
    assert set(jc) == set(c8)


def test_metamodel_quantize_and_kv_dtype():
    """MetaModel.quantize (layer by layer, in place of the dense layers) gives
    the weights quantize_params gives; kv_dtype reaches the Generator."""
    from accessory_tpu_torch.quant.quantize import quantize_params

    cfg = dict(dim=128, n_layers=2, n_heads=2, vocab_size=64, multiple_of=128)
    model = MetaModel("llama", cfg, max_seq_len=32, seed=3, device="cpu")
    want = quantize_params(llama.init_params(model.args, seed=3, device="cpu"))
    model.quantize()
    for got_l, want_l in zip(model.params["layers"], want["layers"]):
        for grp, name in (("attention", "wq"), ("attention", "wo"), ("feed_forward", "w2")):
            g, w = got_l[grp][name]["weight"], want_l[grp][name]["weight"]
            assert isinstance(g, tq.QuantizedWeight) and g.layout == "folded"
            assert torch.equal(g.packed, w.packed) and torch.equal(g.zeros, w.zeros)
        assert got_l["attention_norm"]["weight"].dtype == torch.bfloat16
    assert not isinstance(model.params["output"]["weight"], tq.QuantizedWeight)
    model.tokenizer = object()
    assert model.generator.kv_dtype is None
    model.kv_dtype = "int8"
    model._reset_generator()
    assert model.generator.kv_dtype == "int8"


# ---------------------------------------------------------------- the slice as a whole


def _build(tok_path, dtype, kv_dtype):
    """A 2-layer dim-256 MHA model (4 heads = 4 KV heads, head_dim 64), W4,
    built and quantized by the JAX package, in both Generators."""
    jtok = JTokenizer(tok_path)
    cfg = dict(dim=256, n_layers=2, n_heads=4, multiple_of=128, vocab_size=jtok.n_words,
               max_seq_len=128, dtype=dtype)
    jargs = JArgs(**cfg)
    qparams = jquantize_params(jllama.init_params(jax.random.PRNGKey(1), jargs), layout="planes")
    jgen = JGenerator(jllama, jargs, qparams, jtok, unroll_decode=True, kv_dtype=kv_dtype)
    targs = LLaMAArgs(**cfg)
    tgen = Generator(llama, targs, params_from_jax(to_numpy_tree(qparams), targs, device="cpu"),
                     Tokenizer(tok_path), kv_dtype=kv_dtype, device="cpu")
    return jgen, tgen


def _prompts(tok, n=8, lo=66, hi=100):
    """n prompts whose token counts lie in [lo, hi]: the 128-token prefill
    bucket, so n * 128 = 1024 prefill rows."""
    words = " ".join(CORPUS[:3]).split()
    out = []
    for i in range(n):
        text, j = "", i
        while len(tok.encode(text, bos=True, eos=False)) < lo + 4 * i:
            text = (text + " " + words[j % len(words)]).strip()
            j += 1
        assert len(tok.encode(text, bos=True, eos=False)) <= hi
        out.append(text)
    return out


@pytest.fixture(scope="module", params=["fp", "int8"])
def mha_pair(request, tok_path):  # noqa: F811
    return _build(tok_path, "float32", request.param) + (request.param,)


def test_mha_greedy_text_identical(mha_pair):
    """8 prompts in the 128-token bucket (1024 prefill rows: both packages take
    their many-row W4 kernel), then fused MHA decode over the f32 or the int8
    cache, the JAX kernels in interpret mode: identical greedy text."""
    jgen, tgen, _ = mha_pair
    prompts = _prompts(tgen.tokenizer)
    max_gen = 128 - max(len(tgen.tokenizer.encode(p, bos=True, eos=False)) for p in prompts)
    want = jgen.generate(prompts, max_gen_len=max_gen)
    got = tgen.generate(prompts, max_gen_len=max_gen)
    assert got == want
    assert tgen.last_decode_steps > 0 and any(len(t) > 0 for t in got)


def _logits_pair(jgen, tgen, kv_dtype, steps=3):
    rng = np.random.RandomState(0)
    b, plen, s_len = 8, 128, 256
    toks = rng.randint(0, jgen.args.vocab_size, size=(b, plen + steps))
    jcache = jllama.init_kv_cache(jgen.args, b, max_len=s_len, stacked=False, kv_dtype=kv_dtype)
    tcache = llama.init_kv_cache(tgen.args, b, s_len, kv_dtype=kv_dtype, device="cpu")
    jl, jcache = jllama.forward(jgen.params, jgen.args, jnp.asarray(toks[:, :plen]),
                                cache=jcache, cur_pos=0)
    tl, _ = llama.forward(tgen.params, tgen.args, torch.from_numpy(toks[:, :plen]),
                          cache=tcache, cur_pos=0)
    pairs = [(np.asarray(jl), tl.numpy())]
    for i in range(steps):
        p = plen + i
        jl, jcache = jllama.forward(jgen.params, jgen.args, jnp.asarray(toks[:, p:p + 1]),
                                    cache=jcache, cur_pos=p)
        tl, _ = llama.forward(tgen.params, tgen.args, torch.from_numpy(toks[:, p:p + 1]),
                              cache=tcache, cur_pos=p)
        pairs.append((np.asarray(jl), tl.numpy()))
    return pairs, jcache, tcache


def test_mha_logits_f32(mha_pair):
    """f32 activations, a 1024-row prefill and three decode steps: logits and
    the cached k/v (values ~4) to 1e-3 (each op agrees to ~1e-5 relative;
    carried through two layers the packages measure 8e-4 apart on the prefill
    logits, as on the GQA model of test_torch_generate). With the int8 cache
    a k/v value that differs in its last bits between the packages can round
    to the neighbouring int8 step (1/127 of that vector's largest value):
    decode logits are held to 1e-2, the int8 pools to one step in at most 1%
    of their entries (0.2% measured), the scales to 1e-3 relative."""
    jgen, tgen, kv_dtype = mha_pair
    pairs, jcache, tcache = _logits_pair(jgen, tgen, kv_dtype)
    for i, (want, got) in enumerate(pairs):
        assert got.shape == want.shape
        tol = 1e-3 if kv_dtype == "fp" or i == 0 else 1e-2
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    want_c = cache_from_jax({k: [np.asarray(a) for a in v] for k, v in jcache.items()},
                            device="cpu")
    assert set(want_c) == set(tcache)
    for key in want_c:
        for w, g in zip(want_c[key], tcache[key]):
            w, g = w[:, :, :131].to(torch.float32), g[:, :, :131].to(torch.float32)
            assert float(w.abs().max()) > 0
            if kv_dtype == "int8" and key in ("k", "v"):
                d = (g - w).abs()
                assert float(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-2
            else:
                np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-3, rtol=1e-3)


def test_mha_logits_bf16(tok_path):  # noqa: F811
    """bf16 activations over the int8 cache: the packages round to bf16 at
    different points (see test_torch_generate.test_logits_bf16), carried
    through two layers: 3% relative L2 and 0.1 absolute."""
    jgen, tgen = _build(tok_path, "bfloat16", "int8")
    for want, got in _logits_pair(jgen, tgen, "int8", steps=2)[0]:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 3e-2, rel
        np.testing.assert_allclose(got, want, atol=0.1, rtol=0)
