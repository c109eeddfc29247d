"""Port parity, the weight formats beyond folded W4: W8 (the w8 layout), W3,
W3 nibble-packed, std W4 with unfolded zeros, and the magic layout.

The quantizers and repacks are bit-equal with accessory_tpu.quant.qtensor;
each new kernel's plain version (``w8_qmm``, ``quant_matmul_pallas``,
``magic_qmm``) is held against the JAX package's Pallas kernel run in
interpret mode on the same numpy inputs; the QPEFT backward over a w8 and a
std base against ``jax.grad``; ``MetaModel.quantize`` keeps the model's own
blocklist dense (ROADMAP C1). CPU only; tolerances are stated at each test.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.ops.quant_matmul_magic import magic_qmm as jmagic_qmm
from accessory_tpu.ops.quant_matmul_pallas import quant_matmul_pallas as jstd_qmm
from accessory_tpu.ops.quant_matmul_w8 import w8_qmm as jw8_qmm
from accessory_tpu.ops.rope import precompute_rope as jprecompute_rope
from accessory_tpu.ops.rope import rope_rows as jrope_rows
from accessory_tpu.quant import qtensor as jq

from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.ops.quant_matmul_magic import magic_qmm, unpack_magic
from accessory_tpu_torch.ops.quant_matmul_pallas import quant_matmul_pallas
from accessory_tpu_torch.ops.quant_matmul_w8 import w8_qmm
from accessory_tpu_torch.quant import qtensor as tq
from accessory_tpu_torch.quant.quantize import quantize_params


def words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _weight(k, n, seed=0):
    return np.random.RandomState(seed).standard_normal((k, n)).astype(np.float32) * 0.05


def _both(w, bits, gs, pad_in_to=None, nibble_pack=False):
    return (jq.quantize_weight(jnp.asarray(w), bits, gs, pad_in_to=pad_in_to,
                               nibble_pack=nibble_pack),
            tq.quantize_weight(torch.from_numpy(w), bits, gs, pad_in_to=pad_in_to,
                               nibble_pack=nibble_pack))


def _gptq_like(k, n, gs, seed=0):
    """A std W4 weight as a GPTQ import gives it: zeros z + 1 in [1, 16]."""
    rng = np.random.RandomState(seed)
    q = rng.randint(0, 16, (k, n)).astype(np.int32)
    z = rng.randint(1, 17, (k // gs, n)).astype(np.float32)
    s = (rng.rand(k // gs, n) * 0.02 + 1e-3).astype(np.float32)
    jqw = jq.QuantizedWeight(jq.pack_int(jnp.asarray(q), 4), jnp.asarray(s), jnp.asarray(z),
                             4, gs, k, n)
    tqw = tq.QuantizedWeight(tq.pack_int(torch.from_numpy(q), 4), torch.from_numpy(s),
                             torch.from_numpy(z), 4, gs, k, n)
    return jqw, tqw


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_within_bf16_step(got, want):
    """Kernel and plain version sum the same f32 products in another order:
    the bf16 outputs differ by at most one rounding step of the output's scale."""
    got, want = got.float().numpy(), _np(want)
    step = 2.0 ** -7 * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=step)


# ---------------------------------------------------------------- quantizers, layouts


@pytest.mark.parametrize("bits,nibble,k,pad", [(8, False, 256, None), (8, False, 384, 256),
                                               (3, False, 640, None), (3, True, 256, None)])
def test_quantize_bit_exact(bits, nibble, k, pad):
    """W8, W3 (10 values a word; K 640 at group 64 leaves a padded last word)
    and W3 nibble-packed: the same words, scales and zeros as the JAX
    package."""
    jqw, tqw = _both(_weight(k, 96), bits, 128 if k % 128 == 0 else 64, pad, nibble)
    assert (tqw.bits, tqw.in_dim, tqw.out_dim) == (jqw.bits, jqw.in_dim, jqw.out_dim)
    np.testing.assert_array_equal(words(tqw.packed), np.asarray(jqw.packed))
    np.testing.assert_array_equal(tqw.scales.numpy(), np.asarray(jqw.scales))
    np.testing.assert_array_equal(tqw.zeros.numpy(), np.asarray(jqw.zeros))
    if nibble:
        assert tqw.bits == 4 and int(tq.unpack_int(tqw.packed, 4, k).max()) <= 7
    np.testing.assert_array_equal(tq.dense_weight(tqw, torch.float32).numpy(),
                                  np.asarray(jq.dense_weight(jqw, jnp.float32)))


@pytest.mark.parametrize("k,gs", [(256, 128), (384, 64), (11264, 128)])
def test_w8_layout_bit_exact(k, gs):
    """to_w8_layout: int8 rows of q - 128, zs = (z - 128) * s and the K tile
    equal; dense_weight (q8 * s - zs, two f32 roundings) equal."""
    jqw, tqw = _both(_weight(k, 64, 1), 8, gs)
    jw8, tw8 = jq.to_w8_layout(jqw), tq.to_w8_layout(tqw)
    assert tw8.layout == "w8" and tw8.tile_k == jw8.tile_k and tw8.packed.dtype == torch.int8
    np.testing.assert_array_equal(tw8.packed.numpy(), np.asarray(jw8.packed))
    np.testing.assert_array_equal(tw8.scales.numpy(), np.asarray(jw8.scales))
    np.testing.assert_array_equal(tw8.zeros.numpy(), np.asarray(jw8.zeros))
    np.testing.assert_array_equal(tq.dense_weight(tw8, torch.float32).numpy(),
                                  np.asarray(jq.dense_weight(jw8, jnp.float32)))


@pytest.mark.parametrize("k,gs", [(512, 128), (2048, 128), (5632, 128)])
def test_magic_layout_bit_exact(k, gs):
    """to_magic_layout: the same per-tile words (tiles of 512 / 2048 / 512
    rows), s / 16 and 256 + 16 z; unpack_magic inverts the repack; the
    magic dense weight is (q - z) * s up to the bf16 rounding of s / 16 and
    of the product."""
    jqw, tqw = _gptq_like(k, 96, gs, seed=k)
    jm, tm = jq.to_magic_layout(jqw), tq.to_magic_layout(tqw)
    assert tm.tile_k == jm.tile_k and tm.layout == "magic"
    np.testing.assert_array_equal(words(tm.packed), np.asarray(jm.packed))
    np.testing.assert_array_equal(tm.scales.numpy(), np.asarray(jm.scales))
    np.testing.assert_array_equal(tm.zeros.numpy(), np.asarray(jm.zeros))
    np.testing.assert_array_equal(unpack_magic(tm.packed, k, tm.tile_k).numpy(),
                                  tq.unpack_int(tqw.packed, 4, k).numpy())
    exact = tq.dense_weight(tqw, torch.float32)
    got = tq.dense_weight(tm, torch.float32)
    # |s' - bf16(s')| <= 2^-9 |s'|, then one bf16 rounding of the product
    assert float((got - exact).abs().max()) <= 2 * 2 ** -8 * float(exact.abs().max())


def test_layout_conversions_refuse_other_formats():
    _, t8 = _both(_weight(256, 64), 8, 128)
    _, t4 = _both(_weight(256, 64), 4, 128)
    with pytest.raises(ValueError, match="W4"):
        tq.to_magic_layout(t8)
    with pytest.raises(ValueError, match="W8"):
        tq.to_w8_layout(t4)
    with pytest.raises(ValueError, match="nibble_pack"):
        tq.quantize_weight(torch.zeros(128, 8), bits=4, nibble_pack=True)
    with pytest.raises(ValueError, match="fusion"):
        tq.quant_matmul(torch.zeros(2, 256), t4, residual=torch.zeros(2, 64))


def test_quantize_params_layouts():
    """'auto' gives each bit width its kernel layout on every device: folded
    W4, w8 W8, std W3; explicit layouts and the blocklist hold."""
    tree = {"layers": [{"attention": {"wq": {"weight": torch.randn(256, 128)}},
                        "attention_norm": {"weight": torch.ones(256)}}]}
    for bits, layout in ((4, "folded"), (8, "w8"), (3, "std")):
        out = quantize_params(tree, bits=bits)
        assert out["layers"][0]["attention"]["wq"]["weight"].layout == layout
        assert isinstance(out["layers"][0]["attention_norm"]["weight"], torch.Tensor)
    assert quantize_params(tree, bits=8, layout="std")["layers"][0]["attention"]["wq"][
        "weight"].layout == "std"
    with pytest.raises(ValueError, match="layout"):
        quantize_params(tree, bits=4, layout="magic")
    with pytest.raises(ValueError, match="bits"):
        quantize_params(tree, bits=2)


# ---------------------------------------------------------------- plain versions vs Pallas


def _rope(n, hd, style):
    cos, sin = jprecompute_rope(hd, 64)
    cr, sr = jrope_rows(cos[13], sin[13], n // hd - 1, 1, hd, style)
    return np.array(cr), np.array(sr)


W8_CASES = [  # (m, k, kx, n, gs, fusion)
    (5, 256, 256, 256, 128, "none"),
    (1, 256, 256, 256, 64, "norm"),
    (5, 256, 256, 256, 128, "rope_interleaved"),
    (130, 256, 256, 256, 128, "rope_half"),
    (130, 384, 384, 64, 64, "res"),            # N 64: the JAX kernel pads it to 128
    (5, 2048, 1152, 128, 128, "res"),          # x narrower than a padded in_dim
]


@pytest.mark.parametrize("m,k,kx,n,gs,fusion", W8_CASES)
def test_w8_qmm_plain_matches_pallas(m, k, kx, n, gs, fusion):
    """Row 22: the plain w8_qmm against accessory_tpu's w8_qmm(interpret=True);
    each fusion, group sizes 64 and 128, M 1 / 5 / 130, N 64 / 128 / 256, and
    a padded K (the JAX side's x zero-padded to in_dim, as its quant_matmul
    does). Tolerance: one bf16 rounding step of the output's scale."""
    jqw, tqw = _both(_weight(kx, n, 2), 8, gs, pad_in_to=k if k != kx else None)
    jw8, tw8 = jq.to_w8_layout(jqw), tq.to_w8_layout(tqw)
    assert tw8.in_dim == k
    rng = np.random.RandomState(3)
    x = rng.standard_normal((m, kx)).astype(np.float32)
    jx, tx = _bf16(np.pad(x, ((0, 0), (0, k - kx))))
    tx = tx[:, :kx]
    jkw, tkw = {}, {}
    if fusion == "norm":
        nw = (1 + 0.1 * rng.standard_normal(kx)).astype(np.float32)
        jkw["norm_weight"] = jnp.asarray(np.pad(nw, (0, k - kx)))
        tkw["norm_weight"] = torch.from_numpy(nw)
    if fusion == "res":
        r = rng.standard_normal((m, n)).astype(np.float32)
        jkw["residual"], tkw["residual"] = _bf16(r)
    if fusion.startswith("rope"):
        style = fusion.split("_")[1]
        cr, sr = _rope(n, 64, style)
        jkw.update(rope_cos=jnp.asarray(cr), rope_sin=jnp.asarray(sr), rope_style=style,
                   rope_hd=64)
        tkw.update(rope_cos=torch.from_numpy(cr), rope_sin=torch.from_numpy(sr),
                   rope_style=style, rope_hd=64)
    want = jw8_qmm(jx, jw8.packed, jw8.scales, jw8.zeros, group_size=gs, tk=jw8.tile_k,
                   interpret=True, **jkw)
    got = w8_qmm(tx, tw8.packed, tw8.scales, tw8.zeros, group_size=gs, **tkw)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert_within_bf16_step(got, want)


@pytest.mark.parametrize("m,k,n,gs", [(1, 256, 256, 128), (5, 512, 384, 64),
                                      (130, 256, 128, 128)])
def test_std_qmm_plain_matches_pallas(m, k, n, gs):
    """Row 24: the plain quant_matmul_pallas against accessory_tpu's
    quant_matmul_pallas(interpret=True) over GPTQ-style zeros up to 16.
    Tolerance: one bf16 rounding step of the output's scale."""
    jqw, tqw = _gptq_like(k, n, gs, seed=m)
    assert float(tqw.zeros.max()) == 16.0
    jx, tx = _bf16(np.random.RandomState(4).standard_normal((m, k)).astype(np.float32))
    assert_within_bf16_step(quant_matmul_pallas(tx, tqw), jstd_qmm(jx, jqw, interpret=True))


@pytest.mark.parametrize("m,k,n", [(1, 512, 256), (130, 1536, 128)])
def test_magic_qmm_plain_matches_pallas(m, k, n):
    """Row 25: the plain magic_qmm against accessory_tpu's
    magic_qmm(interpret=True), each on its own package's repack (the words
    are bit-equal, test_magic_layout_bit_exact). Tolerance: one bf16
    rounding step of the output's scale."""
    jqw, tqw = _gptq_like(k, n, 128, seed=k)
    jm, tm = jq.to_magic_layout(jqw), tq.to_magic_layout(tqw)
    np.testing.assert_array_equal(words(tm.packed), np.asarray(jm.packed))
    jx, tx = _bf16(np.random.RandomState(5).standard_normal((m, k)).astype(np.float32))
    want = jmagic_qmm(jx, jm.packed, jm.scales, jm.zeros, group_size=128, tk=jm.tile_k,
                      interpret=True)
    got = magic_qmm(tx, tm.packed, tm.scales, tm.zeros, group_size=128, tk=tm.tile_k)
    assert_within_bf16_step(got, want)


def test_new_wrappers_have_no_fallback():
    """On a tensor that is neither on the CPU nor on a CUDA device, each new
    wrapper raises: its plain version serves the CPU only."""
    _, t8 = _both(_weight(256, 64), 8, 128)
    w8 = tq.to_w8_layout(t8)
    _, std = _gptq_like(512, 128, 128)
    mq = tq.to_magic_layout(std)
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(RuntimeError, match="no kernel"):
        w8_qmm(meta(torch.zeros(2, 256, dtype=torch.bfloat16)), w8.packed, w8.scales, w8.zeros,
               group_size=128)
    with pytest.raises(RuntimeError, match="no kernel"):
        quant_matmul_pallas(meta(torch.zeros(2, 512, dtype=torch.bfloat16)), std)
    with pytest.raises(RuntimeError, match="no kernel"):
        magic_qmm(meta(torch.zeros(2, 512, dtype=torch.bfloat16)), mq.packed, mq.scales,
                  mq.zeros, group_size=128, tk=mq.tile_k)


@pytest.mark.parametrize("layout", ["w8", "std", "magic"])
def test_kernel_qmm_backward_matches_jax_grad(layout):
    """QPEFT over a w8, a std or a magic base: dx from the port's _KernelQmm
    against jax.grad of the reference's quant_matmul (w8: its custom VJP over
    the interpret kernel; std: XLA's dequant + dot; magic has no VJP in the
    reference, so the port's dx is held to g @ dense_weight^T computed
    apart). f32 activations; tolerance 1e-5 relative (XLA's jit may contract
    the w8 dequant's q8 * s - zs into one FMA)."""
    k, n, m = (512 if layout == "magic" else 256), 128, 4   # a magic tile is 4 groups
    rng = np.random.RandomState(6)
    x = rng.standard_normal((m, k)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    if layout == "std":
        jqw, tqw = _gptq_like(k, n, 128)
    else:
        jqw, tqw = _both(_weight(k, n, 7), 8 if layout == "w8" else 4, 128)
        jqw, tqw = ((jq.to_w8_layout(jqw), tq.to_w8_layout(tqw)) if layout == "w8"
                    else (jq.to_magic_layout(jqw), tq.to_magic_layout(tqw)))
    jqw = jq.QuantizedWeight(jqw.packed, jqw.scales, jqw.zeros, jqw.bits, jqw.group_size,
                             jqw.in_dim, jqw.out_dim, jnp.float32, jqw.layout, jqw.tile_k)
    tqw = tq.QuantizedWeight(tqw.packed, tqw.scales, tqw.zeros, tqw.bits, tqw.group_size,
                             tqw.in_dim, tqw.out_dim, torch.float32, tqw.layout, tqw.tile_k)
    tx = torch.from_numpy(x).requires_grad_(True)
    (tq.quant_matmul(tx, tqw) * torch.from_numpy(g)).sum().backward()
    if layout == "magic":
        want = g @ tq.dense_weight(tqw, torch.float32).numpy().T
    else:
        want = np.asarray(jax.grad(lambda a: jnp.sum(jq.quant_matmul(a, jqw) * g))(
            jnp.asarray(x)))
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_quantize_keeps_the_model_blocklist_dense():
    """ROADMAP C1: MetaModel.quantize adds the model module's own blocklist
    to the default one, at W4 and W8, per layer and at the top level. The
    stub module blocks "qformer" (a tower name not on the default list)."""
    cfg = dict(dim=256, n_layers=1, n_heads=4, multiple_of=128, vocab_size=64)
    for bits in (4, 8):
        m = MetaModel("llama", cfg, max_seq_len=32, device="cpu")
        m.module = types.SimpleNamespace(get_quant_blocklist=lambda args: ["qformer"])
        m.params["qformer_proj"] = {"weight": torch.randn(256, 256)}
        m.params["layers"][0]["qformer_adapter"] = {"weight": torch.randn(256, 128)}
        m.quantize(bits=bits)
        assert isinstance(m.params["qformer_proj"]["weight"], torch.Tensor)
        assert isinstance(m.params["layers"][0]["qformer_adapter"]["weight"], torch.Tensor)
        wq = m.params["layers"][0]["attention"]["wq"]["weight"]
        assert isinstance(wq, tq.QuantizedWeight) and wq.bits == bits
