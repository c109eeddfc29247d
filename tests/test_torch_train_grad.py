"""The port's backward pieces against the JAX package's, on the CPU.

- The W4 dequant: the port's plain version (``planes_dequant`` on a CPU
  tensor, i.e. ``dequantize_weight``: q * s, then - zs, two f32 roundings)
  against JAX ``dense_weight`` on the same planes weights, bit-equal in bf16
  and f32, and against JAX ``planes_dequant`` (the Pallas kernel in
  interpret mode) to one f32 rounding: XLA's CPU jit contracts the kernel
  body's q * s - zs into a fused multiply-add, so there a result near zero
  keeps a residual of ~1e-8 that the two-rounding form makes exactly 0.
- The differentiable W4 product (``quant.qtensor._KernelQmm``): dx against
  the JAX ``_kernel_qmm`` custom VJP (interpret-mode kernels) below and
  above 1024 rows, f32 to 1e-5 and bf16 to 1e-2 relative L2 (the forward
  products differ: planes_qmm's kernel rounds q * s; the backward's dense
  product sums in another order).
- The plain attention backward (``flash_attention_bwd_plain`` over the lse
  of ``attention_lse``) against ``jax.grad`` of ``ops/attention.py::attention``
  with GQA, a ragged length and head_dim 64 / 128: f32 to 1e-5, bf16
  inputs to 2e-2 relative L2 (the two round P and dS to bf16 at other points).
Inputs are made from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.ops.attention import attention as jattention
from accessory_tpu.ops.quant_matmul_bigm import planes_dequant as jplanes_dequant
from accessory_tpu.quant.qtensor import dense_weight as jdense_weight
from accessory_tpu.quant.qtensor import quant_matmul as jquant_matmul
from accessory_tpu.quant.qtensor import quantize_weight as jquantize_weight
from accessory_tpu.quant.qtensor import to_planes_layout

from accessory_tpu_torch.convert import _quantized
from accessory_tpu_torch.ops.flash_attention import (attention_lse, flash_attention,
                                                     flash_attention_bwd_plain)
from accessory_tpu_torch.ops.quant_matmul_bigm import planes_dequant
from accessory_tpu_torch.quant.qtensor import dense_weight, quant_matmul

from test_torch_generate import to_numpy_tree


def _weights(k, n, gs, act_dtype, seed=0):
    """One planes W4 weight on the JAX side and its folded port twin."""
    rng = np.random.RandomState(seed)
    w = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5)
    jqw = to_planes_layout(jquantize_weight(w, bits=4, group_size=gs, act_dtype=act_dtype))
    leaf = to_numpy_tree({"w": jqw})["w"]
    return jqw, _quantized(leaf, {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        jnp.dtype(act_dtype).name], "cpu")


def _np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("k,n,gs", [(256, 128, 64), (512, 384, 128), (1024, 256, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dequant_bit_equal_to_jax(k, n, gs, dtype):
    jqw, qw = _weights(k, n, gs, jnp.bfloat16)
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    got = planes_dequant(qw.packed, qw.scales, qw.zeros, in_dim=k, group_size=gs, dtype=tdt)
    kern = jplanes_dequant(jqw.packed, jqw.scales, jqw.zeros, group_size=gs, tk=jqw.tile_k,
                           dtype=jnp.dtype(dtype), interpret=True)
    xla = jdense_weight(jqw, jnp.dtype(dtype))
    g = got.to(torch.float32).numpy()
    assert got.dtype == tdt and got.shape == (k, n)
    assert np.array_equal(g, _np32(xla))
    kern = _np32(kern)
    assert np.all(np.abs(g - kern) <= 2.0 ** -22 * np.abs(kern).max()
                  + (2.0 ** -8 * np.abs(kern) if dtype == "bfloat16" else 0.0))
    assert torch.equal(dense_weight(qw, tdt), got)


@pytest.mark.parametrize("m", [64, 1100])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_w4_product_backward_matches_the_custom_vjp(m, act):
    k, n, gs = 256, 128, 64
    jqw, qw = _weights(k, n, gs, jnp.dtype(act), seed=1)
    rng = np.random.RandomState(2)
    x = rng.standard_normal((m, k)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    jx, jg = jnp.asarray(x, act), jnp.asarray(g, act)
    jy, vjp = jax.vjp(lambda xx: jquant_matmul(xx, jqw), jx)
    (jdx,) = vjp(jg)

    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[act]
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = quant_matmul(tx, qw)
    y.backward(torch.from_numpy(g).to(tdt))
    tol = 1e-5 if act == "float32" else 1e-2
    for got, want in ((y.detach(), jy), (tx.grad, jdx)):
        got, want = got.to(torch.float32).numpy(), _np32(want)
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)
    # the backward gives nothing to the weight's arrays
    assert not qw.packed.requires_grad and qw.scales.grad is None


def test_w4_product_backward_narrow_x():
    """x narrower than a padded in_dim: dx takes the first columns of W^T."""
    _, qw = _weights(256, 64, 64, jnp.float32, seed=3)
    x = torch.randn(8, 200, generator=torch.Generator().manual_seed(0), requires_grad=True)
    g = torch.randn(8, 64, generator=torch.Generator().manual_seed(1))
    quant_matmul(x, qw).backward(g)
    want = g @ dense_weight(qw, torch.float32)[:200].T
    assert x.grad.shape == (8, 200) and torch.allclose(x.grad, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [1, 37, 64])
@pytest.mark.parametrize("hd,nq,nkv", [(64, 4, 2), (64, 4, 4), (128, 8, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_backward_matches_jax_grad(s, hd, nq, nkv, dtype):
    rng = np.random.RandomState(s + hd + nq)
    b = 2
    q = rng.standard_normal((b, s, nq, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, nkv, hd)).astype(np.float32)
    do = rng.standard_normal((b, s, nq, hd)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jout, vjp = jax.vjp(lambda a, bb, c: jattention(a, bb, c, causal=True), jq, jk, jv)
    jgrads = vjp(jdo)

    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    out = flash_attention(tq, tk, tv)
    lse = attention_lse(tq, tk)
    got = flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, g, w in zip(("out", "dq", "dk", "dv"), (out,) + tuple(got), (jout,) + jgrads):
        g, w = g.to(torch.float32).numpy(), _np32(w)
        assert g.shape == w.shape, name
        # s = 1: one key per query, so dq is 0 in exact arithmetic and
        # ~1e-7 an element in f32
        assert np.linalg.norm(g - w) <= tol * np.linalg.norm(w) + 1e-6 * np.sqrt(g.size), name


def test_flash_attention_is_differentiable_on_the_cpu():
    """autograd through ``flash_attention`` (the plain versions on the CPU)
    gives the gradients of the plain grouped attention."""
    from accessory_tpu_torch.ops.attention import grouped_attention

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 19, h, 64, generator=gen, dtype=torch.float32)
               for h in (8, 2, 2))
    do = torch.randn(2, 19, 8, 64, generator=gen)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    r = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*a).backward(do)
    grouped_attention(*r, causal=True).backward(do)
    for x, y in zip(a, r):
        assert torch.allclose(x.grad, y.grad, rtol=1e-4, atol=1e-5)
