"""Falcon-7B's shapes on the port's paths, on the CPU, against the JAX
package: hidden 4544, 71 query heads of 64 over one KV head (multi_query),
parallel_attn, no bias (huggingface.co/tiiuae/falcon-7b config.json).

* The W4 plain products at N 4544 (dense_4h_to_h's output, 35.5
  128-column tiles; the only leaf ``quantize_params`` quantizes, since
  4544 is no multiple of the group): ``planes_qmm``'s plain version against
  JAX's ``planes_qmm`` and ``planes_qmm_bigm``'s against JAX's
  ``planes_qmm_bigm``, both in interpret mode (the JAX kernels zero-pad N to
  128), at a small K; the port's launch plans over the ragged last tile.
* One full-width layer (vocab cut to 1024, the one cut; widths as
  published), W4 from the JAX ``quantize_params`` (dense_4h_to_h alone),
  carried over by ``params_from_jax``: a 16-token prefill and 4 static-cache
  decode steps (the fused decode attention at R 71) over the bf16 and the
  int8 cache against JAX ``falcon.forward`` (its Pallas kernels in
  interpret mode).

Tolerances: the W4 products as tests/test_torch_ops.py (f32 5e-5 of the
output's scale: the same algorithm, sums in another order; bf16 1e-2 of
it, the two packages round to bf16 at other points) and row 5's bf16 as
tests/test_torch_bigm_flash.py (6e-3); the layer's bf16 logits as
tests/test_torch_zoo.py's bf16 check (3% relative L2, 0.1 absolute on
logits of magnitude ~4), int8 alike (the k / v quantized from bf16 values
that differ in their last bits can round to the neighbouring int8 step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.config import FalconArgs as JFalconArgs
from accessory_tpu.models import falcon as jfalcon
from accessory_tpu.models import llama as jllama
from accessory_tpu.ops.quant_matmul_bigm import planes_qmm_bigm as jplanes_qmm_bigm
from accessory_tpu.ops.quant_matmul_planes import planes_qmm as jplanes_qmm
from accessory_tpu.quant import qtensor as jq
from accessory_tpu.quant.quantize import DEFAULT_BLOCKLIST as JBLOCK
from accessory_tpu.quant.quantize import quantize_params as jquantize_params

from accessory_tpu_torch import convert
from accessory_tpu_torch.config import FalconArgs
from accessory_tpu_torch.convert import params_from_jax
from accessory_tpu_torch.models import falcon
from accessory_tpu_torch.ops import w4_tile
from accessory_tpu_torch.ops.quant_matmul_bigm import planes_qmm_bigm
from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm
from accessory_tpu_torch.quant.qtensor import QuantizedWeight

from test_torch_generate import one_torch_thread, to_numpy_tree  # noqa: F401

N = 4544
# one Falcon-7B layer at its published widths; the vocabulary cut to 1024
FALCON_7B_LAYER = dict(num_layers=1, hidden_size=4544, num_attention_heads=71, multi_query=True,
                       new_decoder_architecture=False, parallel_attn=True, bias=False,
                       vocab_size=1024, layer_norm_epsilon=1e-5, max_seq_len=128,
                       dtype="bfloat16")
PREFILL, STEPS = 16, 4


def _w4_pair(k, n, dtype):
    """One W4 weight quantized by the JAX package (planes layout) and carried
    into the port's folded layout (``convert``), so a test is of the product."""
    rng = np.random.RandomState(k + n)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    jqw = jq.to_planes_layout(jq.quantize_weight(jnp.asarray(w), 4, 128, jnp.dtype(dtype)))
    leaf = {f: getattr(jqw, f) for f in ("packed", "scales", "zeros", "bits", "group_size",
                                         "in_dim", "out_dim", "tile_k")}
    tqw = convert._quantized(dict(leaf, layout="planes"), getattr(torch, dtype), "cpu")
    assert tqw.layout == "folded" and tuple(tqw.packed.shape) == (k // 8, n)
    return jqw, tqw


def _close(got, want, dtype, f32_tol, bf16_tol):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    tol = f32_tol if dtype == "float32" else bf16_tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("m,dtype", [(8, "float32"), (40, "bfloat16")])
def test_w4_planes_plain_at_n4544(dtype, m):
    """planes_qmm's plain version (the path of a CPU tensor; the GEMV's rows at
    8, in f32 where the two algorithms agree to rounding, the many-row tile's
    at 40, in the card's bf16) at N 4544 against JAX's planes_qmm, which pads
    N to 4608; the tile's plan covers the 35 full tiles and the half one."""
    k = 256
    jqw, tqw = _w4_pair(k, N, dtype)
    x = np.random.RandomState(m).standard_normal((m, k)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    want = jplanes_qmm(jx, jqw.packed, jqw.scales, jqw.zeros, group_size=128, tk=jqw.tile_k,
                       interpret=True)
    got = planes_qmm(tx, tqw.packed, tqw.scales, tqw.zeros, in_dim=k, group_size=128)
    assert got.dtype == tx.dtype and got.shape == (m, N)
    _close(got, want, dtype, 5e-5, 1e-2)
    plan = w4_tile.folded_plan(512, N, 18176, 128)
    assert plan.tiles == 8 * 36 and 35 * 128 < N < plan.tiles // 8 * 128


@pytest.mark.parametrize("m", [1024])
def test_w4_bigm_plain_at_n4544(m):
    """planes_qmm_bigm's plain version at N 4544 against JAX's planes_qmm_bigm
    (interpret mode, N padded to 4608), bf16; the persistent grid's tiles
    count the half-empty last column panel."""
    k = 256
    jqw, tqw = _w4_pair(k, N, "bfloat16")
    x = np.random.RandomState(m).standard_normal((m, k)).astype(np.float32)
    want = jplanes_qmm_bigm(jnp.asarray(x, jnp.bfloat16), jqw.packed, jqw.scales, jqw.zeros,
                            group_size=128, tk=jqw.tile_k, interpret=True)
    got = planes_qmm_bigm(torch.from_numpy(x).to(torch.bfloat16), tqw.packed, tqw.scales,
                          tqw.zeros, in_dim=k, group_size=128)
    assert got.dtype == torch.bfloat16 and got.shape == (m, N)
    _close(got, want, "bfloat16", 0.0, 6e-3)
    plan = w4_tile.bigm_plan(m, N)
    assert plan.tiles == plan.tiles_m * 36 and plan.ctas == min(w4_tile.SMS, plan.tiles)
    with pytest.raises(ValueError, match="bigm_plan"):
        w4_tile.bigm_plan(m, N + 32)


@pytest.fixture(scope="module")
def layer():
    """(JAX args, JAX per-layer params, port args, port params) of one
    Falcon-7B layer in bf16, W4 by the JAX quantize_params (word_embeddings
    kept dense, ROADMAP C8)."""
    jargs, targs = JFalconArgs(**FALCON_7B_LAYER), FalconArgs(**FALCON_7B_LAYER)
    assert jargs.kv_heads == targs.kv_heads == 1 and targs.head_dim == 64
    jparams = jfalcon.init_params(jax.random.PRNGKey(0), jargs)
    jparams = jquantize_params(jparams, layout="planes",
                               blocklist=tuple(JBLOCK) + ("word_embeddings",))
    tparams = params_from_jax(to_numpy_tree(jparams), targs, device="cpu")
    return jargs, jllama.unstack_layers(jparams), targs, tparams


def test_layer_w4_leaves_are_the_quantizers(layer):
    """The JAX quantize_params quantizes one leaf of a Falcon-7B layer,
    dense_4h_to_h (in 18176, padded to 18432; N 4544), and params_from_jax
    carries it as the port's folded W4; every other projection stays bf16
    (4544 is no multiple of the group)."""
    _, _, _, tparams = layer
    mlp = tparams["layers"][0]["mlp"]
    w4 = mlp["dense_4h_to_h"]["weight"]
    assert isinstance(w4, QuantizedWeight) and w4.layout == "folded"
    assert (w4.in_dim, w4.out_dim) == (18432, N) and tuple(w4.packed.shape) == (18432 // 8, N)
    dense = {"wq": (4544, 4544), "wk": (4544, 64), "wv": (4544, 64), "dense": (4544, 4544)}
    for name, shape in dense.items():
        w = tparams["layers"][0]["self_attention"][name]["weight"]
        assert isinstance(w, torch.Tensor) and tuple(w.shape) == shape
    w = mlp["dense_h_to_4h"]["weight"]
    assert isinstance(w, torch.Tensor) and tuple(w.shape) == (4544, 18176)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_layer_static_cache_vs_jax(layer, kv_dtype):
    """A 2 x 16 prefill (flash attention at 71 / 1 heads, the slab write) and
    4 decode steps (the fused GQA decode attention at R 71 and the write of
    the new token) through the port's static cache against JAX
    falcon.forward on the same params and tokens."""
    jargs, jparams, targs, tparams = layer
    jcache = jfalcon.init_kv_cache(jargs, 2, 128, None, False, kv_dtype or "fp")
    tcache = falcon.init_kv_cache(targs, 2, 128, None, False, kv_dtype, device="cpu")
    toks = np.random.RandomState(1).randint(0, 1024, size=(2, PREFILL + STEPS))
    for lo, hi in [(0, PREFILL)] + [(p, p + 1) for p in range(PREFILL, PREFILL + STEPS)]:
        want, jcache = jfalcon.forward(jparams, jargs, jnp.asarray(toks[:, lo:hi]), cache=jcache,
                                       cur_pos=lo)
        got, _ = falcon.forward(tparams, targs, torch.from_numpy(toks[:, lo:hi]), cache=tcache,
                                cur_pos=lo)
        want, got = np.asarray(want, np.float32), got.float().numpy()
        assert got.shape == want.shape == (2, hi - lo, 1024) and np.isfinite(got).all()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 3e-2
        np.testing.assert_allclose(got, want, atol=0.1, rtol=0)
