"""Port parity, weight format: pack / unpack / quantize / dequantize are
bit-exact against accessory_tpu.quant.qtensor, and params_from_jax carries
JAX trees across (std and planes layouts, padded scale rows, stacked and
per-layer, fused and separate projections). CPU only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.config import LLaMAArgs as JArgs
from accessory_tpu.models import llama as jllama
from accessory_tpu.quant import fuse as jfuse
from accessory_tpu.quant import qtensor as jq
from accessory_tpu.quant.quantize import quantize_params as jquantize_params

from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.convert import params_from_jax
from accessory_tpu_torch.quant import qtensor as tq
from accessory_tpu_torch.quant.quantize import quantize_params


def to_numpy_tree(node):
    """JAX params pytree -> numpy tree; QuantizedWeight -> the dict of fields
    the native checkpoint stores."""
    if isinstance(node, jq.QuantizedWeight):
        return {"packed": np.asarray(node.packed), "scales": np.asarray(node.scales),
                "zeros": np.asarray(node.zeros), "bits": node.bits,
                "group_size": node.group_size, "in_dim": node.in_dim,
                "out_dim": node.out_dim, "layout": node.layout, "tile_k": node.tile_k}
    if isinstance(node, dict):
        return {k: to_numpy_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [to_numpy_tree(v) for v in node]
    return np.asarray(node)


def words(t: torch.Tensor) -> np.ndarray:
    """Port int32 word tensor -> the uint32 words the JAX package holds."""
    return t.numpy().view(np.uint32)


def test_pack_unpack_bit_exact():
    rng = np.random.RandomState(0)
    q = rng.randint(0, 16, size=(200, 48)).astype(np.int32)  # 200: a padded last word
    jp = np.asarray(jq.pack_int(jnp.asarray(q), 4))
    tp = tq.pack_int(torch.from_numpy(q), 4)
    np.testing.assert_array_equal(words(tp), jp)
    np.testing.assert_array_equal(tq.unpack_int(tp, 4, 200).numpy(),
                                  np.asarray(jq.unpack_int(jnp.asarray(jp), 4, 200)))
    np.testing.assert_array_equal(tq.unpack_int(tp, 4, 200).numpy(), q)


@pytest.mark.parametrize("dtype,pad_in_to,k", [("float32", None, 256),
                                               ("bfloat16", None, 256),
                                               ("float32", 256, 384)])
def test_quantize_dequantize_bit_exact(dtype, pad_in_to, k):
    rng = np.random.RandomState(1)
    w = rng.standard_normal((k, 96)).astype(np.float32)
    jw = jnp.asarray(w, jnp.dtype(dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jqw = jq.quantize_weight(jw, 4, 128, pad_in_to=pad_in_to)
    tqw = tq.quantize_weight(tw, 4, 128, pad_in_to=pad_in_to)
    assert (tqw.in_dim, tqw.out_dim) == (jqw.in_dim, jqw.out_dim)
    np.testing.assert_array_equal(words(tqw.packed), np.asarray(jqw.packed))
    np.testing.assert_array_equal(tqw.scales.numpy(), np.asarray(jqw.scales))
    np.testing.assert_array_equal(tqw.zeros.numpy(), np.asarray(jqw.zeros))
    np.testing.assert_array_equal(
        tq.dequantize_weight(tqw, torch.float32).numpy(),
        np.asarray(jq.dequantize_weight(jqw, jnp.float32)))
    # folded (q*s - zs) is the planes layout's dense form, also bit-exact
    np.testing.assert_array_equal(
        tq.dequantize_weight(tq.to_folded_layout(tqw), torch.float32).numpy(),
        np.asarray(jq.dense_weight(jq.to_planes_layout(jqw), jnp.float32)))


def test_w3_w8_raise_with_queue_item():
    """W8 and W3 quantize now (tests/test_torch_quant_formats.py holds them
    against the JAX package); what of W3 is still refused names its ROADMAP
    item: a GPTQ W3 tensor whose words do not hold whole groups (C3)."""
    from accessory_tpu_torch.quant.omniquant import from_gptq

    assert tq.quantize_weight(torch.zeros(128, 8), bits=8).bits == 8
    assert quantize_params({"w": torch.zeros(128, 8)}, bits=3)["w"].bits == 3
    with pytest.raises(ValueError, match="C3"):
        from_gptq(np.zeros((205, 256), np.int32), np.zeros((16, 26), np.int32),
                  np.ones((16, 256), np.float16), bits=3, device="cpu")


def _jax_model():
    args = JArgs(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=160,
                 multiple_of=128, max_seq_len=128, dtype="float32")
    return args, jllama.init_params(jax.random.PRNGKey(0), args)


def _port_args(jargs):
    return LLaMAArgs(dim=jargs.dim, n_layers=jargs.n_layers, n_heads=jargs.n_heads,
                     n_kv_heads=jargs.n_kv_heads, vocab_size=jargs.vocab_size,
                     multiple_of=jargs.multiple_of, max_seq_len=jargs.max_seq_len,
                     dtype=jargs.dtype)


def _dense_of(qw_or_arr):
    if isinstance(qw_or_arr, jq.QuantizedWeight):
        return np.asarray(jq.dense_weight(qw_or_arr, jnp.float32))
    return np.asarray(qw_or_arr, np.float32)


@pytest.mark.parametrize("layout", ["std", "planes"])
def test_params_from_jax_stacked(layout):
    jargs, params = _jax_model()
    qp = jquantize_params(params, layout=layout)
    port = params_from_jax(to_numpy_tree(qp), _port_args(jargs), device="cpu")
    assert len(port["layers"]) == 2
    for i in range(2):
        for grp, name in (("attention", "wq"), ("attention", "wv"), ("attention", "wo"),
                          ("feed_forward", "w1"), ("feed_forward", "w2")):
            jw = qp["layers"][grp][name]["weight"]
            jl = jax.tree.map(lambda x: x[i], jw)  # layer i of the stacked weight
            tw = port["layers"][i][grp][name]["weight"]
            assert isinstance(tw, tq.QuantizedWeight) and tw.layout == "folded"
            np.testing.assert_array_equal(
                tq.dequantize_weight(tw, torch.float32).numpy(),
                np.asarray(jq.dense_weight(jq.to_planes_layout(jl) if layout == "std" else jl,
                                           jnp.float32)))
        np.testing.assert_array_equal(
            port["layers"][i]["attention_norm"]["weight"].numpy(),
            np.asarray(params["layers"]["attention_norm"]["weight"][i]))
    # output head and embeddings stay dense
    np.testing.assert_array_equal(port["output"]["weight"].numpy(),
                                  np.asarray(params["output"]["weight"]))
    assert not isinstance(port["tok_embeddings"]["weight"], tq.QuantizedWeight)


def test_params_from_jax_fused_unstacked_padded_rows():
    """The JAX decode tree: fused wqkv / w13, per-layer tuples, and
    kernel_prep's scale rows padded to the sublane tile (2 -> 8 rows)."""
    jargs, params = _jax_model()
    qp = jfuse.kernel_prep(jllama.unstack_layers(jfuse.fuse_for_decode(
        jquantize_params(params, layout="planes"))))
    wqkv = qp["layers"][0]["attention"]["wqkv"]["weight"]
    assert wqkv.scales.shape[0] == 8 and wqkv.in_dim // wqkv.group_size == 2
    port = params_from_jax(to_numpy_tree(qp), _port_args(jargs), device="cpu")
    for i in range(2):
        for grp, name in (("attention", "wqkv"), ("attention", "wo"),
                          ("feed_forward", "w13"), ("feed_forward", "w2")):
            jw = qp["layers"][i][grp][name]["weight"]
            tw = port["layers"][i][grp][name]["weight"]
            assert tw.scales.shape[0] == tw.in_dim // tw.group_size
            np.testing.assert_array_equal(tq.dequantize_weight(tw, torch.float32).numpy(),
                                          _dense_of(jw))


def test_quantize_params_matches_jax_rules():
    """Same leaves quantized (blocklist, output head, pad_to rule) and the
    same folded weights as the JAX package's planes layout."""
    jargs, params = _jax_model()
    port = params_from_jax(to_numpy_tree(params), _port_args(jargs), device="cpu")
    qport = quantize_params(port)
    qjax = jquantize_params(params, layout="planes")
    for i in range(2):
        for grp, name in (("attention", "wk"), ("feed_forward", "w2")):
            tw = qport["layers"][i][grp][name]["weight"]
            jl = jax.tree.map(lambda x: x[i], qjax["layers"][grp][name]["weight"])
            assert tw.in_dim == jl.in_dim
            np.testing.assert_array_equal(tq.dequantize_weight(tw, torch.float32).numpy(),
                                          _dense_of(jl))
    assert not isinstance(qport["output"]["weight"], tq.QuantizedWeight)
    assert not isinstance(qport["layers"][0]["ffn_norm"]["weight"], tq.QuantizedWeight)
