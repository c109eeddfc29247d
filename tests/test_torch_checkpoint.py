"""Port parity, checkpoints: the native format both packages share.

A checkpoint written by the JAX package's ``save_pretrained`` (dense, W4 std,
W4 planes, and the fused / retiled decode form) loads through the port's
``from_pretrained`` and gives the JAX package's logits and greedy text; one
written by the port loads in the JAX package. The port's numpy-only
safetensors reader and writer are held against the ``safetensors`` library.
CPU only; tolerances are stated at each test.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.checkpoint import load_checkpoint as jload_checkpoint
from accessory_tpu.checkpoint import save_checkpoint as jsave_checkpoint
from accessory_tpu.meta import MetaModel as JMetaModel
from accessory_tpu.models import llama as jllama
from accessory_tpu.quant import qtensor as jq
from accessory_tpu.quant.fuse import fuse_for_decode as jfuse
from accessory_tpu.quant.quantize import quantize_params as jquantize_params

from accessory_tpu_torch.checkpoint import (flatten_params, load_checkpoint,
                                            load_checkpoint_list, read_safetensors,
                                            save_checkpoint, stream_checkpoint,
                                            write_safetensors)
from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.convert import BF16Bits
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.quant import qtensor as tq
from accessory_tpu_torch.quant.quantize import quantize_params

from test_torch_generate import tok_path  # noqa: F401  (fixture)

CFG = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, multiple_of=128)


# ---------------------------------------------------------------- the container


def _sample_tensors():
    rng = np.random.RandomState(0)
    return {
        "a/weight": rng.standard_normal((3, 5)).astype(np.float32),
        "a/half": rng.standard_normal((4,)).astype(np.float16),
        "b#packed": rng.randint(0, 2 ** 32, (7, 2), dtype=np.uint64).astype(np.uint32),
        "b@bf16": rng.randint(0, 2 ** 16, (2, 3, 4)).astype(np.uint16),
        "c/int8": rng.randint(-128, 128, (9,)).astype(np.int8),
        "c/i64": np.arange(6, dtype=np.int64).reshape(2, 3),
        "scalar": np.array(2.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
        "flag": np.array([True, False, True]),
    }


def test_numpy_reader_agrees_with_safetensors(tmp_path):
    """A file written by the safetensors library: the port's numpy reader
    gives every tensor with the same dtype, shape and bytes."""
    from safetensors.numpy import load_file, save_file

    tensors = _sample_tensors()
    path = str(tmp_path / "lib.safetensors")
    save_file(tensors, path)
    want, got = load_file(path), read_safetensors(path)
    assert set(got) == set(want) == set(tensors)
    for name in want:
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape
        np.testing.assert_array_equal(np.asarray(got[name]), want[name])


def test_numpy_writer_loads_with_safetensors(tmp_path):
    """A file written by the port's numpy writer loads with the safetensors
    library and with the port's own reader, tensor for tensor."""
    from safetensors.numpy import load_file

    tensors = _sample_tensors()
    path = str(tmp_path / "port.safetensors")
    write_safetensors(path, tensors)
    for got in (load_file(path), read_safetensors(path)):
        assert set(got) == set(tensors)
        for name, want in tensors.items():
            assert got[name].dtype == want.dtype and got[name].shape == want.shape
            np.testing.assert_array_equal(np.asarray(got[name]), want)


def test_reader_takes_torch_bf16_files(tmp_path):
    """A safetensors file with a true BF16 tensor (torch's writer): the raw
    bits come back as uint16."""
    from safetensors.torch import save_file

    t = torch.randn(4, 6).to(torch.bfloat16)
    save_file({"w": t}, str(tmp_path / "t.safetensors"))
    got = read_safetensors(str(tmp_path / "t.safetensors"))["w"]
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(np.asarray(got), t.view(torch.int16).numpy().view(np.uint16))


# ---------------------------------------------------------------- JAX writes, the port reads


def _jax_model(tok_path, kind, dtype="float32", seed=0):
    """A 2-layer GQA JAX MetaModel: dense, W4 std (what its quantize() gives
    off the TPU), W4 planes, or the fused + retiled + scale-padded decode form
    of the planes weights."""
    model = JMetaModel("llama", dict(CFG, dtype=dtype), tok_path, max_seq_len=128, seed=seed)
    if kind == "std":
        model.quantize()
    elif kind in ("planes", "fused"):
        model.params = jquantize_params(model.params, layout="planes")
    if kind == "fused":
        model.params = jfuse(model.params)
    return model


def _both_logits(jmodel, tmodel, steps=3):
    """A 64-token prefill and ``steps`` decode steps through both packages'
    forwards on the params each MetaModel holds (the JAX side unrolled, its
    kernels in interpret mode)."""
    from accessory_tpu_torch.quant.fuse import fuse_for_decode

    rng = np.random.RandomState(0)
    toks = rng.randint(0, jmodel.args.vocab_size, size=(2, 64 + steps))
    jparams = jllama.unstack_layers(jfuse(jmodel.params))
    tparams = fuse_for_decode(tmodel.params)
    jcache = jllama.init_kv_cache(jmodel.args, 2, max_len=128, stacked=False, kv_dtype="fp")
    tcache = llama.init_kv_cache(tmodel.args, 2, 128, device="cpu")
    pairs = []
    for lo, hi in [(0, 64)] + [(p, p + 1) for p in range(64, 64 + steps)]:
        jl, jcache = jllama.forward(jparams, jmodel.args, jnp.asarray(toks[:, lo:hi]),
                                    cache=jcache, cur_pos=lo)
        tl, _ = llama.forward(tparams, tmodel.args, torch.from_numpy(toks[:, lo:hi]),
                              cache=tcache, cur_pos=lo)
        pairs.append((np.asarray(jl), tl.numpy()))
    return pairs


@pytest.mark.parametrize("kind", ["dense", "std", "planes", "fused"])
def test_jax_checkpoint_loads_through_from_pretrained(tmp_path, tok_path, kind):  # noqa: F811
    """save_pretrained by the JAX package, from_pretrained by the port
    (meta.json, config.json and the tokenizer probed from the directory): f32
    logits to 1e-3 (each op agrees to ~1e-5, carried through two layers, as in
    test_torch_generate) and identical greedy text."""
    jmodel = _jax_model(tok_path, kind)
    jmodel.save_pretrained(str(tmp_path))
    tmodel = MetaModel.from_pretrained(str(tmp_path), max_seq_len=128, dtype="float32",
                                       device="cpu")
    assert tmodel.llama_type == "llama" and tmodel.args.n_kv_heads == 2
    assert tmodel.tokenizer.n_words == jmodel.tokenizer.n_words == tmodel.args.vocab_size
    wq = tmodel.params["layers"][1]["attention"]["wqkv" if kind == "fused" else "wq"]["weight"]
    if kind == "dense":
        assert isinstance(wq, torch.Tensor) and wq.dtype == torch.float32
    else:
        assert isinstance(wq, tq.QuantizedWeight) and wq.layout == "folded"
        assert wq.act_dtype == torch.float32 and wq.scales.shape[0] == 256 // 128
    for want, got in _both_logits(jmodel, tmodel):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    prompts = ["the quick brown", "hello world"]
    assert tmodel.generate(prompts, max_gen_len=24) == jmodel.generate(prompts, max_gen_len=24)


@pytest.mark.parametrize("kind", ["planes", "fused"])
def test_jax_checkpoint_with_bf16_scales(tmp_path, tok_path, kind, monkeypatch):  # noqa: F811
    """The JAX package may store a planes weight's scales and folded zeros as
    bf16 (ACCESSORY_SCALES_DTYPE): the file holds them stacked over the layers
    under ``#scales@bf16``, the port reads them as f32 with the same values,
    and its f32 logits agree with the JAX package's to 1e-3 (as above: both
    sides compute with the same bf16-rounded scales) with identical text."""
    monkeypatch.setenv("ACCESSORY_SCALES_DTYPE", "bfloat16")
    jmodel = _jax_model(tok_path, kind)
    jmodel.save_pretrained(str(tmp_path))
    name = "wqkv" if kind == "fused" else "wq"
    jw = jmodel.params["layers"]["attention"][name]["weight"]
    assert jw.scales.dtype == jnp.bfloat16 and jw.scales.ndim == 3
    raw = read_safetensors(str(tmp_path / "weights.safetensors"))
    assert raw[f"layers/attention/{name}/weight#scales@bf16"].dtype == np.uint16
    tmodel = MetaModel.from_pretrained(str(tmp_path), max_seq_len=128, dtype="float32",
                                       device="cpu")
    tw = tmodel.params["layers"][1]["attention"][name]["weight"]
    assert tw.scales.dtype == tw.zeros.dtype == torch.float32
    rows = tw.in_dim // tw.group_size
    np.testing.assert_array_equal(tw.scales.numpy(),
                                  np.asarray(jw.scales[1, :rows].astype(jnp.float32)))
    np.testing.assert_array_equal(tw.zeros.numpy(),
                                  np.asarray(jw.zeros[1, :rows].astype(jnp.float32)))
    for want, got in _both_logits(jmodel, tmodel):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    prompts = ["the quick brown", "hello world"]
    assert tmodel.generate(prompts, max_gen_len=24) == jmodel.generate(prompts, max_gen_len=24)


def test_from_pretrained_options(tmp_path, tok_path):  # noqa: F811
    """A dense checkpoint with quant=True is quantized after loading (the
    weights quantize_params gives); an already quantized one is not quantized
    again; kv_dtype reaches the Generator; dtype casts the dense leaves;
    llama_type / tokenizer_path may be given instead of probed."""
    jmodel = _jax_model(tok_path, "dense")
    jmodel.save_pretrained(str(tmp_path / "dense"))
    m = MetaModel.from_pretrained(str(tmp_path / "dense"), max_seq_len=128, quant=True,
                                  kv_dtype="int8", dtype="float32", device="cpu")
    dense = MetaModel.from_pretrained(str(tmp_path / "dense"), llama_type="llama",
                                      tokenizer_path=tok_path, max_seq_len=128, device="cpu")
    assert dense.params["norm"]["weight"].dtype == torch.bfloat16      # the default cast
    assert dense.kv_dtype is None
    want = quantize_params(MetaModel.from_pretrained(
        str(tmp_path / "dense"), max_seq_len=128, dtype="float32", device="cpu").params)
    got_w = m.params["layers"][0]["feed_forward"]["w2"]["weight"]
    want_w = want["layers"][0]["feed_forward"]["w2"]["weight"]
    assert isinstance(got_w, tq.QuantizedWeight) and torch.equal(got_w.packed, want_w.packed)
    assert m.generator.kv_dtype == "int8"
    m.save_pretrained(str(tmp_path / "w4"))
    again = MetaModel.from_pretrained(str(tmp_path / "w4"), max_seq_len=128, quant=True,
                                      dtype="float32", device="cpu")
    again_w = again.params["layers"][0]["feed_forward"]["w2"]["weight"]
    assert torch.equal(again_w.packed, got_w.packed) and torch.equal(again_w.zeros, got_w.zeros)
    # a tokenizer object takes the place of the probed file; config.json keeps its vocab_size
    (tmp_path / "bare").mkdir()                          # a directory with no tokenizer file
    for f in ("weights.safetensors", "quant.json", "config.json", "meta.json"):
        (tmp_path / "bare" / f).write_bytes((tmp_path / "w4" / f).read_bytes())
    stub = object()
    bare = MetaModel.from_pretrained(str(tmp_path / "bare"), max_seq_len=128, device="cpu",
                                     tokenizer=stub)
    assert bare.tokenizer is stub and bare.args.vocab_size == m.args.vocab_size


# ---------------------------------------------------------------- the port writes


def _port_model(tok_path, dtype="float32", quantize=True):
    model = MetaModel("llama", dict(CFG, dtype=dtype), tok_path, max_seq_len=128, seed=5,
                      device="cpu")
    return model.quantize() if quantize else model


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, node


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_round_trip_is_exact(tmp_path, tok_path, dtype):  # noqa: F811
    """What survives save_pretrained -> from_pretrained in the port:
    everything, bit for bit. Dense leaves keep dtype and bits; a W4 leaf goes
    out in the JAX package's planes layout (its packed words re-ordered, its
    folded zeros as they are) and comes back with the same packed words,
    scales and zeros; config, llama_type and the tokenizer come back too."""
    model = _port_model(tok_path, dtype)
    model.save_pretrained(str(tmp_path))
    meta = json.loads((tmp_path / "quant.json").read_text())
    assert meta["layers/attention/wq/weight"]["layout"] == "planes"
    assert meta["layers/attention/wq/weight"]["tile_k"] == 256
    back = MetaModel.from_pretrained(str(tmp_path), max_seq_len=128, dtype=dtype, device="cpu")
    assert back.args == model.args and back.tokenizer.n_words == model.tokenizer.n_words
    want, got = dict(_leaves(model.params)), dict(_leaves(back.params))
    assert set(got) == set(want) and len(want) > 10
    for path, w in want.items():
        g = got[path]
        if isinstance(w, tq.QuantizedWeight):
            assert (g.layout, g.in_dim, g.out_dim, g.group_size, g.act_dtype) == \
                (w.layout, w.in_dim, w.out_dim, w.group_size, w.act_dtype)
            assert torch.equal(g.packed, w.packed) and torch.equal(g.scales, w.scales)
            assert torch.equal(g.zeros, w.zeros)
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), path


def test_port_checkpoint_loads_in_jax(tmp_path, tok_path):  # noqa: F811
    """A W4 checkpoint written by the port loads in the JAX package, through
    load_checkpoint and through its from_pretrained: planes-layout leaves with
    the port's exact q, scales and folded zeros. Its f32 logits agree with the
    port's to 1e-3, the W4 tolerance of test_torch_generate (the same
    dequantized weights, each op to ~1e-5), and greedy text is identical."""
    model = _port_model(tok_path)
    model.save_pretrained(str(tmp_path))
    jparams = jload_checkpoint(str(tmp_path))
    jw = jparams["layers"]["attention"]["wq"]["weight"]
    assert isinstance(jw, jq.QuantizedWeight) and jw.layout == "planes" and jw.tile_k == 256
    assert jw.packed.shape == (2, 256 // 8, 256)               # stacked over the layers
    tw = model.params["layers"][1]["attention"]["wq"]["weight"]
    np.testing.assert_array_equal(
        np.asarray(jq.dense_weight(jax.tree.map(lambda x: x[1], jw), jnp.float32)),
        tq.dequantize_weight(tw, torch.float32).numpy())
    jmodel = JMetaModel.from_pretrained(str(tmp_path), max_seq_len=128, dtype="float32")
    assert jmodel.args.n_kv_heads == 2 and jmodel.tokenizer.n_words == model.tokenizer.n_words
    for want, got in _both_logits(jmodel, model):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    prompts = ["the quick brown", "hello world"]
    assert jmodel.generate(prompts, max_gen_len=24) == model.generate(prompts, max_gen_len=24)


def test_save_without_planes_tile_recovers_std_zeros(tmp_path):
    """A folded W4 leaf whose in_dim admits no planes k-tile (128 at group
    size 128) goes out in the std layout, its integer zeros recovered by
    rounding zs / scales: the same integers, so the JAX package's dequantized
    weight is the std weight's, and the port's reload agrees with the folded
    original to f32 rounding of zeros * scales."""
    rng = np.random.RandomState(1)
    w = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32) * 0.05)
    std = tq.quantize_weight(w, 4, 128, torch.float32)
    params = {"layers": [{"proj": {"weight": tq.to_folded_layout(std)}}]}
    save_checkpoint(str(tmp_path), params)
    meta = json.loads((tmp_path / "quant.json").read_text())["layers/proj/weight"]
    assert meta["layout"] == "std" and meta["tile_k"] == 0
    jw = jload_checkpoint(str(tmp_path))["layers"]["proj"]["weight"]
    np.testing.assert_array_equal(np.asarray(jw.zeros)[0], std.zeros.numpy())
    np.testing.assert_array_equal(np.asarray(jq.dequantize_weight(
        jax.tree.map(lambda x: x[0], jw), jnp.float32)),
        tq.dequantize_weight(std, torch.float32).numpy())
    args = LLaMAArgs(dim=128, n_layers=1, n_heads=2, vocab_size=8, dtype="float32")
    back = load_checkpoint(str(tmp_path), args, device="cpu")["layers"][0]["proj"]["weight"]
    assert back.layout == "folded" and torch.equal(back.packed, std.packed)
    assert torch.equal(back.zeros, std.zeros * std.scales)


# ---------------------------------------------------------------- lists, streaming, refusals


def test_checkpoint_list_overrides_and_adds(tmp_path, tok_path):  # noqa: F811
    """Two native directories in order: a leaf of the second overrides the
    first's, a leaf only the second holds is added, the rest comes from the
    first; a dense leaf replaces a quantized one of the same path; ``dtype``
    casts dense floating leaves only; ``template_params`` supplies leaves no
    checkpoint holds."""
    base = _port_model(tok_path)
    base.save_pretrained(str(tmp_path / "base"))
    args = base.args
    extra = {"norm": {"weight": base.params["norm"]["weight"] * 2},
             "layers": [{"attention": {"wq": {"bias": torch.full((256,), float(i + 1)),
                                              "weight": torch.ones(256, 256) * (i + 1)}}}
                        for i in range(2)]}
    save_checkpoint(str(tmp_path / "extra"), extra)
    got = load_checkpoint_list([str(tmp_path / "base"), str(tmp_path / "extra")], args=args,
                               device="cpu")
    assert torch.equal(got["norm"]["weight"], extra["norm"]["weight"])
    wq1 = got["layers"][1]["attention"]["wq"]
    assert torch.equal(wq1["bias"], torch.full((256,), 2.0))
    assert isinstance(wq1["weight"], torch.Tensor) and torch.equal(wq1["weight"],
                                                                   torch.ones(256, 256) * 2)
    wk = got["layers"][1]["attention"]["wk"]["weight"]
    assert torch.equal(wk.packed, base.params["layers"][1]["attention"]["wk"]["weight"].packed)
    assert torch.equal(got["output"]["weight"], base.params["output"]["weight"])
    # the other order: the base's quantized wq replaces the dense one, the bias stays
    rev = load_checkpoint_list([str(tmp_path / "extra"), str(tmp_path / "base")], args=args,
                               device="cpu")
    assert isinstance(rev["layers"][0]["attention"]["wq"]["weight"], tq.QuantizedWeight)
    assert torch.equal(rev["layers"][0]["attention"]["wq"]["bias"], torch.full((256,), 1.0))
    assert torch.equal(rev["norm"]["weight"], base.params["norm"]["weight"])
    cast = load_checkpoint_list([str(tmp_path / "base")], dtype="bfloat16", args=args,
                                device="cpu")
    assert cast["tok_embeddings"]["weight"].dtype == torch.bfloat16
    assert cast["layers"][0]["attention"]["wk"]["weight"].scales.dtype == torch.float32
    only = load_checkpoint_list([str(tmp_path / "extra")], template_params=base.params,
                                args=args, device="cpu")
    assert torch.equal(only["norm"]["weight"], extra["norm"]["weight"])
    assert only["output"]["weight"] is base.params["output"]["weight"]
    assert only["layers"][0]["feed_forward"] is base.params["layers"][0]["feed_forward"]
    assert torch.equal(only["layers"][0]["attention"]["wq"]["bias"], torch.full((256,), 1.0))


def test_save_filter_flatten_and_stream(tmp_path, tok_path):  # noqa: F811
    """flatten_params gives the checkpoint's keys (layers stacked, quantized
    parts #-suffixed); save_checkpoint's filter keeps a subset; stream_checkpoint
    yields one tensor at a time, bf16 leaves as BF16Bits under their plain
    path, and hands each to device_put_fn."""
    model = _port_model(tok_path, "bfloat16")
    flat = flatten_params(model.params)
    assert flat["layers/attention/wq/weight#packed"].shape == (2, 32, 256)
    assert flat["layers/attention/wq/weight#meta"]["layout"] == "planes"
    assert isinstance(flat["layers/attention_norm/weight"], BF16Bits)
    assert flat["layers/attention_norm/weight"].shape == (2, 256)
    save_checkpoint(str(tmp_path), model.params, filter=lambda path: "norm" in path)
    seen = []
    got = dict(stream_checkpoint(str(tmp_path),
                                 device_put_fn=lambda k, a: (seen.append(k), a)[1]))
    assert sorted(got) == sorted(seen) == ["layers/attention_norm/weight",
                                           "layers/ffn_norm/weight", "norm/weight"]
    assert all(isinstance(v, BF16Bits) for v in got.values())
    assert json.loads((tmp_path / "quant.json").read_text()) == {}
    raw = read_safetensors(str(tmp_path / "weights.safetensors"))
    assert sorted(raw) == [k + "@bf16" for k in sorted(got)]


def test_unported_checkpoints_raise(tmp_path, tok_path):  # noqa: F811
    """A directory of PyTorch consolidated.* files names ROADMAP A6; a W8 leaf
    names its queue item (B10); a directory without weights is a
    FileNotFoundError; from_pretrained without a tokenizer says so."""
    args = LLaMAArgs(**CFG, vocab_size=32, dtype="float32")
    ref = tmp_path / "ref"
    ref.mkdir()
    (ref / "consolidated.00-of-01.model.pth").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="A6"):
        load_checkpoint_list([str(ref)], args=args, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_checkpoint_list([str(tmp_path / "nothing")], args=args, device="cpu")
    jmodel = _jax_model(tok_path, "dense")
    w8 = jquantize_params(jmodel.params, bits=8, layout="std")
    jsave_checkpoint(str(tmp_path / "w8"), w8)
    with pytest.raises(NotImplementedError, match="B10"):
        load_checkpoint(str(tmp_path / "w8"), args, device="cpu")
    jsave_checkpoint(str(tmp_path / "bare"), jmodel.params)
    with pytest.raises(FileNotFoundError, match="tokenizer"):
        MetaModel.from_pretrained(str(tmp_path / "bare"), llama_type="llama", device="cpu")
