"""The port's public signatures against the reference's, where a caller
written for the reference passes arguments by position or by the
reference's names: ``generate`` / ``stream_generate`` take ``images`` second
(ROADMAP C6), and ``models.llama.init_kv_cache`` takes ``(args, batch,
max_len, dtype, stacked, kv_dtype)`` in that order (ROADMAP C7). A tiny
model on the CPU; no JAX computation runs."""

import inspect

import pytest
import torch

from accessory_tpu import meta as jmeta
from accessory_tpu.engine import generate as jgenerate
from accessory_tpu.models import llama as jllama

from accessory_tpu_torch import meta
from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.engine import generate
from accessory_tpu_torch.models import llama

# the reference's own calls (its demos/cli.py, sphinx_api.py, eval_mm.py)
CALLS = {
    "generate": ((["a prompt"],), dict(images=None, max_gen_len=16, temperature=0.0)),
    "stream_generate": (("a prompt",), dict(images=None, max_gen_len=16, top_p=0.9)),
}


class ByteTokenizer:
    bos_id, eos_id, n_words = 256, 257, 258

    def encode(self, s, bos, eos):
        return ([self.bos_id] if bos else []) + list(s.encode()) + ([self.eos_id] if eos else [])

    def decode(self, t):
        return bytes(x for x in t if x < 256).decode("utf-8", errors="replace")


@pytest.fixture(scope="module")
def model():
    return meta.MetaModel("llama", [dict(dim=64, n_layers=1, n_heads=2, vocab_size=258,
                                         multiple_of=32)],
                          max_seq_len=64, device="cpu", tokenizer=ByteTokenizer())


@pytest.mark.parametrize("method", sorted(CALLS))
@pytest.mark.parametrize("owner", ["MetaModel", "Generator"])
def test_images_binds_second_and_raises(model, owner, method):
    """C6: the reference's calls bind against both packages' signatures with
    ``images`` second, positionally too; the port refuses a non-None
    ``images`` at the call on a model without a visual branch (llama here;
    the message names the families that take them) and runs the text path
    with None."""
    args, kw = CALLS[method]
    ref_cls = jmeta.MetaModel if owner == "MetaModel" else jgenerate.Generator
    port_cls = meta.MetaModel if owner == "MetaModel" else generate.Generator
    for cls in (ref_cls, port_cls):
        sig = inspect.signature(getattr(cls, method))
        assert list(sig.parameters)[1:3] == ["prompts" if method == "generate" else "prompt",
                                             "images"]
        bound = sig.bind(None, *args, **kw)
        assert bound.arguments["images"] is None and bound.arguments["max_gen_len"] == 16
        bound = sig.bind(None, *args, None, 16)
        assert bound.arguments["images"] is None and bound.arguments["max_gen_len"] == 16
    obj = model if owner == "MetaModel" else model.generator
    fn = getattr(obj, method)
    with pytest.raises(NotImplementedError, match="no visual branch"):
        fn(*args, images=[torch.zeros(3, 8, 8)], max_gen_len=2)
    with pytest.raises(NotImplementedError, match="no visual branch"):
        fn(*args, [torch.zeros(3, 8, 8)], 2)
    out = fn(*args, None, 2)
    text = out[0] if method == "generate" else list(out)[-1]["text"]
    assert isinstance(text, str)


ARGS = LLaMAArgs(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=32, max_seq_len=64)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_init_kv_cache_takes_the_reference_order(kv_dtype):
    """C7: ``init_kv_cache(args, batch, max_len, dtype, stacked, kv_dtype)``
    by position builds what the reference's names say: a stacked cache (one
    tensor a pool, layers leading), int8 pools with f32 scales when the
    sixth argument is "int8"; the parameter names and order match the
    reference's, ``device`` after them."""
    names = list(inspect.signature(llama.init_kv_cache).parameters)
    ref = list(inspect.signature(jllama.init_kv_cache).parameters)
    assert names[:len(ref)] == ref and names[len(ref):] == ["device"]
    args = (ARGS, 2, 48, None, True) + ((kv_dtype,) if kv_dtype else ())
    cache = llama.init_kv_cache(*args, device="cpu")
    want = torch.int8 if kv_dtype else torch.bfloat16
    assert isinstance(cache["k"], torch.Tensor) and cache["k"].dtype == want
    assert tuple(cache["k"].shape) == (2, 2, 2, 48, 16)
    assert set(cache) == ({"k", "v", "ks", "vs"} if kv_dtype else {"k", "v"})
    if kv_dtype:
        assert cache["ks"].dtype == torch.float32 and tuple(cache["ks"].shape) == (2, 2, 2, 48)
    flat = llama.init_kv_cache(ARGS, 2, 48, None, False, kv_dtype, device="cpu")
    assert isinstance(flat["k"], list) and len(flat["k"]) == 2 and flat["k"][0].dtype == want
