"""Port parity, text through the static-cache paths: the Generator on the
stacked-cache path (``unroll_decode=False``) and ``stream_generate``, against
the JAX Generator on the model of test_torch_static_paths.py, with the float
and the int8 cache: identical greedy text. CPU only.
"""

import pytest

from accessory_tpu.engine.generate import Generator as JGenerator
from accessory_tpu.models import llama as jllama
from accessory_tpu.tokenizer import Tokenizer as JTokenizer

from accessory_tpu_torch.engine.generate import Generator
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.tokenizer import Tokenizer

from test_torch_generate import tok_path  # noqa: F401  (fixture)
from test_torch_static_paths import models_f32  # noqa: F401  (fixture)


@pytest.fixture(scope="module", params=["fp", "int8"])
def stacked_generators(request, models_f32, tok_path):  # noqa: F811
    jargs, jparams, targs, tparams = models_f32
    jgen = JGenerator(jllama, jargs, jparams, JTokenizer(tok_path), unroll_decode=False,
                      kv_dtype=request.param)
    tgen = Generator(llama, targs, tparams, Tokenizer(tok_path), kv_dtype=request.param,
                     device="cpu", unroll_decode=False)
    return jgen, tgen


def test_stacked_generator_greedy_text_identical(stacked_generators):
    """Generator(unroll_decode=False): no fused weights, a stacked cache;
    greedy text identical to the JAX Generator's on the same path."""
    jgen, tgen = stacked_generators
    assert "wq" in tgen.params["layers"][0]["attention"] and not tgen.unroll_decode
    prompts = ["the quick brown fox jumps over the lazy", "hi", "hello world this"]
    want = jgen.generate(prompts, max_gen_len=70)
    got = tgen.generate(prompts, max_gen_len=70)
    assert got == want and any(len(t) > 0 for t in got)
    assert tgen.last_decode_steps > 0


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_stream_generate_identical(models_f32, tok_path, kv_dtype):  # noqa: F811
    """stream_generate on the unrolled path: every yielded dict equals the JAX
    Generator's, the last carries end_of_content, and the streamed text is
    what generate returns for the same prompt; a stop string cuts the stream
    where it cuts the JAX package's."""
    jargs, jparams, targs, tparams = models_f32
    jgen = JGenerator(jllama, jargs, jparams, JTokenizer(tok_path), unroll_decode=True,
                      kv_dtype=kv_dtype)
    tgen = Generator(llama, targs, tparams, Tokenizer(tok_path), kv_dtype=kv_dtype, device="cpu")
    want = list(jgen.stream_generate("the quick brown", max_gen_len=40))
    got = list(tgen.stream_generate("the quick brown", max_gen_len=40))
    assert got == want and got[-1]["end_of_content"] and len(got) > 2
    assert all(not d["end_of_content"] for d in got[:-1])
    assert got[-1]["text"] == tgen.generate(["the quick brown"], max_gen_len=40)[0]
    words = got[-1]["text"].split()
    stop = words[len(words) // 2]
    want = list(jgen.stream_generate("the quick brown", max_gen_len=40,
                                     additional_stop_symbols=(stop,)))
    got = list(tgen.stream_generate("the quick brown", max_gen_len=40,
                                    additional_stop_symbols=(stop,)))
    assert got == want and got[-1]["end_of_content"] and stop not in got[-1]["text"]
