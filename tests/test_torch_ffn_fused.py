"""Port parity, the fused W4 decode FFN (ops/ffn_fused.py): the plain
PyTorch version (the path a CPU tensor takes through ``ffn_qmm``) against
the JAX ``ffn_qmm`` in interpret mode on the same numpy inputs, at
tests/test_ffn_fused.py's shapes and with its weights (``_q``) carried over
by ``convert.params_from_jax``; the norm prologue against JAX's ``rms_norm``
followed by ``ffn_qmm``; ``ffn_fusible`` against the reference's predicate;
and a 2-layer model whose decode steps take the fused FFN
(``forward(ffn_fuse=True)``) against the JAX forward and the port's unfused
route. CPU only.

Tolerances: f32 1e-4 (the port's W4 products are within 5e-5 of the planes
kernel's, tests/test_torch_ops.py); bf16 test_torch_ops.py's W4 bound
(1.5e-2 of the output's scale: the two packages round to bf16 at other
points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.config import LLaMAArgs as JArgs
from accessory_tpu.engine.generate import Generator as JGenerator
from accessory_tpu.models import llama as jllama
from accessory_tpu.ops import ffn_fused as jffn
from accessory_tpu.ops import norms as jnorms
from accessory_tpu.quant.quantize import quantize_params as jquantize_params

from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.convert import params_from_jax
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.ops import ffn_fused as tffn
from accessory_tpu_torch.quant.fuse import fuse_for_decode
from accessory_tpu_torch.quant.qtensor import (quantize_weight, to_folded_layout,
                                               to_magic_layout, to_w8_layout)
from accessory_tpu_torch.quant.quantize import quantize_params

from test_ffn_fused import GS, _q
from test_torch_generate import to_numpy_tree
from test_torch_ops import assert_close, both

# tests/test_ffn_fused.py's two shapes: (k, ffn, n2, tk1, tk2)
SHAPES = [(256, 512, 256, 256, 512), (512, 512, 512, 256, 256)]


def _port_pair(jw13, jw2, dtype="float32"):
    """The JAX planes weights as the port's folded ones, through
    params_from_jax (a one-layer tree holding just the FFN)."""
    tree = {"layers": [{"feed_forward": {"w13": {"weight": to_numpy_tree(jw13)},
                                         "w2": {"weight": to_numpy_tree(jw2)}}}]}
    args = LLaMAArgs(dim=jw13.in_dim, n_layers=1, dtype=dtype)
    ff = params_from_jax(tree, args, device="cpu")["layers"][0]["feed_forward"]
    return ff["w13"]["weight"], ff["w2"]["weight"]


def _weights(k, ffn, n2, tk1, tk2):
    rng = np.random.RandomState(0)
    jw13, jw2 = _q(rng, k, 2 * ffn, tk1), _q(rng, ffn, n2, tk2)
    return rng, (jw13, jw2), _port_pair(jw13, jw2)


def _jax_ffn(jx, jw13, jw2, res):
    return jffn.ffn_qmm(jx, jw13.packed, jw13.scales, jw13.zeros, jw2.packed, jw2.scales,
                        jw2.zeros, residual=res, group_size=GS, tk1=jw13.tile_k,
                        tk2=jw2.tile_k, interpret=True)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_ffn_qmm_plain_matches_jax(shape, residual):
    k, ffn, n2, tk1, tk2 = shape
    rng, (jw13, jw2), (tw13, tw2) = _weights(*shape)
    assert tw13.layout == tw2.layout == "folded"
    jx, tx = both(rng.standard_normal((8, k)), "float32")
    jres, tres = both(rng.standard_normal((8, n2)), "float32") if residual else (None, None)
    want = _jax_ffn(jx, jw13, jw2, jres)
    got = tffn.ffn_qmm(tx, tw13, tw2, residual=tres)
    assert got.dtype == torch.float32 and got.shape == (8, n2)
    assert_close(got, want, "float32", f32_tol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_prologue_matches_jax_rms_norm_then_ffn(dtype):
    """The port folds the RMSNorm into the call; the reference runs rms_norm
    first and hands the normalized rows to ffn_qmm."""
    k, ffn, n2, tk1, tk2 = SHAPES[1]
    rng, (jw13, jw2), (tw13, tw2) = _weights(*SHAPES[1])
    jx, tx = both(rng.standard_normal((5, k)) * 3, dtype)
    jnw, tnw = both(1 + 0.1 * rng.standard_normal(k), "float32")
    jres, tres = both(rng.standard_normal((5, n2)), dtype)
    want = _jax_ffn(jnorms.rms_norm(jx, jnw, 1e-5), jw13, jw2, jres)
    got = tffn.ffn_qmm(tx, tw13, tw2, residual=tres, norm_weight=tnw, norm_eps=1e-5)
    assert got.dtype == tx.dtype
    assert_close(got, want, dtype, f32_tol=1e-4)


def test_ffn_qmm_plain_bf16_matches_jax():
    k, ffn, n2, tk1, tk2 = SHAPES[0]
    rng, (jw13, jw2), (tw13, tw2) = _weights(*SHAPES[0])
    jx, tx = both(rng.standard_normal((8, k)), "bfloat16")
    jres, tres = both(rng.standard_normal((8, n2)), "bfloat16")
    assert_close(tffn.ffn_qmm(tx, tw13, tw2, residual=tres), _jax_ffn(jx, jw13, jw2, jres),
                 "bfloat16")


def _predicate_cases():
    rng = np.random.RandomState(1)
    jw13 = _q(rng, 256, 1024, 256)
    jw2 = _q(rng, 512, 256, 512)
    jw2b = _q(rng, 576 + 64, 256, 128)   # padded-K w2 (an in_dim the FFN does not make)
    return {"decode rows": (jw13, jw2, 8), "prefill rows": (jw13, jw2, 512),
            "no w2": (jw13, None, 8), "padded K": (jw13, jw2b, 8)}


@pytest.mark.parametrize("case", ["decode rows", "prefill rows", "no w2", "padded K"])
def test_ffn_fusible_agrees_with_the_reference(monkeypatch, case):
    monkeypatch.setenv("ACCESSORY_FFN_FUSE", "1")   # the reference's switch, on
    jw13, jw2, m = _predicate_cases()[case]
    tw13 = _port_pair(jw13, jw13)[0]
    tw2 = None if jw2 is None else _port_pair(jw13, jw2)[1]
    assert tffn.ffn_fusible(tw13, tw2, m) == jffn.ffn_fusible(jw13, jw2, m)


def test_ffn_fusible_port_rules():
    """Folded W4 both sides, one group size, <= 128 rows; w2's in_dim the FFN
    width or that width padded by the quantizer (the reference refuses the
    latter: ROADMAP, deliberate differences); every other layout refused."""
    g = torch.Generator().manual_seed(0)

    def w4(k, n, gs=128, pad=None):
        w = torch.randn((k, n), generator=g) * k ** -0.5
        return to_folded_layout(quantize_weight(w, 4, gs, torch.float32, pad_in_to=pad))

    w13, w2 = w4(256, 2 * 1152), w4(1152, 256, pad=1024)
    assert w2.in_dim == 2048 and tffn.ffn_fusible(w13, w2, 128)
    assert not tffn.ffn_fusible(w13, w2, 129)
    assert not tffn.ffn_fusible(w13, w4(1152 + 128, 256), 8)        # not the quantizer's pad
    assert not tffn.ffn_fusible(w13, w4(1152, 256, gs=64, pad=1024), 8)
    std = quantize_weight(torch.randn((1152, 256), generator=g), 4, 128, torch.float32,
                          pad_in_to=1024)
    for other in (std, to_magic_layout(std), to_w8_layout(quantize_weight(
            torch.randn((1152, 256), generator=g), 8, 128, torch.float32, pad_in_to=1024))):
        assert not tffn.ffn_fusible(w13, other, 8)
    assert "at most 128 rows" in tffn._refusal(w13, w2, 129)
    with pytest.raises(RuntimeError, match="no kernel"):
        tffn.ffn_qmm(torch.zeros((2, 256), device="meta"), w13, w2)


@pytest.fixture(scope="module")
def model_pair():
    """A 2-layer f32 W4 model built and quantized by the JAX package (planes),
    fused and unstacked as its Generator serves it, and the port's copy."""
    cfg = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, multiple_of=128, vocab_size=300,
               max_seq_len=192, dtype="float32")
    jargs = JArgs(**cfg)
    qparams = jquantize_params(jllama.init_params(jax.random.PRNGKey(0), jargs), layout="planes")
    jgen = JGenerator(jllama, jargs, qparams, None, unroll_decode=True, kv_dtype="fp")
    targs = LLaMAArgs(**cfg)
    tparams = fuse_for_decode(params_from_jax(to_numpy_tree(qparams), targs, device="cpu"))
    return jgen, targs, tparams


def test_decode_with_ffn_fuse_matches_jax_and_the_unfused_route(model_pair, monkeypatch):
    """Prefill, then 4 teacher-forced decode steps: the port with ffn_fuse
    (every decode layer through ffn_qmm, counted) against the JAX forward
    (which never fuses off its accelerator) to test_torch_generate.py's f32
    bound, and against the port's unfused route to 1e-4 (f32: the SwiGLU
    rounding is no rounding); greedy tokens equal at every step."""
    jgen, targs, tparams = model_pair
    calls = []
    monkeypatch.setattr(llama, "ffn_qmm", lambda *a, **k: calls.append(1) or tffn.ffn_qmm(*a, **k))
    rng = np.random.RandomState(0)
    b, plen, steps, s_len = 2, 64, 4, 128
    toks = rng.randint(0, targs.vocab_size, size=(b, plen + steps))
    jcache = jllama.init_kv_cache(jgen.args, b, max_len=s_len, stacked=False, kv_dtype="fp")
    caches = {f: llama.init_kv_cache(targs, b, s_len, device="cpu") for f in (True, False)}
    for i in range(steps + 1):
        p0, p1 = (0, plen) if i == 0 else (plen + i - 1, plen + i)
        want, jcache = jllama.forward(jgen.params, jgen.args, jnp.asarray(toks[:, p0:p1]),
                                      cache=jcache, cur_pos=p0)
        got = {f: llama.forward(tparams, targs, torch.from_numpy(toks[:, p0:p1]), cache=c,
                                cur_pos=p0, ffn_fuse=f)[0].numpy() for f, c in caches.items()}
        want = np.asarray(want)
        np.testing.assert_allclose(got[True], want, atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(got[True], got[False], atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(got[True].argmax(-1), want.argmax(-1))
    assert len(calls) == targs.n_layers * steps   # decode steps only; the prefill never fuses


def test_bf16_decode_fused_against_unfused():
    """bf16: the fused route rounds SwiGLU once where the unfused one rounds
    silu and the product apart; logits within 2% relative L2, greedy tokens
    equal wherever the unfused top-2 margin exceeds the absolute bound."""
    args = LLaMAArgs(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, multiple_of=128,
                     vocab_size=300, max_seq_len=128, dtype="bfloat16")
    params = fuse_for_decode(quantize_params(llama.init_params(args, seed=1, device="cpu")))
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, args.vocab_size, (2, 40), generator=g)
    out = {}
    for fuse in (True, False):
        cache = llama.init_kv_cache(args, 2, 64, device="cpu")
        llama.forward(params, args, toks[:, :32], cache=cache, cur_pos=0, ffn_fuse=fuse)
        out[fuse] = torch.cat([llama.forward(params, args, toks[:, p:p + 1], cache=cache,
                                             cur_pos=p, ffn_fuse=fuse)[0]
                               for p in range(32, 40)], dim=1)
    fused, ref = out[True], out[False]
    assert float((fused - ref).norm() / ref.norm()) < 2e-2
    tol = 2e-2 * float(ref.abs().max())
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > tol
    assert bool((fused.argmax(-1) == ref.argmax(-1))[sure].all())


class _ByteTok:
    bos_id, eos_id, n_words = 256, 257, 258

    def encode(self, s, bos, eos):
        return [self.bos_id] * bos + list(s.encode()) + [self.eos_id] * eos

    def decode(self, t):
        return bytes(x for x in t if x < 256).decode("utf-8", errors="replace")

    def encode_segment(self, s):
        return list(s.encode())

    encode_wo_prefix_space = encode_segment


def test_meta_model_serves_with_ffn_fuse(monkeypatch, tmp_path):
    """MetaModel.from_pretrained(..., ffn_fuse=True) hands the switch to the
    Generator, which passes it to every forward; the greedy text equals the
    unfused route's (f32)."""
    from accessory_tpu_torch.meta import MetaModel

    seen = []
    real = llama.forward
    monkeypatch.setattr(llama, "forward",
                        lambda *a, **k: seen.append(k.get("ffn_fuse")) or real(*a, **k))
    cfg = dict(dim=256, n_layers=1, n_heads=4, n_kv_heads=2, multiple_of=128, vocab_size=258,
               dtype="float32")
    MetaModel("llama", cfg, max_seq_len=128, device="cpu", tokenizer=_ByteTok()).quantize() \
        .save_pretrained(str(tmp_path))
    texts = {}
    for fuse in (True, False):
        model = MetaModel.from_pretrained(str(tmp_path), max_seq_len=128, device="cpu",
                                          tokenizer=_ByteTok(), dtype="float32", ffn_fuse=fuse)
        assert model.ffn_fuse is fuse and model.generator.ffn_fuse is fuse
        seen.clear()
        texts[fuse] = model.generate(["hello", "fused ffn"], max_gen_len=8)
        assert seen and all(f is fuse for f in seen)
    assert texts[True] == texts[False]
