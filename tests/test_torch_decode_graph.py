"""Port parity, the compiled decode loops on the CPU: the position on the
device, the MoE FFN's expert skip on the device, the Generator's decode step
and the launch counts of replayed graphs.

(a) Every family's decode forward at ``cur_pos`` a 0-d tensor is bit-equal
to the same forward at the int (per-layer and stacked caches, bf16 and int8
caches, LLaMA's fused FFN; SPHINX's and SPHINX-MoE's forwards through their
decoders) and matches the JAX forward at that position: f32 models, the JAX
side on its stacked-cache path at a 96-token cache (its XLA branch),
logits to 1e-4 of their largest magnitude (the two packages sum in other
orders).
(b) The Generator's decode step (the function a CUDA graph captures on the
card, run eagerly here) gives the JAX ``_compiled_loop``'s greedy tokens and
``stop_pos``, with a stop sequence that straddles a ``STOP_CHECK_EVERY``
boundary and one whose window starts before position 0.
(c) ``moe_ffn_quant`` with the skip decided on the device (every expert's
three products gated by the touched mask) equals the JAX ``moe_ffn_quant``
(1e-4) and is bit-equal to the host-skip route, at a step where experts go
untouched.
(d) The replay bookkeeping of the launch counts.
The C calls' position and gate arguments are checked against the entries'
declared parameters. CPU only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.config import FalconArgs as JFalconArgs
from accessory_tpu.config import InternLMArgs as JInternLMArgs
from accessory_tpu.config import LLaMAArgs as JLLaMAArgs
from accessory_tpu.config import MixtralArgs as JMixtralArgs
from accessory_tpu.engine.generate import Generator as JGenerator
from accessory_tpu.models import falcon as jfalcon
from accessory_tpu.models import internlm as jinternlm
from accessory_tpu.models import llama as jllama
from accessory_tpu.models import mixtral as jmixtral
from accessory_tpu.ops import moe as jmoe
from accessory_tpu.quant.quantize import quantize_params as jquantize_params

from accessory_tpu_torch import kernels
from accessory_tpu_torch.config import FalconArgs, InternLMArgs, LLaMAArgs, MixtralArgs
from accessory_tpu_torch.convert import params_from_jax
from accessory_tpu_torch.engine import generate as tgenerate
from accessory_tpu_torch.engine.generate import Generator, graph_rule
from accessory_tpu_torch.engine.graphs import use_graphs
from accessory_tpu_torch.engine.scheduler import ContinuousBatcher
from accessory_tpu_torch.models import falcon, internlm, llama, mixtral, sphinx, sphinx_moe
from accessory_tpu_torch.ops import decode_attention as tda
from accessory_tpu_torch.ops import moe as tmoe
from accessory_tpu_torch.ops import quant_matmul_planes as tplanes
from accessory_tpu_torch.quant.fuse import fuse_for_decode
from accessory_tpu_torch.quant.quantize import quantize_params

from test_torch_bigm_flash import c_signature
from test_torch_generate import one_torch_thread, to_numpy_tree  # noqa: F401

CACHE = 96        # not a multiple of 128: the JAX side's XLA decode branch
PREFILL = 12
LLAMA = dict(dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=101, multiple_of=64,
             max_seq_len=CACHE, dtype="float32")
MIXTRAL = dict(dim=128, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128, num_experts=4,
               vocab_size=101, max_seq_len=CACHE, dtype="float32")
ZOO = dict(num_layers=2, hidden_size=128, num_attention_heads=2, vocab_size=101,
           max_seq_len=CACHE, dtype="float32")
FAMILIES = {
    "llama": (JLLaMAArgs, LLaMAArgs, jllama, llama, LLAMA),
    "mixtral": (JMixtralArgs, MixtralArgs, jmixtral, mixtral, MIXTRAL),
    "internlm": (JInternLMArgs, InternLMArgs, jinternlm, internlm, dict(ZOO, multiple_of=64)),
    "falcon": (JFalconArgs, FalconArgs, jfalcon, falcon, dict(ZOO, num_kv_heads=1)),
}


def _tokens(seed, n):
    return np.random.RandomState(seed).randint(0, 101, size=(2, n))


@pytest.fixture(scope="module")
def built():
    """Each family's JAX args and params (stacked) and the port's copies."""
    out = {}
    for name, (jcls, tcls, jmod, tmod, cfg) in FAMILIES.items():
        jargs, targs = jcls(**cfg), tcls(**cfg)
        jp = jmod.init_params(jax.random.PRNGKey(3), jargs)
        out[name] = (jargs, jp, targs, params_from_jax(to_numpy_tree(jp), targs, device="cpu"))
    return out


def _port_step(tmod, targs, tparams, toks, pos, kv_dtype=None, stacked=False, **kw):
    """Prefill toks[:, :PREFILL] at 0, then one decode token at ``pos`` (an
    int or a 0-d tensor): (decode logits, cache)."""
    cache = tmod.init_kv_cache(targs, 2, CACHE, None, stacked, kv_dtype, device="cpu")
    tmod.forward(tparams, targs, torch.from_numpy(toks[:, :PREFILL]), cache=cache, cur_pos=0,
                 **kw)
    logits, cache = tmod.forward(tparams, targs, torch.from_numpy(toks[:, PREFILL:PREFILL + 1]),
                                 cache=cache, cur_pos=pos, **kw)
    return logits, cache


def _same_cache(a, b):
    for key in a:
        pa = a[key] if isinstance(a[key], list) else [a[key]]
        pb = b[key] if isinstance(b[key], list) else [b[key]]
        assert all(torch.equal(x, y) for x, y in zip(pa, pb)), key


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_at_a_device_position_matches_the_int_and_jax(built, family):
    jargs, jp, targs, tparams = built[family]
    jmod, tmod = FAMILIES[family][2], FAMILIES[family][3]
    toks = _tokens(1, PREFILL + 1)
    pos_t = torch.tensor(PREFILL)
    for stacked in (False, True):
        for kv_dtype in (None, "int8"):
            want_l, want_c = _port_step(tmod, targs, tparams, toks, PREFILL, kv_dtype, stacked)
            got_l, got_c = _port_step(tmod, targs, tparams, toks, pos_t, kv_dtype, stacked)
            assert torch.equal(got_l, want_l), (stacked, kv_dtype)
            _same_cache(got_c, want_c)
    jcache = jmod.init_kv_cache(jargs, 2, CACHE, None, True, "fp")
    _, jcache = jmod.forward(jp, jargs, jnp.asarray(toks[:, :PREFILL]), cache=jcache, cur_pos=0)
    jl, _ = jmod.forward(jp, jargs, jnp.asarray(toks[:, PREFILL:]), cache=jcache,
                         cur_pos=PREFILL)
    got, _ = _port_step(tmod, targs, tparams, toks, pos_t)
    jl = np.asarray(jl)
    np.testing.assert_allclose(got.numpy(), jl, atol=1e-4 * np.abs(jl).max(), rtol=0)


def test_decode_at_a_device_position_fused_routes(built):
    """LLaMA's fused wqkv / w13 over W4 weights (the decode-RoPE rows
    gathered at the position for the kernel's epilogue), the fused FFN and
    the unfused attention write; the SPHINX and SPHINX-MoE forwards through
    their decoders: bit-equal at a 0-d int32 or int64 tensor."""
    _, _, targs, tparams = built["llama"]
    w4 = fuse_for_decode(quantize_params(tparams))
    toks = _tokens(2, PREFILL + 1)
    for kw in (dict(ffn_fuse=True), dict(fused_attn_write=False)):
        for kv_dtype in (None, "int8"):
            want, _ = _port_step(llama, targs, w4, toks, PREFILL, kv_dtype, **kw)
            for dt in (torch.int32, torch.int64):
                got, _ = _port_step(llama, targs, w4, toks, torch.tensor(PREFILL, dtype=dt),
                                    kv_dtype, **kw)
                assert torch.equal(got, want), (kw, kv_dtype, dt)
    for tmod, name in ((sphinx, "llama"), (sphinx_moe, "mixtral")):
        _, _, targs, tparams = built[name]
        want, _ = _port_step(tmod, targs, tparams, toks, PREFILL)
        got, _ = _port_step(tmod, targs, tparams, toks, torch.tensor(PREFILL))
        assert torch.equal(got, want), name


def test_device_position_rules(monkeypatch):
    """A position is an int or a 0-d int32 / int64 tensor on the operands'
    device; a tensor of another shape, dtype or device raises. The C calls
    pass (pos, null) for an int and (0, the tensor's address) for a tensor,
    in the place the entries declare."""
    seen = {}

    def function(lib, sym, argtypes):
        def fake(*args):
            seen.update(sym=sym, args=args, argtypes=list(argtypes))
            return 0
        return fake

    monkeypatch.setattr(kernels, "function", function)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 0)
    b, nq, nkv, hd, s_len = 2, 8, 2, 64, 32
    q = torch.zeros(b, 1, nq, hd, dtype=torch.bfloat16)
    kn = torch.zeros(b, 1, nkv, hd, dtype=torch.bfloat16)
    pools = (torch.zeros(b, nkv, s_len, hd, dtype=torch.bfloat16),) * 2
    pos_t = torch.tensor(9, dtype=torch.int32)
    tda._decode_kernel("t", q, kn, kn, pools, pos_t, write=True)
    assert seen["argtypes"] == c_signature("decode_attention", "decode_attention")
    assert seen["args"][-6:-4] == (0, pos_t.data_ptr())
    tda._write("t", pools, kn, kn, pos_t)
    assert seen["sym"] == "kv_write_col" and seen["args"][-3:-1] == (0, pos_t.data_ptr())
    assert seen["argtypes"] == c_signature("kv_write", "kv_write_col")
    tda._write("t", pools, kn, kn, 5)
    assert seen["args"][-3:-1] == (5, None)
    for bad in (torch.tensor([3]), torch.tensor(3.0), torch.tensor(3, device="meta")):
        with pytest.raises(NotImplementedError, match="0-d"):
            tda.decode_attention_update(q, kn, kn, *pools, bad)
    with pytest.raises(NotImplementedError, match="one int"):
        tda._int_pos("t", 2.0, q)


def test_gemv_gate_call_and_plain(monkeypatch):
    """Row 1's C entry takes the gate after ``out`` (null without one); the
    plain route (a CPU tensor) gives the ungated bits with the gate set and
    zeros with it cleared; a gate needs at most 16 rows."""
    from accessory_tpu_torch.quant import qtensor as tq

    qw = tq.to_folded_layout(tq.quantize_weight(torch.randn(256, 128) * 0.05, 4, 128))
    x = torch.randn(4, 256).to(torch.bfloat16)
    args = (x, qw.packed, qw.scales, qw.zeros)
    kw = dict(in_dim=256, group_size=128)
    y = tplanes.planes_qmm(*args, **kw)
    on, off = torch.tensor(1, dtype=torch.int32), torch.tensor(0, dtype=torch.int32)
    assert torch.equal(tplanes.planes_qmm(*args, **kw, gate=on), y)
    z = tplanes.planes_qmm(*args, **kw, gate=off)
    assert z.shape == y.shape and not z.any()
    with pytest.raises(ValueError, match="gate"):
        tplanes.planes_qmm(torch.randn(17, 256).to(torch.bfloat16), *args[1:], **kw, gate=on)
    seen = {}
    monkeypatch.setattr(kernels, "function",
                        lambda lib, sym, at: lambda *a: seen.update(a=a, at=list(at)) or 0)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 0)
    out = torch.empty(4, 128, dtype=torch.bfloat16)
    tplanes._kernel_call(*args, None, None, None, None, out, group_size=128, gate=off)
    assert seen["at"] == tplanes._ARGS == c_signature("w4_matmul", "w4_matmul")
    assert seen["a"][16:18] == (out.data_ptr(), off.data_ptr())


@pytest.fixture(scope="module")
def moe_pair():
    """Four W4 experts quantized by both packages from the same dense
    weights, and routing inputs."""
    rng = np.random.RandomState(11)
    d, h, e = 256, 256, 4
    w = {n: (rng.randn(e, *s) * s[0] ** -0.5).astype(np.float32)
         for n, s in (("w1", (d, h)), ("w3", (d, h)), ("w2", (h, d)))}
    jq = jquantize_params({n: jnp.asarray(v) for n, v in w.items()}, layout="planes")
    tq = quantize_params({n: torch.from_numpy(v) for n, v in w.items()})
    gate = rng.randn(d, e).astype(np.float32)
    x = rng.randn(6, d).astype(np.float32)
    return x, gate, jq, tq


@pytest.mark.parametrize("t", [1, 6])
def test_moe_device_skip_matches_jax_and_the_host_skip(moe_pair, monkeypatch, t):
    x, gate, jq, tq = moe_pair
    xt, gt = torch.from_numpy(x[:t]), torch.from_numpy(gate)
    host, _ = tmoe.moe_ffn_quant(xt, gt, tq["w1"], tq["w3"], tq["w2"], k=2)
    calls = []
    real = tplanes.planes_qmm

    def counting(*a, **kw):
        calls.append(kw.get("gate"))
        return real(*a, **kw)

    monkeypatch.setattr(tmoe, "device_gated", lambda *a: True)
    monkeypatch.setattr(tplanes, "planes_qmm", counting)
    with tmoe.record_routing() as log:
        dev, _ = tmoe.moe_ffn_quant(xt, gt, tq["w1"], tq["w3"], tq["w2"], k=2)
    touched = log[0]["touched"]
    if t == 1:
        assert sum(touched) == 2 < len(touched)   # untouched experts at this step
    assert len(calls) == 3 * len(touched)         # every expert's three, gated
    assert [bool(g) for g in calls[::3]] == touched
    assert torch.equal(dev, host)
    want = np.asarray(jmoe.moe_ffn_quant(jnp.asarray(x[:t]), jnp.asarray(gate), jq["w1"],
                                         jq["w3"], jq["w2"], k=2)[0])
    np.testing.assert_allclose(dev.numpy(), want, atol=1e-4, rtol=1e-4)


def test_moe_gating_rule():
    """The skip is decided on the device for folded W4 experts at <= 16
    rows on a CUDA tensor; Mixtral's (and SPHINX-MoE's) decode-graph rule
    follows it: dense experts and more rows decode eagerly on the card."""
    targs = MixtralArgs(**MIXTRAL)
    dense = mixtral.init_params(targs, seed=0, device="cpu")
    w4 = quantize_params(dense)
    assert mixtral.SUPPORTS_DECODE_GRAPH(w4, 16) and not mixtral.SUPPORTS_DECODE_GRAPH(w4, 17)
    assert not mixtral.SUPPORTS_DECODE_GRAPH(dense, 8)
    assert sphinx_moe.SUPPORTS_DECODE_GRAPH is mixtral.SUPPORTS_DECODE_GRAPH
    assert graph_rule(llama, None, 64) and graph_rule(mixtral, w4, 8)
    assert not graph_rule(mixtral, dense, 8)
    ff = w4["layers"][0]["feed_forward"]
    x = torch.zeros(8, MIXTRAL["dim"])
    assert not tmoe.device_gated(x, ff["w1"]["weight"], ff["w3"]["weight"], ff["w2"]["weight"])
    assert not use_graphs("cpu", True) and not use_graphs("cuda", False)
    assert use_graphs("cuda", True)


# ---------------------------------------------------------------- (b) the Generator's step


@pytest.fixture(scope="module")
def loop_pair():
    jargs = JLLaMAArgs(**LLAMA)
    jp = jllama.init_params(jax.random.PRNGKey(5), jargs)
    targs = LLaMAArgs(**LLAMA)
    tp = params_from_jax(to_numpy_tree(jp), targs, device="cpu")
    jgen = JGenerator(jllama, jargs, jp, None, unroll_decode=False, kv_dtype="fp")
    tgen = Generator(llama, targs, tp, None, device="cpu", unroll_decode=False)
    return jgen, tgen


BUF = 40


def _prompts():
    """Two rows, prompts of 5 and 9 tokens (row 1's mask covers positions
    5-8 while row 0 generates)."""
    tokens = np.zeros((2, BUF), np.int64)
    mask = np.zeros((2, BUF), bool)
    for i, n in enumerate((5, 9)):
        tokens[i, :n] = _tokens(20 + i, n)[0]
        mask[i, :n] = True
    return tokens, mask


def _jax_loop(jgen, tokens, mask, stops, end):
    run = jgen._compiled_loop(2, BUF, BUF, 0.0, 0.95, stops, 0)
    out, _, stop_pos = run(jgen.params, jnp.asarray(tokens.astype(np.int32)), jnp.asarray(mask),
                           jnp.int32(5), jnp.int32(end), jax.random.PRNGKey(0))
    return np.asarray(out), np.asarray(stop_pos)


def test_generator_step_matches_the_jax_loop(loop_pair):
    """The decode step run eagerly (the function a graph replays on the
    card) against JAX's ``_compiled_loop``: greedy tokens and stop_pos
    equal without stops, with a stop sequence whose window straddles the
    8-step host check (positions 12-13: steps 7 and 8 from position 5) and
    with one longer than the first windows (they start before 0, masked on
    the device)."""
    jgen, tgen = loop_pair
    tokens, mask = _prompts()
    end = 30
    free, free_pos = _jax_loop(jgen, tokens, mask, ((101,),), end)
    got, got_pos = tgen._run(tokens, mask, BUF, 5, end, 0.0, 0.95, ((101,),), 0)
    assert np.array_equal(got[:, :end], free[:, :end]) and np.array_equal(got_pos, free_pos)
    straddle = (int(free[0, 12]), int(free[0, 13]))
    long_seq = tuple(int(v) for v in free[1, :7])     # row 1's prompt head: never generated
    stops = ((101,), straddle, long_seq)
    want, want_pos = _jax_loop(jgen, tokens, mask, stops, end)
    got, got_pos = tgen._run(tokens, mask, BUF, 5, end, 0.0, 0.95, stops, 0)
    assert want_pos[0] <= 12 and np.array_equal(got_pos, want_pos)
    steps = tgen.last_decode_steps
    assert np.array_equal(got[:, :5 + steps], want[:, :5 + steps])
    # the host reads the stop state every STOP_CHECK_EVERY steps: both rows
    # stopped by then ends the run at that boundary at the latest
    assert steps % tgenerate.STOP_CHECK_EVERY == 0 or 5 + steps == end


# ---------------------------------------------------------------- (d) replay bookkeeping


def test_replay_counts_add_what_the_capture_recorded():
    """A capture's counted launches leave the counts as they were and go to
    its record; each replay adds the record, so a run of replays reads as
    the same steps run eagerly."""
    kernels.reset_launch_counts()
    kernels.check("w4_matmul", 0)
    with kernels.counting_capture() as rec:
        for _ in range(3):
            kernels.check("w4_matmul", 0)
        kernels.check("decode_attention", 0)
    assert rec == {"w4_matmul": 3, "decode_attention": 1}
    assert kernels.launch_counts()["w4_matmul"] == 1
    assert kernels.launch_counts()["decode_attention"] == 0
    for _ in range(4):
        kernels.count_replay(rec)
    counts = kernels.launch_counts()
    assert counts["w4_matmul"] == 13 and counts["decode_attention"] == 4
    with kernels.counting_capture() as empty:
        pass
    assert empty == {}
    kernels.reset_launch_counts()


class _Tok:
    eos_id = 100


def test_cpu_engines_never_capture():
    """On the CPU a Generator and a batcher run every step eagerly, with or
    without ``compiled``; the switch is kept for the card."""
    targs = LLaMAArgs(**LLAMA)
    params = llama.init_params(targs, device="cpu")
    for compiled in (True, False):
        gen = Generator(llama, targs, params, None, device="cpu", compiled=compiled)
        cb = ContinuousBatcher(llama, targs, params, _Tok(), slots=2, page_size=16,
                               device="cpu", compiled=compiled)
        assert not gen.graphs and not cb.graphs and gen.compiled == compiled
