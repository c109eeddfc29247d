"""Port parity, the MoE layer (``ops/moe.py``) against the JAX package's
``accessory_tpu/ops/moe.py`` on the same seeded numpy inputs: the router
(top-k order on exact ties included), the load-balancing loss, the ragged,
dense and quantized dispatches, and the touched-expert skip (three
quantized products for each expert some row chose, none for the others).
The JAX quantized path runs as its own tests run it on the CPU (planes
weights: the Pallas W4 kernel in interpret mode). CPU only; each test
states its tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.ops import moe as jmoe
from accessory_tpu.quant.quantize import quantize_params as jquantize_params

from accessory_tpu_torch.ops import moe
from accessory_tpu_torch.quant import qtensor
from accessory_tpu_torch.quant.quantize import quantize_params

T, D, H, E, K = 12, 256, 256, 4, 2


def _inputs(seed, dtype=np.float32, t=T, gate_scale=0.5):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((t, D)).astype(np.float32)
    gate = (rng.standard_normal((D, E)) * gate_scale).astype(np.float32)
    w1 = (rng.standard_normal((E, D, H)) * D ** -0.5).astype(np.float32)
    w3 = (rng.standard_normal((E, D, H)) * D ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((E, H, D)) * H ** -0.5).astype(np.float32)
    return x.astype(dtype), gate, w1.astype(dtype), w3.astype(dtype), w2.astype(dtype)


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t if dtype is None else t.to(dtype)


def test_topk_gating_matches_jax():
    """Weights and scores to 1e-6 (f32 softmax of the same f32 logits, the
    port's product taken in f64), indices equal."""
    x, gate, *_ = _inputs(0)
    jw, ji, js = jmoe.topk_gating(jnp.asarray(x), jnp.asarray(gate), K)
    tw, ti, ts = moe.topk_gating(_t(x), _t(gate), K)
    assert ti.dtype == torch.int32 and tuple(ti.shape) == (T, K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tw.sum(-1).numpy(), np.ones(T), rtol=1e-6)


@pytest.mark.parametrize("ties", ["zero_gate", "equal_columns"])
def test_topk_ties_resolve_as_jax(ties):
    """Exact ties: a zero gate makes every score 1/E, and equal gate columns
    make pairs of experts tie; the lower index comes first, as in
    ``jax.lax.top_k``, and the weights split evenly (exactly)."""
    x, gate, *_ = _inputs(1)
    if ties == "zero_gate":
        gate = np.zeros_like(gate)
    else:
        gate[:, 2] = gate[:, 0]
        gate[:, 3] = gate[:, 1]
    jw, ji, _ = jmoe.topk_gating(jnp.asarray(x), jnp.asarray(gate), K)
    tw, ti, _ = moe.topk_gating(_t(x), _t(gate), K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    if ties == "zero_gate":
        assert (ti.numpy() == [0, 1]).all() and (tw.numpy() == 0.5).all()
    else:
        assert (np.sort(ti.numpy(), axis=1)[:, 1] - np.sort(ti.numpy(), axis=1)[:, 0] == 2).all()


def test_load_balancing_loss_matches_jax():
    """The same counts and mean scores: 1e-6 relative; uniform routing gives
    the weight itself."""
    x, gate, *_ = _inputs(2)
    _, ji, js = jmoe.topk_gating(jnp.asarray(x), jnp.asarray(gate), K)
    _, ti, ts = moe.topk_gating(_t(x), _t(gate), K)
    want = float(jmoe.load_balancing_loss(js, ji, E, K, 0.01))
    got = float(moe.load_balancing_loss(ts, ti, E, K, 0.01))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    uniform = torch.full((T, E), 1.0 / E)
    idx = torch.stack([torch.arange(T) % E, (torch.arange(T) + 1) % E], dim=1)
    np.testing.assert_allclose(float(moe.load_balancing_loss(uniform, idx, E, K, 0.01)), 0.01,
                               rtol=1e-6)


@pytest.mark.parametrize("impl", ["ragged", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_dense_experts_match_jax(impl, dtype):
    """moe_ffn_ragged / moe_ffn_dense against the JAX function of the same
    name, with the aux loss: f32 to 2e-5 (f32 products and sums in another
    order); bf16 inputs to 1e-2 absolute (the hidden activation rounds to
    bf16 on both sides; one rounding can differ by a bf16 ulp) on outputs of
    magnitude ~1, the routing checked equal first."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    x, gate, w1, w3, w2 = _inputs(3)
    jfn = jmoe.moe_ffn_ragged if impl == "ragged" else jmoe.moe_ffn_dense
    tfn = moe.moe_ffn_ragged if impl == "ragged" else moe.moe_ffn_dense
    want, jaux = jfn(*(jnp.asarray(a, jdt) for a in (x,)), jnp.asarray(gate),
                     *(jnp.asarray(a, jdt) for a in (w1, w3, w2)), k=K, balance_weight=0.01)
    with moe.record_routing(detail=True) as log:
        got, taux = tfn(_t(x, tdt), _t(gate), _t(w1, tdt), _t(w3, tdt), _t(w2, tdt), k=K,
                        balance_weight=0.01)
    _, ji, _ = jmoe.topk_gating(jnp.asarray(x, jdt), jnp.asarray(gate), K)
    np.testing.assert_array_equal(log[0]["idx"].numpy(), np.asarray(ji))
    assert got.dtype == tdt and tuple(got.shape) == (T, D)
    tol = 2e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_ragged_and_dense_agree():
    """The two dispatches of dense experts compute the same function: f32 to
    1e-5, the dispatch entry picks them by ``impl``."""
    x, gate, w1, w3, w2 = (_t(a) for a in _inputs(4))
    a, _ = moe.moe_ffn(x, gate, w1, w3, w2, k=K, impl="ragged")
    b, _ = moe.moe_ffn(x, gate, w1, w3, w2, k=K, impl="dense")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        moe.moe_ffn(x, gate, w1, w3, w2, k=K, impl="grouped")


@pytest.fixture(scope="module")
def quant_experts():
    """The same dense experts quantized by both packages (W4 g128; planes on
    the JAX side, the port's folded layout, one tuple an expert leaf), and
    the JAX outputs at T = 12 and T = 1, f32 activations."""
    x, gate, w1, w3, w2 = _inputs(5)
    jq = jquantize_params({"w1": jnp.asarray(w1), "w3": jnp.asarray(w3), "w2": jnp.asarray(w2)},
                          layout="planes")
    tq = quantize_params({"w1": _t(w1), "w3": _t(w3), "w2": _t(w2)})
    want = {t: np.asarray(jmoe.moe_ffn(jnp.asarray(x[:t]), jnp.asarray(gate), jq["w1"],
                                       jq["w3"], jq["w2"], k=K)[0]) for t in (T, 1)}
    return x, gate, tq, want


@pytest.mark.parametrize("t", [T, 1])
def test_moe_ffn_quant_matches_jax(quant_experts, t):
    """moe_ffn_quant on per-expert W4 weights against the JAX package's (its
    planes kernel in interpret mode): 1e-4 (both packages quantize to the
    same q, scales and zeros; the products sum in another order). The
    expert tuple and the same weights stacked on an expert axis give the
    same bits."""
    x, gate, tq, want = quant_experts
    assert isinstance(tq["w1"], tuple) and len(tq["w1"]) == E
    assert all(w.layout == "folded" and w.in_dim == D for w in tq["w1"])
    got, aux = moe.moe_ffn(_t(x[:t]), _t(gate), tq["w1"], tq["w3"], tq["w2"], k=K)
    assert aux is None
    np.testing.assert_allclose(got.numpy(), want[t], atol=1e-4, rtol=1e-4)

    def stack(ws):
        return qtensor.QuantizedWeight(
            packed=torch.stack([w.packed for w in ws]), scales=torch.stack([w.scales for w in ws]),
            zeros=torch.stack([w.zeros for w in ws]), bits=4, group_size=128,
            in_dim=ws[0].in_dim, out_dim=ws[0].out_dim, act_dtype=ws[0].act_dtype,
            layout="folded")

    stacked, _ = moe.moe_ffn_quant(_t(x[:t]), _t(gate), stack(tq["w1"]), stack(tq["w3"]),
                                   stack(tq["w2"]), k=K)
    assert torch.equal(stacked, got)


@pytest.mark.parametrize("t", [1, 2, T])
def test_quant_experts_skip_untouched(quant_experts, monkeypatch, t):
    """Three quantized products for each touched expert and none for the
    rest: at one row exactly k experts run; the recorded routing's touched
    mask is the set of chosen experts."""
    x, gate, tq, _ = quant_experts
    calls = []

    def counting(xx, qw, **kw):
        calls.append(qw)
        return qtensor.quant_matmul(xx, qw, **kw)

    monkeypatch.setattr(moe, "quant_matmul", counting)
    with moe.record_routing(detail=True) as log:
        moe.moe_ffn(_t(x[:t]), _t(gate), tq["w1"], tq["w3"], tq["w2"], k=K)
    (rec,) = log
    chosen = set(rec["idx"].reshape(-1).tolist())
    assert rec["touched"] == [e in chosen for e in range(E)] and rec["rows"] == t
    assert len(calls) == 3 * len(chosen)
    if t == 1:
        assert len(calls) == 3 * K
    ran = {id(w) for w in calls}
    for e in range(E):
        mine = {id(tq[n][e]) for n in ("w1", "w3", "w2")}
        assert (mine <= ran) == (e in chosen) and (mine & ran == set()) == (e not in chosen)
