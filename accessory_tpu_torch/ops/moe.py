"""Top-k MoE routing and expert computation (Mixtral-style SwiGLU experts).

Port of ``accessory_tpu/ops/moe.py``:

* ``topk_gating``: f32 router logits, f32 softmax over the experts, top-k,
  the k weights renormalized to sum to 1. The router's product is taken in
  f64 and rounded to f32, so it is never a TF32 product, whatever the
  process's matmul precision, on the CPU and the card alike. Ties resolve
  as ``jax.lax.top_k`` resolves them, the lower expert index first (a stable
  descending sort; ``torch.topk`` promises no order).
* ``load_balancing_loss``: the auxiliary loss of the reference.
* ``moe_ffn_ragged``: the exact dispatch of dense experts, rows sorted by
  expert (a stable argsort, as ``jnp.argsort``) and one product per expert
  over its group of rows (the reference's ``jax.lax.ragged_dot``, an XLA
  grouped GEMM there, not a Pallas kernel), f32 outputs.
* ``moe_ffn_dense``: every expert over every row, masked by the combine
  weights (the reference's ep-shardable form).
* ``moe_ffn_quant``: quantized experts, each one's w1, w3 and w2 through
  ``quant_matmul`` (the W4 GEMV or tile below 1024 rows, the many-row W4
  kernel from there on), each touched expert on all T rows, as the
  reference computes it. The reference gates an expert's three calls
  behind ``lax.cond(touched[e])``, on the device. Here, where the call is a
  decode step's (folded W4 experts, at most 16 rows, on the card), every
  expert's three GEMV launches go out with the (E,) touched mask as their
  gate (``planes_qmm(gate=)``): an expert no row chose writes zeros and
  reads no weight byte, and the host reads nothing, so a decode step
  captured in a CUDA graph replays the routing of each step (4 + 3 E W4
  launches a Mixtral layer). Elsewhere (a prefill's rows, other weight
  formats, the CPU) the mask is read on the host once a call and only
  touched experts launch. Both give the same bits: an untouched expert adds
  0 * 0 to a sum that is never -0.
* ``moe_ffn``: the dispatch entry.

``record_routing()`` collects, while it is open, each MoE call's routing on
the host (its rows and touched mask; with ``detail`` the chosen experts and
the router scores too), so a caller can hold launch counts and byte bounds
to the routing a step took. It copies to the host, so it records nothing
while a CUDA graph is being captured.

A checkpointed layer's recompute routes as its forward did: the router's
choice is ``util.replayed`` (kind "route"), which a layer's memo keeps
under every remat policy (``util.remat_policy``). A recompute that
re-routed (a tie, or a kernel whose sum order varies) would launch another
set of experts, and the non-reentrant checkpoint refuses a recompute whose
saved tensors differ in shape. ``routing_replay(memo)`` opens such a memo
by hand (a list of (T, k) choices, recorded on a first run, replayed on a
later one); a replaying call's record entry also holds the experts its own
scores chose (``own_idx``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch

from accessory_tpu_torch.quant.qtensor import QuantizedWeight, quant_matmul
from accessory_tpu_torch.util import LayerMemo, replayed, replaying

_routing_log: Optional[List[dict]] = None
_routing_detail = False
_fresh: Optional[torch.Tensor] = None   # a replaying call's own choice, for _record


@contextlib.contextmanager
def record_routing(detail: bool = False) -> Iterator[List[dict]]:
    """Within the block, every MoE FFN call appends to the yielded list a
    dict: ``rows`` (T) and ``touched`` (E bools, the host copy the call
    makes anyway); with ``detail`` also ``idx`` (T, k) int32 and ``scores``
    (T, E) f32 on the host, a device-to-host copy each a call."""
    global _routing_log, _routing_detail
    prev = _routing_log, _routing_detail
    _routing_log, _routing_detail = [], detail
    try:
        yield _routing_log
    finally:
        _routing_log, _routing_detail = prev


@contextlib.contextmanager
def routing_replay(memo: List[torch.Tensor]) -> Iterator[None]:
    """Within the block, MoE calls record their chosen experts (T, k) into an
    empty ``memo`` in order, or, where ``memo`` already holds them, take them
    from it in the same order."""
    layer = LayerMemo(("route",))
    layer.store["route"] = memo
    with replaying(layer):
        yield


def _route(x: torch.Tensor, gate_w: torch.Tensor, k: int):
    """``topk_gating``; a replaying call keeps its own choice, for ``_record``,
    in ``_fresh``."""
    global _fresh
    weights, idx, scores, own = _gating(x, gate_w, k)
    _fresh = own
    return weights, idx, scores


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _record(idx: torch.Tensor, scores: torch.Tensor, touched) -> None:
    """Append the call's routing (``touched``: E bools, or the (E,) mask on
    the device, copied here) unless no record is open or a capture runs."""
    global _fresh
    fresh, _fresh = _fresh, None
    if _routing_log is None or _capturing(idx):
        return
    if isinstance(touched, torch.Tensor):
        touched = touched.tolist()
    entry = {"rows": idx.shape[0], "touched": list(touched)}
    if _routing_detail:
        entry.update(idx=idx.cpu(), scores=scores.detach().cpu())
    if fresh is not None:
        # a replayed routing: the experts the call's own scores chose, left
        # on its device (a caller that compares them copies them)
        entry["replayed"], entry["own_idx"] = True, fresh
    _routing_log.append(entry)


def topk_gating(x: torch.Tensor, gate_w: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: (weights (T, k) f32 renormalized, indices (T, k) int32, the full
    softmax scores (T, E) f32 that the load-balancing loss reads)."""
    return _gating(x, gate_w, k)[:3]


def _gating(x, gate_w, k: int):
    """``topk_gating`` and, where an open memo replays the experts
    (``util.replayed``, kind "route"), the sort's own choice (T, k) int64,
    else None. The weights are the scores gathered at the experts taken:
    where the sort chose them, its values."""
    logits = torch.matmul(x.to(torch.float64), gate_w.to(torch.float64)).to(torch.float32)
    scores = torch.softmax(logits, dim=-1)
    chosen = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]
    idx = replayed("route", lambda: chosen)
    weights = scores.gather(1, idx)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, idx.to(torch.int32), scores, None if idx is chosen else chosen


def load_balancing_loss(scores: torch.Tensor, idx: torch.Tensor, num_experts: int, k: int,
                        weight: float) -> torch.Tensor:
    """weight * E / (T k) * dot(tokens per expert, mean router score)."""
    t = scores.shape[0]
    counts = torch.bincount(idx.reshape(-1).to(torch.int64),
                            minlength=num_experts).to(torch.float32)
    return weight * num_experts / (t * k) * torch.dot(counts, scores.mean(dim=0))


def _combine(weights: torch.Tensor, idx: torch.Tensor, e: int) -> torch.Tensor:
    """(T, E) f32: token t's routing weight for expert e, 0 if not chosen."""
    out = torch.zeros((weights.shape[0], e), dtype=torch.float32, device=weights.device)
    return out.scatter(1, idx.to(torch.int64), weights)


def _swiglu_expert_ragged(xs, w1, w3, w2, group_sizes: List[int]) -> torch.Tensor:
    """Grouped SwiGLU over rows sorted by expert: xs (M, d); w1 / w3 (E, d, h),
    w2 (E, h, d); f32 products of the activation-dtype inputs, f32 out."""
    dt = xs.dtype
    outs, lo = [], 0
    for e, n in enumerate(group_sizes):
        xe = xs[lo:lo + n].to(torch.float32)
        lo += n
        gate = torch.matmul(xe, w1[e].to(torch.float32))
        up = torch.matmul(xe, w3[e].to(torch.float32))
        hidden = (torch.nn.functional.silu(gate) * up).to(dt)
        outs.append(torch.matmul(hidden.to(torch.float32), w2[e].to(torch.float32)))
    return torch.cat(outs, dim=0)


def moe_ffn_ragged(x, gate_w, w1, w3, w2, k: int = 2,
                   balance_weight: Optional[float] = None):
    """Exact top-k MoE by sorting rows by expert and one product per expert.
    x (T, d); gate_w (d, E); w1 / w3 (E, d, h); w2 (E, h, d). Returns (out
    (T, d) in x's dtype, aux loss or None)."""
    t, d = x.shape
    e = gate_w.shape[1]
    weights, idx, scores = _route(x, gate_w, k)
    flat = idx.reshape(-1).to(torch.int64)
    order = torch.argsort(flat, stable=True)
    token_of = order // k
    xs = x[token_of]
    group_sizes = torch.bincount(flat, minlength=e).tolist()
    _record(idx, scores, [n > 0 for n in group_sizes])
    ys = _swiglu_expert_ragged(xs, w1, w3, w2, group_sizes)
    ys = ys * weights.reshape(-1)[order][:, None]
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device).index_add(0, token_of, ys)
    aux = None if balance_weight is None else load_balancing_loss(scores, idx, e, k,
                                                                  balance_weight)
    return out.to(x.dtype), aux


def moe_ffn_dense(x, gate_w, w1, w3, w2, k: int = 2,
                  balance_weight: Optional[float] = None):
    """Exact top-k MoE by per-expert masked compute: every expert on every
    row, the rows it was not chosen for zeroed by the combine weights."""
    e = gate_w.shape[1]
    weights, idx, scores = _route(x, gate_w, k)
    combine = _combine(weights, idx, e)
    if _routing_log is not None:
        _record(idx, scores, combine.sum(dim=0) > 0)
    dt, xf = x.dtype, x.to(torch.float32)
    gate = torch.einsum("td,edh->eth", xf, w1.to(torch.float32))
    up = torch.einsum("td,edh->eth", xf, w3.to(torch.float32))
    hidden = (torch.nn.functional.silu(gate) * up).to(dt)
    outs = torch.einsum("eth,ehd->etd", hidden.to(torch.float32), w2.to(torch.float32))
    out = torch.einsum("etd,te->td", outs, combine)
    aux = None if balance_weight is None else load_balancing_loss(scores, idx, e, k,
                                                                  balance_weight)
    return out.to(dt), aux


def _qw_index(qw: QuantizedWeight, e: int) -> QuantizedWeight:
    """Per-expert 2-D weight of an (E, ...)-stacked QuantizedWeight (views)."""
    return QuantizedWeight(packed=qw.packed[e], scales=qw.scales[e], zeros=qw.zeros[e],
                           bits=qw.bits, group_size=qw.group_size, in_dim=qw.in_dim,
                           out_dim=qw.out_dim, act_dtype=qw.act_dtype, layout=qw.layout,
                           tile_k=qw.tile_k)


def _pick(qw, e: int) -> QuantizedWeight:
    return qw[e] if isinstance(qw, (list, tuple)) else _qw_index(qw, e)


GATED_ROWS = 16   # row 1's GEMV, which takes a gate, serves up to 16 rows


def device_gated(x: torch.Tensor, qw1, qw3, qw2) -> bool:
    """Whether ``moe_ffn_quant`` decides the touched-expert skip on the card:
    folded W4 experts at most GATED_ROWS rows of x on a CUDA device (row 1's
    GEMV takes the gate). Elsewhere the mask is read on the host."""
    if not (x.is_cuda and x.shape[0] <= GATED_ROWS):
        return False
    return all(_pick(qw, 0).layout == "folded" for qw in (qw1, qw3, qw2))


def _gated_matmul(x, qw: QuantizedWeight, gate: torch.Tensor) -> torch.Tensor:
    from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm

    x2d = x.to(qw.act_dtype)
    return planes_qmm(x2d, qw.packed, qw.scales, qw.zeros, in_dim=qw.in_dim,
                      group_size=qw.group_size, gate=gate)


def moe_ffn_quant(x, gate_w, qw1, qw3, qw2, k: int = 2,
                  balance_weight: Optional[float] = None):
    """Top-k MoE over quantized experts: a tuple of per-expert
    QuantizedWeights each (``quant.quantize_params``' form), or one stacked on
    a leading expert axis. Each touched expert runs its three quantized
    products on all T rows; its output, weighted by the combine column, is
    summed in f32. An untouched expert reads no weight byte: its launches go
    out gated by the touched mask on the card (``device_gated``), or not at
    all where the host reads the mask (see the module docstring)."""
    t, d = x.shape
    e = gate_w.shape[1]
    weights, idx, scores = _route(x, gate_w, k)
    combine = _combine(weights, idx, e)
    touched = combine.sum(dim=0) > 0
    _record(idx, scores, touched)
    if device_gated(x, qw1, qw3, qw2):
        gates = touched.to(torch.int32)
        experts = range(e)

        def matmul(xx, qw, ei):
            return _gated_matmul(xx, qw, gates[ei])
    else:
        experts = [ei for ei, hit in enumerate(touched.tolist()) if hit]   # the one host read

        def matmul(xx, qw, ei):
            return quant_matmul(xx, qw)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for ei in experts:
        q1, q3, q2 = _pick(qw1, ei), _pick(qw3, ei), _pick(qw2, ei)
        gate = torch.nn.functional.silu(matmul(x, q1, ei).to(torch.float32))
        up = matmul(x, q3, ei).to(torch.float32)
        y = matmul((gate * up).to(x.dtype), q2, ei)
        out = out + combine[:, ei:ei + 1] * y.to(torch.float32)
    aux = None if balance_weight is None else load_balancing_loss(scores, idx, e, k,
                                                                  balance_weight)
    return out.to(x.dtype), aux


def _quantized(w) -> bool:
    return isinstance(w, QuantizedWeight) or (
        isinstance(w, (list, tuple)) and len(w) > 0 and isinstance(w[0], QuantizedWeight))


def moe_ffn(x, gate_w, w1, w3, w2, k: int = 2, balance_weight: Optional[float] = None,
            impl: str = "ragged"):
    """Dispatch entry. ``impl``: "ragged" (sorted groups) or "dense" (masked,
    every expert on every row) for dense experts; quantized experts always
    take ``moe_ffn_quant``."""
    if _quantized(w1):
        return moe_ffn_quant(x, gate_w, w1, w3, w2, k=k, balance_weight=balance_weight)
    if impl not in ("ragged", "dense"):
        raise ValueError(f"moe impl {impl!r}: 'ragged' or 'dense'")
    fn = moe_ffn_ragged if impl == "ragged" else moe_ffn_dense
    return fn(x, gate_w, w1, w3, w2, k=k, balance_weight=balance_weight)
