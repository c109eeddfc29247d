"""Context parallelism: causal attention with the sequence split over a
``cp`` mesh axis.

Port of ``accessory_tpu/parallel/context.py`` (``cp_attention``,
``make_cp_attn_fn``). There one jitted program sees global shapes and a
``shard_map`` manual over {cp, tp} gives each shard its rows; here each rank
runs its own shard eagerly and calls ``cp_attention`` with **its** part of the
sequence: q (b, S/cp, nq, hd), k / v (b, S/cp, nkv, hd), every head (the rest
of the model is replicated over tp). Per call:

1. tp > 1: the rank keeps its nq/tp query and nkv/tp kv heads, behind
   Megatron's conjugate pair: the replicated input passes unchanged forward
   and its gradient is all-reduced over tp backward (``_CopyToTP``); the
   output's heads are all-gathered over tp forward and sliced backward
   (``_GatherHeads``). (A reduce-scatter of the output's gradient would sum
   tp equal copies.)
2. K / V are all-gathered over cp (``_GatherSeq``); the backward
   reduce-scatters (sums) dk / dv, so each rank gets its own keys' gradient
   from every shard.
3. ``cp_shard_attention``: the row-26 kernel (``ops.flash_attention.
   flash_attention_cp``) at query offset cp_rank * S/cp; causal block skipping
   means late shards do more work and nothing is computed twice.

The gather is token-major: each rank sends its k as (S/cp, b, nkv, hd), so the
gathered buffer (S, b, nkv, hd) is read by the kernel in place as a strided
(b, S, nkv, hd) view (batch stride nkv * hd, token stride b * nkv * hd), with
no copy of the gathered keys for any b; the backward copies dk / dv into the
same order for the reduce-scatter. On the CPU the plain versions run (the JAX
package's XLA branch, ``attention(..., q_offset=)``), with gloo collectives.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from accessory_tpu_torch.ops.flash_attention import flash_attention_cp
from accessory_tpu_torch.parallel.mesh import axis_rank, axis_size


class _GatherSeq(torch.autograd.Function):
    """(b, s_l, h, hd) -> (b, cp * s_l, h, hd), the shards in cp-rank order;
    backward: reduce-scatter (sum) of the gradient over the same group."""

    @staticmethod
    def forward(ctx, x, group, cp):
        local = x.transpose(0, 1).contiguous()                  # (s_l, b, h, hd)
        out = torch.empty((cp * local.shape[0],) + local.shape[1:], dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, local, group=group)
        ctx.group, ctx.cp = group, cp
        return out.transpose(0, 1)                               # a strided (b, S, h, hd) view

    @staticmethod
    def backward(ctx, grad):
        full = grad.transpose(0, 1).contiguous()                 # (S, b, h, hd)
        out = torch.empty((full.shape[0] // ctx.cp,) + full.shape[1:], dtype=grad.dtype,
                          device=grad.device)
        dist.reduce_scatter_tensor(out, full, op=dist.ReduceOp.SUM, group=ctx.group)
        return out.transpose(0, 1), None, None


class _CopyToTP(torch.autograd.Function):
    """Identity forward; all-reduce (sum) of the gradient over tp backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherHeads(torch.autograd.Function):
    """(b, s, h_l, hd) -> (b, s, tp * h_l, hd), the tp ranks' heads in order;
    backward: this rank's heads of the gradient."""

    @staticmethod
    def forward(ctx, x, group, tp, rank):
        local = x.contiguous()
        b, s, h, hd = x.shape
        out = torch.empty((tp * b, s, h, hd), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, local, group=group)
        ctx.rank, ctx.heads = rank, h
        return out.view(tp, b, s, h, hd).permute(1, 2, 0, 3, 4).reshape(b, s, tp * h, hd)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.heads
        return grad[:, :, lo:lo + ctx.heads], None, None, None


def seq_shard(n: int, parts: int, index: int) -> slice:
    """Part ``index`` of ``parts`` equal parts of a length-n axis: positions
    index * n / parts .. (index + 1) * n / parts - 1. The one split that a
    context-parallel rank's batch rows (over dp), its sequence (over cp) and
    its attention's query offset all follow."""
    if parts < 1 or n % parts or not 0 <= index < parts:
        raise ValueError(f"{n} positions do not split into {parts} equal parts with a part "
                         f"{index}")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def cp_shard_attention(q: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor, cp_rank: int,
                       scale: Optional[float] = None) -> torch.Tensor:
    """One shard's step: q (b, s_l, nq, hd) the rows of shard ``cp_rank``
    (global positions cp_rank * s_l onwards), kg / vg (b, S, nkv, hd) every
    shard's keys in order. Differentiable; dk / dv cover all S keys, zero past
    the shard's last row."""
    s_l, s_all = q.shape[1], kg.shape[1]
    if s_l < 1 or s_all % s_l:
        raise ValueError(f"cp_shard_attention: {s_l} query rows against {s_all} gathered keys")
    rows = seq_shard(s_all, s_all // s_l, cp_rank)
    return flash_attention_cp(q, kg, vg, rows.start, scale)


def cp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                 cp_axis: str = "cp", tp_axis: Optional[str] = "tp",
                 scale: Optional[float] = None) -> torch.Tensor:
    """Causal self-attention of this rank's sequence shard (q (b, S/cp, nq, hd),
    k / v (b, S/cp, nkv, hd)) against the whole sequence: (b, S/cp, nq, hd).
    Drop-in for ``ops.attention.attention(q, k, v, causal=True)`` in the
    training forward of a rank that holds positions cp_rank * S/cp onwards
    (``models.llama.forward(..., attn_fn=make_cp_attn_fn(mesh))``)."""
    nq, nkv = q.shape[2], k.shape[2]
    cp = axis_size(mesh, cp_axis)
    tp = axis_size(mesh, tp_axis)
    if nq % tp or (tp > 1 and nkv % tp):
        raise ValueError(f"cp_attention: heads {nq}/{nkv} do not split over tp {tp}")
    if tp > 1:
        group, r = mesh.get_group(tp_axis), axis_rank(mesh, tp_axis)
        q, k, v = (_CopyToTP.apply(t, group) for t in (q, k, v))
        q = q[:, :, r * nq // tp:(r + 1) * nq // tp]
        k = k[:, :, r * nkv // tp:(r + 1) * nkv // tp]
        v = v[:, :, r * nkv // tp:(r + 1) * nkv // tp]
    if cp > 1:
        group = mesh.get_group(cp_axis)
        k, v = _GatherSeq.apply(k, group, cp), _GatherSeq.apply(v, group, cp)
    out = cp_shard_attention(q, k, v, axis_rank(mesh, cp_axis), scale)
    if tp > 1:
        out = _GatherHeads.apply(out, mesh.get_group(tp_axis), tp, axis_rank(mesh, tp_axis))
    return out


class CPAttention:
    """``attn_fn(q, k, v)``: ``cp_attention`` bound to a mesh and its axes,
    for ``models.llama.forward``. ``train.make_train_step`` reads ``mesh``
    and ``cp_axis`` from it to give each rank its slice of the batch and the
    sequence, and takes no other attn_fn."""

    def __init__(self, mesh, cp_axis: str = "cp", tp_axis: Optional[str] = "tp"):
        self.mesh, self.cp_axis, self.tp_axis = mesh, cp_axis, tp_axis

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return cp_attention(q, k, v, mesh=self.mesh, cp_axis=self.cp_axis, tp_axis=self.tp_axis)


def make_cp_attn_fn(mesh, cp_axis: str = "cp", tp_axis: Optional[str] = "tp") -> CPAttention:
    """Bind mesh and axes: the ``attn_fn`` of ``models.llama.forward`` and
    ``train.make_train_step`` (a ``CPAttention``)."""
    return CPAttention(mesh, cp_axis, tp_axis)
