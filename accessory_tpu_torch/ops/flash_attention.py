"""Causal self-attention with native GQA (prefill at position 0, and the
cache-free training forward), with its backward.

Port of ``accessory_tpu/ops/flash_attention.py::flash_attention_tpu`` (which
calls JAX's bundled TPU splash kernel, custom VJP and all). The CUDA kernels
are ``csrc/flash_attention.cu`` (forward, a warp-specialized ``wgmma`` kernel
fed by TMA, its launch plan ``fwd_plan``; for training it also stores each
row's f32 log-sum-exp) and ``csrc/flash_attention_bwd.cu`` (dq, then dk / dv
summed over each KV head's group: the same TMA + ``wgmma`` design, its plan
``bwd_plan``). On a CPU tensor the plain versions run:
``ops.attention.grouped_attention`` forward and ``flash_attention_bwd_plain``,
the explicit backward formula over P recomputed from the lse. The kernels
mask a ragged end themselves, so every length is served (the TPU path padded
to 128 and required q_len >= 128).

``flash_attention`` is differentiable in q, k and v (``_FlashAttention``);
called where no gradient is wanted (serving) it runs the forward alone,
without the lse.

``flash_attention_cp`` is one context-parallel shard of the same attention
(port of ``accessory_tpu/parallel/context.py::_splash_cp_kernel``, the splash
kernel with ``q_seq_shards``): the shard's query rows at global positions
``q_offset`` onwards against the all-gathered keys, forward and backward
(``flash_attention_bwd(..., q_offset=)``) through the same two CUDA sources, whose bodies
take a query offset and a longer key axis (entries ``flash_attention_cp_fwd``,
``flash_attention_cp_bwd_dq``, ``flash_attention_cp_bwd_dkdv``). One set of
wrappers serves both: ``q_offset=None`` launches the flash entries (as many
keys as queries), an int the cp entries, so each shows its own launch count.
Its plain versions are ``grouped_attention(..., q_offset=)`` (the JAX package's XLA
branch of ``cp_attention``) and ``flash_attention_bwd_plain(..., q_offset=)``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops.attention import NEG_INF, grouped_attention
from accessory_tpu_torch.ops.w4_tile import SMS
from accessory_tpu_torch.util import replayed

_P, _L, _I, _F = kernels.P, kernels.L, kernels.I, kernels.F
_ARGS = [_P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _I, _I, _I, _I, _I, _F, _P, _I, _I, _P]
_BWD_DQ_ARGS = [_P, _L, _L] * 5 + [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
_BWD_DKDV_ARGS = [_P, _L, _L] * 4 + [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
# the cp entries: (B, SQ, SK, q_off, NQ, NKV, HD) in place of (B, S, NQ, NKV, HD)
_CP_ARGS = [_P, _L, _L] * 3 + [_P] + [_I] * 7 + [_F, _P, _I, _I, _P]
_CP_BWD_DQ_ARGS = [_P, _L, _L] * 5 + [_P, _P, _P] + [_I] * 7 + [_F, _P]
_CP_BWD_DKDV_ARGS = [_P, _L, _L] * 4 + [_P, _P, _P, _P] + [_I] * 7 + [_F, _P]


FWD_ROWS = 128          # csrc/flash_attention.cu BQ: query rows a block
FWD_KEYS = 128          # its BKV: keys a stage
FWD_KERNEL = "flash_fwd_wgmma_kernel"   # the forward kernel's name in a profiler trace
# items of at most this many key tiles run on the persistent grid (the next
# item's loads hide under this one's work); longer ones take a block each,
# and the hardware's scheduler balances the causal triangle's unequal rows
PERSISTENT_TILES = 4


@dataclass(frozen=True)
class FwdPlan:
    heads_per_block: int   # query heads of one GQA group an item packs (ph)
    positions: int         # query positions an item: FWD_ROWS / ph
    q_tiles: int           # items along the sequence
    blocks: int            # work items: q_tiles x (nq / ph) x b
    key_tiles: int         # the most key tiles an item walks (the last query tile's)
    ctas: int              # blocks, each walking items ctas apart (one each where = blocks)
    kernel: str = FWD_KERNEL


@functools.lru_cache(maxsize=4096)
def fwd_plan(b: int, sq: int, sk: int, q_offset: int, nq: int, nkv: int,
             heads_per_block: Optional[int] = None) -> FwdPlan:
    """The forward kernel's launch (a pure function of the shape). An item of
    work is 128 rows of (position, head): ``heads_per_block`` query heads of
    one GQA group, each at 128 / heads_per_block consecutive positions (a
    warpgroup's 64 rows hold whole positions, so at most 64 heads). None: the
    most heads (a power of two dividing nq / nkv) whose rows still fit 128
    with all ``sq`` positions, so a sequence shorter than an item fills it
    with the group's other heads (and its K / V are read once a group); from
    65 rows on one head an item. Items run longest first (item w: query tile
    q_tiles - 1 - w // (nq / ph * b)). Where no item walks more than
    ``PERSISTENT_TILES`` key tiles they run on a persistent grid of one block
    an SM (never more than the items), each block taking items ``ctas``
    apart, so the next item's loads hide under this one's work; longer items
    get a block each (``ctas`` = items), since a round-robin over them leaves
    the causal triangle's long rows unbalanced. Which rows share an item, and
    which block runs it, does not change a row's bits (the kernel's arithmetic
    per row is the same)."""
    r = nq // nkv
    if heads_per_block is None:
        ph = 1
        while r % (2 * ph) == 0 and 2 * ph * sq <= FWD_ROWS and 2 * ph <= FWD_ROWS // 2:
            ph *= 2
    else:
        ph = heads_per_block
    if ph < 1 or r % ph or (FWD_ROWS // 2) % ph:
        raise ValueError(f"fwd_plan: {ph} heads a block must divide the group's {r} query "
                         f"heads and a warpgroup's {FWD_ROWS // 2} rows")
    positions = FWD_ROWS // ph
    q_tiles = math.ceil(sq / positions)
    key_tiles = (min(q_offset + sq, sk) - 1) // FWD_KEYS + 1
    items = q_tiles * (nq // ph) * b
    ctas = min(SMS, items) if key_tiles <= PERSISTENT_TILES else items
    return FwdPlan(ph, positions, q_tiles, items, key_tiles, ctas)


BWD_ROWS = 128          # csrc/flash_attention_bwd.cu ROWS: an item's query / key rows
BWD_MAX_SPLIT = 4       # its MAX_SPLIT: blocks of a dk / dv cluster
BWD_QUERIES = 64        # its BQT: query rows a stage of dk / dv
BWD_KERNELS = ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel")   # in a trace


@dataclass(frozen=True)
class BwdPlan:
    b: int
    sq: int
    sk: int
    q_offset: int
    nq: int
    nkv: int
    dq_keys: int           # keys a stage of dq
    kv_queries: int        # query rows a stage of dk / dv
    dq_tiles: int          # dq items along the sequence (BWD_ROWS query rows each)
    dq_blocks: int         # dq items, a block each: dq_tiles x nq x b
    kv_tiles: int          # dk / dv items along the keys (BWD_ROWS keys each)
    kv_items: int          # kv_tiles x nkv x b
    split: int             # blocks of a dk / dv cluster, nq / nkv / split query heads each
    kv_blocks: int         # kv_items x split
    kernels: Tuple[str, str] = BWD_KERNELS

    def dq_item(self, w: int) -> Tuple[int, int, int, int]:
        """Block w of dq (the kernel's ``DqItem``): (batch row, query head,
        first row, key tiles it walks)."""
        per = self.nq * self.b
        p0 = (self.dq_tiles - 1 - w // per) * BWD_ROWS
        n_tiles = (min(self.q_offset + min(self.sq, p0 + BWD_ROWS) - 1, self.sk - 1)
                   // self.dq_keys + 1)
        return (w % per) // self.nq, (w % per) % self.nq, p0, n_tiles

    def kv_block(self, x: int) -> Tuple[int, int, int, int, Tuple[int, ...], int, int]:
        """Block x of dk / dv (the kernel's ``DkdvItem``): (batch row, kv
        head, first key, cluster rank, its query heads, its first query
        tile, query tiles a head)."""
        w, rank = divmod(x, self.split)
        per = self.nkv * self.b
        k0 = (w // per) * BWD_ROWS
        hk = (w % per) % self.nkv
        r = self.nq // self.nkv
        heads = r // self.split
        i_first = max(0, k0 - self.q_offset) // self.kv_queries
        n_qt = max(0, math.ceil(self.sq / self.kv_queries) - i_first)
        first = hk * r + rank * heads
        return ((w % per) // self.nkv, hk, k0, rank, tuple(range(first, first + heads)),
                i_first, n_qt)


@functools.lru_cache(maxsize=4096)
def bwd_plan(b: int, sq: int, sk: int, q_offset: int, nq: int, nkv: int, hd: int) -> BwdPlan:
    """The backward kernels' launches (a pure function of the shape), as
    csrc/flash_attention_bwd.cu computes them (its C entries take no plan
    arguments): dq a block per item of 128 query rows of one head, the last
    query tiles first (they see the most keys); dk / dv an item per 128 keys
    of one kv head, the first key tiles first (they see the most queries).
    Where the dk / dv items with work (key tiles up to a shard's last row)
    are fewer than the card's SMS, each item's GQA group is split over a
    cluster of ``split`` blocks (the largest divisor of nq / nkv, at most
    BWD_MAX_SPLIT, whose blocks still run in one wave on the SMS), each
    summing nq / nkv / split heads, their f32 sums added in rank order: no
    atomics, so the bits depend on the shape alone."""
    r = nq // nkv
    dq_tiles = math.ceil(sq / BWD_ROWS)
    kv_tiles = math.ceil(sk / BWD_ROWS)
    kv_items = kv_tiles * nkv * b
    work = min(kv_tiles, (q_offset + sq - 1) // BWD_ROWS + 1) * nkv * b   # items with work
    split = max(d for d in range(1, min(r, BWD_MAX_SPLIT) + 1)
                if r % d == 0 and (d == 1 or work * d <= SMS))
    # dq's keys a stage (Dq<HD>::BKV): its dQ, S and dP accumulators share a
    # thread's registers
    dq_keys = 64 if hd == 128 else 128
    return BwdPlan(b, sq, sk, q_offset, nq, nkv, dq_keys, BWD_QUERIES, dq_tiles,
                   dq_tiles * nq * b, kv_tiles, kv_items, split, kv_items * split)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention: q (b, s, nq, hd), k/v (b, s, nkv, hd) -> (b, s, nq, hd)."""
    return _attention(q, k, v, None, scale)


def flash_attention_cp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
                       scale: Optional[float] = None) -> torch.Tensor:
    """One context-parallel shard of causal attention: q (b, s_l, nq, hd) holds
    the rows at global positions q_offset .. q_offset + s_l - 1, k / v
    (b, S, nkv, hd) every key (gathered over the shards, any batch and token
    strides); row i sees keys 0 .. q_offset + i. Returns (b, s_l, nq, hd);
    differentiable in q, k and v."""
    if not isinstance(q_offset, int):
        raise ValueError(f"flash_attention_cp: q_offset {q_offset!r} must be an int")
    return _attention(q, k, v, q_offset, scale)


def _attention(q, k, v, q_offset: Optional[int], scale):
    """Differentiable where a gradient is wanted; the forward alone (no lse)
    where none is (serving)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, q_offset, scale)
    return _forward(q, k, v, scale, with_lse=False, q_offset=q_offset)[0]


class _FlashAttention(torch.autograd.Function):
    """The forward saves q, k, v, the output and the per-row lse; the
    backward is ``flash_attention_bwd`` (the splash custom VJP's role). Under
    ``remat=True`` a checkpointed layer's forward keeps its output and lse,
    and its recompute takes them back without a launch (``util.replayed``,
    kind "flash": the reference's named "splash_attn_out" residual)."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, scale):
        out, lse = replayed("flash", lambda: _forward(q, k, v, scale, with_lse=True,
                                                      q_offset=q_offset))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.q_offset, ctx.scale = q_offset, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, ctx.scale, ctx.q_offset)
        return dq, dk, dv, None, None


def _check_offset(name: str, q: torch.Tensor, k: torch.Tensor,
                  q_offset: Optional[int]) -> None:
    """As many keys as query rows (q_offset None), or the gathered keys of a
    context-parallel shard: 0 <= q_offset and q_offset + s <= S."""
    s, skv = q.shape[1], k.shape[1]
    if (q_offset is None and skv != s) or (q_offset is not None
                                           and not 0 <= q_offset <= skv - s):
        raise ValueError(f"{name}: q_offset {q_offset} with {s} query rows and {skv} keys")


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, more=(),
               q_offset: Optional[int] = None) -> None:
    """q and ``more`` (tag, tensor, heads) are (b, s, heads, hd); k / v are
    (b, S, nkv, hd) with S as ``_check_offset`` allows."""
    _check_offset(name, q, k, q_offset)
    b, s, nq, hd = q.shape
    nkv, skv = k.shape[2], k.shape[1]
    for tag, t, rows, heads in ((("q", q, s, nq), ("k", k, skv, nkv), ("v", v, skv, nkv))
                                + tuple((tg, tt, s, hh) for tg, tt, hh in more)):
        if not (t.device == q.device and t.dtype == torch.bfloat16
                and tuple(t.shape) == (b, rows, heads, hd)
                and t.stride(3) == 1 and t.stride(2) == hd and t.stride(0) % 8 == 0
                and t.stride(1) % 8 == 0 and t.data_ptr() % 16 == 0):
            raise ValueError(f"{name}: {tag} must be bf16 (b, s, heads, hd) on q's device, "
                             "with contiguous heads and 16-byte aligned token rows")
    if hd not in (64, 128) or nq % nkv:
        raise ValueError(f"{name}: head_dim {hd} (64 or 128), heads {nq}/{nkv}")


def _dims(q, k, q_offset: Optional[int]):
    """The kernels' shape arguments: (B, S, NQ, NKV, HD) of a flash entry,
    (B, SQ, SK, q_off, NQ, NKV, HD) of a cp entry."""
    b, s, nq, hd = q.shape
    if q_offset is None:
        return (b, s, nq, k.shape[2], hd)
    return (b, s, k.shape[1], q_offset, nq, k.shape[2], hd)


def _strided(t: torch.Tensor):
    return t.data_ptr(), t.stride(0), t.stride(1)


def _forward(q, k, v, scale, with_lse: bool, q_offset: Optional[int] = None,
             heads_per_block: Optional[int] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out (b, s, nq, hd), lse (b, nq, s) f32 or None): the kernel on a CUDA
    tensor (head_dim 64 or 128, else it raises: there is no other form on the
    card), the plain version on a CPU one. ``q_offset`` None launches the
    flash entry, an int the cp entry (see ``flash_attention_cp``);
    ``heads_per_block`` overrides ``fwd_plan``'s packing (the same bits)."""
    name = "flash_attention" if q_offset is None else "flash_attention_cp"
    if q.device.type == "cpu":
        _check_offset(name, q, k, q_offset)
        off = q_offset or 0
        out = grouped_attention(q, k, v, causal=True, q_offset=off, scale=scale)
        return out, (attention_lse(q, k, scale, off) if with_lse else None)
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    _check_qkv(name, q, k, v, q_offset=q_offset)
    b, s, nq, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty((b, s, nq, hd), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, nq, s), dtype=torch.float32, device=q.device) if with_lse else None
    kernels.check(name, _fwd_call(q, k, v, out, lse, scale, q_offset, heads_per_block))
    return out, lse


def _fwd_call(q, k, v, out, lse, scale: float, q_offset: Optional[int],
              heads_per_block: Optional[int] = None) -> int:
    """The forward's C call on checked operands (its return code): the flash
    entry (``q_offset`` None) or the cp entry, with ``fwd_plan``'s heads a
    block."""
    b, s, nq, _ = q.shape
    plan = fwd_plan(b, s, k.shape[1], q_offset or 0, nq, k.shape[2], heads_per_block)
    fn = kernels.function("flash_attention",
                          "flash_attention_fwd" if q_offset is None else "flash_attention_cp_fwd",
                          _ARGS if q_offset is None else _CP_ARGS)
    return fn(*_strided(q), *_strided(k), *_strided(v), out.data_ptr(), *_dims(q, k, q_offset),
              scale, None if lse is None else lse.data_ptr(), plan.heads_per_block, plan.ctas,
              kernels.stream_ptr(q))


def attention_lse(q: torch.Tensor, k: torch.Tensor, scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Per-row log-sum-exp (b, nq, s) f32 of the causal scaled scores, the
    plain counterpart of the forward kernel's lse output (q's rows at global
    positions ``q_offset`` onwards)."""
    b, s, nq, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    scores = _scores(q, k, scale, q_offset)
    return torch.logsumexp(scores, dim=-1).reshape(b, nq, s)


def _scores(q, k, scale, q_offset: int = 0):
    """Causal scaled scores (b, nkv, R, sq, sk) f32, masked with NEG_INF: query
    row i (global position q_offset + i) sees keys 0 .. q_offset + i."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, nq // nkv, hd).to(torch.float32)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg, k.to(torch.float32)) * scale
    qi = q_offset + torch.arange(s, device=q.device)
    causal = torch.arange(k.shape[1], device=q.device)[None, :] <= qi[:, None]
    return torch.where(causal, scores, torch.full_like(scores, NEG_INF))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor, scale: Optional[float] = None,
                        q_offset: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq (b, s, nq, hd), dk / dv (b, s, nkv, hd) of causal attention, from the
    forward's output and f32 lse (b, nq, s): two kernel launches on a CUDA
    tensor (dq with D = rowsum(dout * out), then dk / dv), the plain formula
    on a CPU one. With ``q_offset`` (a context-parallel shard: the cp
    entries) k / v are the gathered (b, S, nkv, hd) and dk / dv this shard's
    part of every key's gradient, zero for keys past its last row; the caller
    sums the shards' parts (a reduce-scatter)."""
    name = "flash_attention_bwd" if q_offset is None else "flash_attention_cp_bwd"
    if q.device.type == "cpu":
        _check_offset(name, q, k, q_offset)
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, scale, q_offset or 0)
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    dout = dout.contiguous()
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    _check_qkv(name, q, k, v, (("out", out, nq), ("dout", dout, nq)), q_offset=q_offset)
    if not (lse.device == q.device and lse.dtype == torch.float32 and lse.is_contiguous()
            and tuple(lse.shape) == (b, nq, s)):
        raise ValueError(f"{name}: lse must be contiguous f32 (b, nq, s)")
    scale = hd ** -0.5 if scale is None else scale
    d = torch.empty((b, nq, s), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, s, nq, hd), dtype=torch.bfloat16, device=q.device)
    dk = torch.empty((b, k.shape[1], nkv, hd), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty_like(dk)
    _bwd_calls(q, k, v, out, dout, lse, d, dq, dk, dv, scale, q_offset)
    return dq, dk, dv


def _bwd_calls(q, k, v, out, dout, lse, d, dq, dk, dv, scale: float,
               q_offset: Optional[int]) -> None:
    """The backward's two C calls on checked operands, in order: dq (which
    writes D), then dk / dv (which reads it); the flash entries (``q_offset``
    None) or the cp entries. Their launch plan is ``bwd_plan``'s, computed
    by the kernels from the shape."""
    name = "flash_attention_bwd" if q_offset is None else "flash_attention_cp_bwd"
    shape = (*_dims(q, k, q_offset), scale, kernels.stream_ptr(q))
    dq_args, dkdv_args = ((_BWD_DQ_ARGS, _BWD_DKDV_ARGS) if q_offset is None
                          else (_CP_BWD_DQ_ARGS, _CP_BWD_DKDV_ARGS))
    fn = kernels.function("flash_attention_bwd", f"{name}_dq", dq_args)
    rc = fn(*_strided(q), *_strided(k), *_strided(v), *_strided(out), *_strided(dout),
            lse.data_ptr(), d.data_ptr(), dq.data_ptr(), *shape)
    kernels.check(f"{name}_dq", rc)
    fn = kernels.function("flash_attention_bwd", f"{name}_dkdv", dkdv_args)
    rc = fn(*_strided(q), *_strided(k), *_strided(v), *_strided(dout), lse.data_ptr(),
            d.data_ptr(), dk.data_ptr(), dv.data_ptr(), *shape)
    kernels.check(f"{name}_dkdv", rc)


def flash_attention_bwd_plain(q, k, v, out, dout, lse, scale: Optional[float] = None,
                              q_offset: int = 0):
    """The explicit backward in f32: P = exp(S - lse) (causal), dV = P^T dO
    (P in v's dtype, as the forward's value product takes it), dP = dO V^T,
    dS = P (dP - D) with D = rowsum(dO * O), dQ = scale dS K,
    dK = scale dS^T Q, dK / dV summed over each KV head's group. It gives the
    gradients ``grouped_attention`` has under autograd, up to where bf16
    rounds. With ``q_offset`` (a context-parallel shard) q, out and dout hold
    the rows at global positions q_offset onwards and k / v every key; dk / dv
    are then this shard's part of every key's gradient."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    r = nq // nkv
    scale = hd ** -0.5 if scale is None else scale
    f32 = torch.float32
    p = torch.exp(_scores(q, k, scale, q_offset) - lse.reshape(b, nkv, r, s)[..., None])
    do = dout.reshape(b, s, nkv, r, hd).to(f32)
    dv = torch.einsum("bkrqs,bqkrh->bskh", p.to(v.dtype).to(f32), do)
    dp = torch.einsum("bqkrh,bskh->bkrqs", do, v.to(f32))
    d = (do * out.reshape(b, s, nkv, r, hd).to(f32)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (dp - d[..., None])
    dq = torch.einsum("bkrqs,bskh->bqkrh", ds, k.to(f32)) * scale
    dk = torch.einsum("bkrqs,bqkrh->bskh", ds, q.reshape(b, s, nkv, r, hd).to(f32)) * scale
    return (dq.reshape(b, s, nq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
