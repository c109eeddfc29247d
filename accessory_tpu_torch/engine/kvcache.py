"""Paged KV cache: a shared page pool on the device, per-slot page tables.

Port of ``accessory_tpu/engine/kvcache.py`` (PagedKVCache, init_paged_cache,
PagePool, write_tokens, write_tokens_all_layers, paged_attention_xla,
gather_pages, paged_cached_attention). Sequences own pages on demand, so a
slot pays for the context it holds, not for max_seq_len.

The port's layout (the static cache's token-major convention; the reference
folds pages into 128-lane rows and pads its scale rows to 128 lanes, both
for the TPU's tiles):

  k_pages / v_pages:   (n_layers, n_kv, total_pages, page_size, head_dim);
                       token t of a page is row t, one contiguous row per
                       (layer, head, page, token)
  ks_pages / vs_pages: int8 pools only, (n_layers, n_kv, total_pages,
                       page_size) f32 per-token scales
  page_indices:        (slots, pages_per_seq) int32, physical page of each
                       logical page of a slot, on the device
  lengths:             (slots,) int32, tokens held by each slot, on the device

Pools are updated in place. Page 0 is the TRASH page (``PagePool``): every
unallocated table entry points at it, so idle slots and bucket tails write
there and nothing reads it unmasked.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from accessory_tpu_torch.ops.attention import cached_attention
from accessory_tpu_torch.ops.paged_decode import paged_decode_attention
from accessory_tpu_torch.ops.paged_write import paged_write_tokens, paged_write_tokens_plain
from accessory_tpu_torch.util import resolve_kv_dtype

# new tokens per slot up to which paged_cached_attention takes the paged
# decode kernel (the reference's dispatch, engine/kvcache.py:391-397)
KERNEL_MAX_SQ = 16


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor          # (L, n_kv, P, page_size, hd)
    v_pages: torch.Tensor
    page_indices: torch.Tensor     # (slots, pages_per_seq) int32
    lengths: torch.Tensor          # (slots,) int32
    ks_pages: Optional[torch.Tensor] = None   # int8 pools: (L, n_kv, P, page_size) f32
    vs_pages: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def pages_per_seq(self) -> int:
        return self.page_indices.shape[1]


def init_paged_cache(n_layers: int, n_kv: int, head_dim: int, total_pages: int, page_size: int,
                     slots: int, pages_per_seq: int, dtype=torch.bfloat16,
                     kv_dtype: Optional[str] = None, device="cuda") -> PagedKVCache:
    """A zeroed pool. When it covers the worst case the page table starts as
    the identity allocation slot * pages_per_seq + j (standalone use without a
    scheduler); an oversubscribed pool (total_pages < slots * pages_per_seq)
    starts all-zero and the scheduler's PagePool owns the table.
    ``kv_dtype="int8"``: int8 pools plus f32 scale pools (util.resolve_kv_dtype:
    None means ``dtype``)."""
    if slots * pages_per_seq <= total_pages:
        idx = (torch.arange(slots)[:, None] * pages_per_seq
               + torch.arange(pages_per_seq)[None, :]).to(torch.int32)
    else:
        idx = torch.zeros((slots, pages_per_seq), dtype=torch.int32)
    int8 = resolve_kv_dtype(kv_dtype) == "int8"
    shape = (n_layers, n_kv, total_pages, page_size, head_dim)
    pool_dtype = torch.int8 if int8 else dtype
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=pool_dtype, device=device),
        v_pages=torch.zeros(shape, dtype=pool_dtype, device=device),
        page_indices=idx.to(device),
        lengths=torch.zeros((slots,), dtype=torch.int32, device=device),
        ks_pages=torch.zeros(shape[:-1], dtype=torch.float32, device=device) if int8 else None,
        vs_pages=torch.zeros(shape[:-1], dtype=torch.float32, device=device) if int8 else None)


class PagePool:
    """Host-side free-page allocator over the device pool (the vLLM block
    manager's role). Page 0 is reserved as the TRASH page. Refcounts let the
    prefix cache share read-only prompt pages: a page frees when its last
    holder releases it. The device page table mirrors the scheduler's
    per-slot assignments."""

    TRASH = 0

    def __init__(self, total_pages: int):
        if total_pages < 2:
            raise ValueError(f"a page pool needs the TRASH page and one more, got {total_pages}")
        self.total_pages = total_pages
        self._free = list(range(total_pages - 1, 0, -1))  # a stack; page 0 reserved
        self._refs: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int):
        """n pages, or None if the pool cannot give them."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def share(self, pages) -> None:
        """One more reference to pages that are live (prefix-cache reuse)."""
        for p in pages:
            if self._refs.get(p, 0) <= 0:
                raise ValueError(f"page {p} is not live and cannot be shared")
            self._refs[p] += 1

    def release(self, pages) -> None:
        for p in pages:
            if p == self.TRASH or self._refs.get(p, 0) <= 0:
                raise ValueError(f"page {p} is not held and cannot be released")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)


def write_tokens(k_pages, v_pages, k_new, v_new, page_indices, start_pos):
    """One layer: new tokens (b, s, n_kv, hd) into pools (n_kv, P, ps, hd) at
    start_pos (b,) onwards, in place; the paged write kernel over a one-layer
    view on the card. Returns (k_pages, v_pages)."""
    paged_write_tokens(k_pages[None], v_pages[None], k_new[None], v_new[None], page_indices,
                       start_pos)
    return k_pages, v_pages


def write_tokens_plain(k_pages, v_pages, k_new, v_new, page_indices, start_pos):
    """Plain version of write_tokens: the paged write's indexed store over a
    one-layer view."""
    paged_write_tokens_plain(k_pages[None], v_pages[None], k_new[None], v_new[None],
                             page_indices, start_pos)
    return k_pages, v_pages


def write_tokens_all_layers(k_pages, v_pages, k_new, v_new, page_indices, start_pos,
                            ks_pages=None, vs_pages=None):
    """Every layer's new tokens (L, b, s, n_kv, hd) into the stacked pools in
    one call, quantized first for int8 pools (scale pools given). On the card
    this is one launch of the paged write kernel at any s; on the CPU the
    plain indexed store. Returns the pools (two, or four with int8)."""
    return paged_write_tokens(k_pages, v_pages, k_new, v_new, page_indices, start_pos,
                              ks_pages, vs_pages)


# the plain version of write_tokens_all_layers, on any device
write_tokens_all_layers_plain = paged_write_tokens_plain


def paged_attention_xla(q, k_pages, v_pages, lengths, page_indices):
    """The oracle: gather each slot's pages into a dense (b, ctx, n_kv, hd)
    view and run masked attention. q (b, nq, hd), one token per slot whose
    k/v are already in the pools; lengths include it. Plain PyTorch (XLA in
    the reference)."""
    b, nq, hd = q.shape
    n_kv = k_pages.shape[0]
    k, v = gather_pages(k_pages, v_pages, page_indices)
    ctx = k.shape[1]
    qg = q.reshape(b, n_kv, nq // n_kv, hd).to(torch.float32)
    scores = torch.einsum("bkrh,bskh->bkrs", qg, k.to(torch.float32)) * hd ** -0.5
    mask = torch.arange(ctx, device=q.device)[None, :] < lengths.to(torch.int64)[:, None]
    scores = torch.where(mask[:, None, None, :], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrs,bskh->bkrh", probs, v.to(torch.float32))
    return out.reshape(b, nq, hd).to(q.dtype)


def gather_pages(k_pages, v_pages, page_indices, active_pages: Optional[int] = None,
                 ks_pages=None, vs_pages=None):
    """Dense (b, ctx, n_kv, hd) views of each slot's first ``active_pages``
    logical pages (all by default), from one layer's pools (n_kv, P, ps, hd).
    int8 pools (scale pools given) dequantize after the gather, to bf16."""
    n_kv, _, ps, hd = k_pages.shape
    pt = page_indices if active_pages is None else page_indices[:, :active_pages]
    b, pages = pt.shape
    idx = pt.to(torch.int64)

    def dense(p):  # (n_kv, b, pages, ps, hd) -> (b, ctx, n_kv, hd)
        return p[:, idx].permute(1, 2, 3, 0, 4).reshape(b, pages * ps, n_kv, hd)

    k, v = dense(k_pages), dense(v_pages)
    if ks_pages is not None:
        ks = ks_pages[:, idx].permute(1, 2, 3, 0).reshape(b, pages * ps, n_kv)
        vs = vs_pages[:, idx].permute(1, 2, 3, 0).reshape(b, pages * ps, n_kv)
        k = (k.to(torch.float32) * ks[..., None]).to(torch.bfloat16)
        v = (v.to(torch.float32) * vs[..., None]).to(torch.bfloat16)
    return k, v


def paged_cached_attention(q, k_new, v_new, k_pages, v_pages, lengths_old, page_indices,
                           active_pages: Optional[int] = None, ks_pages=None, vs_pages=None,
                           layer: Optional[int] = None):
    """Attention of a chunk of new tokens (b, sq, ...) over read-only pools
    plus the chunk itself: the two-part softmax of ops.attention.
    cached_attention, so the model writes the pools once per forward. Up to
    KERNEL_MAX_SQ new tokens go to the paged decode kernel
    (ops.paged_decode); a longer chunk gathers the pages and takes the plain
    cached_attention on every device, the reference's own route for it.
    ``layer`` indexes stacked (L, ...) pools."""
    if q.shape[1] <= KERNEL_MAX_SQ:
        return paged_decode_attention(q, k_new, v_new, k_pages, v_pages, lengths_old,
                                      page_indices, active_pages, ks_pages, vs_pages, layer)
    if layer is not None:
        k_pages, v_pages = k_pages[layer], v_pages[layer]
        if ks_pages is not None:
            ks_pages, vs_pages = ks_pages[layer], vs_pages[layer]
    k, v = gather_pages(k_pages, v_pages, page_indices, active_pages, ks_pages, vs_pages)
    return cached_attention(q, k_new, v_new, k, v, lengths_old)
