"""Decode attention over the paged KV cache: the new tokens of each slot
attend to the slot's cached tokens, read through its page table from
read-only pools, and causally to each other.

Port of ``accessory_tpu/ops/paged_decode.py::paged_decode_attention``
(``_paged_kernel`` over bf16 pools, ``_paged_kernel8`` over int8 pools with
per-token f32 scales, their epilogue ``_finish``). The contract is the
reference's: q (b, sq, nq, hd), k_new / v_new (b, sq, nkv, hd) the chunk's
own k/v (not yet in the pools), ``lengths_old`` (b,) the cached tokens before
the chunk, ``page_indices`` (b, pages_per_seq), ``active_pages`` the number of
logical pages read (None: all). sq == 1 is a decode step; 1 < sq serves the
speculative-verify dispatch and short continuation chunks. Returns
(b, sq, nq, hd).

Pools are the port's token-major layout (engine/kvcache.py): (NKV, P, ps, HD)
for one layer, or the stacked (L, NKV, P, ps, HD) with ``layer`` the index
(a layer of the stacked tensor is a free view here); int8 scale pools
(…, NKV, P, ps) f32.

CUDA kernel: ``csrc/paged_decode.cu`` (entries ``paged_decode`` and
``paged_decode8``). ``paged_decode_attention_plain`` follows the TPU kernel's
op order (a page at a time, online softmax, masked scores at the finite
-1e30, then the new tokens' part) and runs for tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops.decode_attention import _device_route

NEG_INF = -1e30

P, I, L, F = kernels.P, kernels.I, kernels.L, kernels.F
# q, k_new, v_new (pointer, batch stride, token stride) + pools + lengths, page table
# + PPS J B NKV P PS SQ R HD + softmax scale, out, stream
_HEAD = [P, L, L] * 3
_TAIL = [I] * 9 + [F, P, P]
_ARGS = _HEAD + [P, P] + [P, P] + _TAIL
_ARGS8 = _HEAD + [P, P, P, P] + [P, P] + _TAIL


def _layer_view(pools, layer):
    return tuple(p if p is None or layer is None else p[layer] for p in pools)


def paged_decode_attention(q, k_new, v_new, k_pages, v_pages, lengths_old, page_indices,
                           active_pages: Optional[int] = None, ks_pages=None, vs_pages=None,
                           layer: Optional[int] = None):
    """Attention of sq new tokens per slot over its pages plus the new tokens
    (module docstring). The pools are only read."""
    if not _device_route("paged_decode_attention", q):
        return paged_decode_attention_plain(q, k_new, v_new, k_pages, v_pages, lengths_old,
                                            page_indices, active_pages, ks_pages, vs_pages, layer)
    k_pages, v_pages, ks_pages, vs_pages = _layer_view((k_pages, v_pages, ks_pages, vs_pages),
                                                       layer)
    b, sq, nq, hd = q.shape
    nkv, n_pages, ps = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    pps = page_indices.shape[-1]
    j = pps if active_pages is None else int(active_pages)
    int8 = ks_pages is not None
    pool_dtype = torch.int8 if int8 else torch.bfloat16
    dev = q.device
    ok = (k_pages.ndim == 4 and nkv > 0 and nq % nkv == 0 and hd in (64, 128)
          and 1 <= j <= pps
          and all(t.dtype == pool_dtype and t.is_contiguous() and t.data_ptr() % 16 == 0
                  and tuple(t.shape) == (nkv, n_pages, ps, hd) for t in (k_pages, v_pages))
          and (not int8 or all(t is not None and t.dtype == torch.float32 and t.is_contiguous()
                               and tuple(t.shape) == (nkv, n_pages, ps)
                               for t in (ks_pages, vs_pages)))
          and lengths_old.dtype == torch.int32 and tuple(lengths_old.shape) == (b,)
          and lengths_old.is_contiguous()
          and page_indices.dtype == torch.int32 and page_indices.ndim == 2
          and page_indices.shape[0] == b and page_indices.stride(1) == 1)
    for t, heads in ((q, nq), (k_new, nkv), (v_new, nkv)):
        ok = ok and (t.dtype == torch.bfloat16 and tuple(t.shape) == (b, sq, heads, hd)
                     and t.stride(3) == 1 and t.stride(2) == hd)
    ok = ok and all(t.device == dev for t in (k_new, v_new, k_pages, v_pages, lengths_old,
                                             page_indices) + ((ks_pages, vs_pages) if int8 else ()))
    if not ok:
        raise ValueError(
            "paged_decode_attention: needs bf16 q (b,sq,nq,hd) and k/v (b,sq,nkv,hd) with "
            "contiguous heads, contiguous 16-byte aligned pools (nkv,P,ps,hd) (bf16, or int8 "
            "with f32 scale pools (nkv,P,ps)), int32 lengths (b,) and page table (b,pps), all "
            f"on one device, hd 64/128, 1 <= active_pages <= pps; got q {tuple(q.shape)} "
            f"{q.dtype}, pools {tuple(k_pages.shape)} {k_pages.dtype}, lengths "
            f"{lengths_old.dtype}, page table {tuple(page_indices.shape)} {page_indices.dtype}, "
            f"active_pages {active_pages}")
    out = torch.empty((b, sq, nq, hd), dtype=torch.bfloat16, device=dev)
    pools = (k_pages, v_pages) + ((ks_pages, vs_pages) if int8 else ())
    name = "paged_decode8" if int8 else "paged_decode"
    rc = kernels.function("paged_decode", name, _ARGS8 if int8 else _ARGS)(
        q.data_ptr(), q.stride(0), q.stride(1), k_new.data_ptr(), k_new.stride(0),
        k_new.stride(1), v_new.data_ptr(), v_new.stride(0), v_new.stride(1),
        *(t.data_ptr() for t in pools), lengths_old.data_ptr(), page_indices.data_ptr(),
        page_indices.stride(0), j, b, nkv, n_pages, ps, sq, nq // nkv, hd, hd ** -0.5,
        out.data_ptr(), kernels.stream_ptr(q))
    kernels.check(name, rc)
    return out


def paged_decode_attention_plain(q, k_new, v_new, k_pages, v_pages, lengths_old, page_indices,
                                 active_pages: Optional[int] = None, ks_pages=None,
                                 vs_pages=None, layer: Optional[int] = None):
    """Plain version, the TPU kernel's op order: for each logical page j <
    active_pages, every slot's page is scored in f32 (int8: the k scale times
    the softmax scale multiplies the score), columns at or past the slot's
    length masked to -1e30, folded into an online softmax with p cast to the
    pool's dtype (int8: p * v scale cast to bf16) for the value product; then
    the new tokens' scores, causal among them, join exactly (_finish)."""
    k_pages, v_pages, ks_pages, vs_pages = _layer_view((k_pages, v_pages, ks_pages, vs_pages),
                                                       layer)
    b, sq, nq, hd = q.shape
    nkv = k_new.shape[2]
    r = nq // nkv
    rows = sq * r
    ps = k_pages.shape[2]
    pt = page_indices if active_pages is None else page_indices[:, :active_pages]
    scale = hd ** -0.5
    int8 = ks_pages is not None
    # row t * r + g is query token t, group member g
    qg = q.reshape(b, sq, nkv, r, hd).transpose(1, 2).reshape(b, nkv, rows, hd).to(torch.float32)
    m = torch.full((b, nkv, rows, 1), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros_like(m)
    acc = torch.zeros((b, nkv, rows, hd), dtype=torch.float32, device=q.device)
    length = lengths_old.to(torch.int64)[:, None, None, None]
    cols = torch.arange(ps, device=q.device)
    for j in range(pt.shape[1]):
        page = pt[:, j].to(torch.int64)
        kc = k_pages[:, page].transpose(0, 1)                        # (b, nkv, ps, hd)
        vc = v_pages[:, page].transpose(0, 1)
        if int8:
            kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)   # exact widening
            ksc = ks_pages[:, page].transpose(0, 1)[:, :, None, :]  # (b, nkv, 1, ps)
            vsc = vs_pages[:, page].transpose(0, 1)[:, :, None, :]
            s = torch.einsum("bkmh,bksh->bkms", qg, kc.to(torch.float32)) * (ksc * scale)
        else:
            s = torch.einsum("bkmh,bksh->bkms", qg, kc.to(torch.float32)) * scale
        s = torch.where(j * ps + cols < length, s, torch.full_like(s, NEG_INF))
        m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        denom = denom * alpha + p.sum(dim=-1, keepdim=True)
        pr = (p * vsc).to(torch.bfloat16) if int8 else p.to(vc.dtype)
        acc = acc * alpha + torch.einsum("bkms,bksh->bkmh", pr.to(torch.float32),
                                         vc.to(torch.float32))
        m = m_cur
    # _finish: the chunk's own tokens, causal among them
    kn = k_new.transpose(1, 2).to(torch.float32)                     # (b, nkv, sq, hd)
    vn = v_new.transpose(1, 2).to(torch.float32)
    s_new = torch.einsum("bkmh,bkth->bkmt", qg, kn) * scale          # (b, nkv, rows, sq)
    rowt = torch.arange(rows, device=q.device)[:, None] // r
    colt = torch.arange(sq, device=q.device)[None, :]
    s_new = torch.where(colt <= rowt, s_new, torch.full_like(s_new, NEG_INF))
    m_fin = torch.maximum(m, s_new.amax(dim=-1, keepdim=True))
    a_fin = torch.exp(m - m_fin)
    p_new = torch.exp(s_new - m_fin)
    denom = denom * a_fin + p_new.sum(dim=-1, keepdim=True)
    out = acc * a_fin + torch.einsum("bkmt,bkth->bkmh", p_new, vn)
    out = (out / denom).to(q.dtype)
    return out.reshape(b, nkv, sq, r, hd).transpose(1, 2).reshape(b, sq, nq, hd)
