"""Writes of new tokens into the paged KV cache: every layer's k/v of a
forward, each token at its page and offset, in place.

Port of ``accessory_tpu/ops/paged_write.py::paged_write_tokens`` (``_write_kv``
/ ``_kernel`` for the values, ``_write_scales`` / ``_kernel_scales`` for the
int8 pools' scales). k_new / v_new (L, b, s, nkv, hd); pools (L, nkv, P, ps,
hd) in the port's token-major layout, int8 pools with f32 scale pools
(L, nkv, P, ps); ``page_indices`` (b, pages_per_seq); ``start_pos`` (b,) the
position of each slot's first new token. A position past the page table's
last page goes to the TRASH page 0, as a masked write of the reference's XLA
path would. int8 pools quantize the tokens on the way (quantize_kv_chunk).
Returns the pools, written in place.

CUDA kernel: ``csrc/paged_write.cu`` (``paged_write``, and ``paged_write_q8``,
which quantizes and stores values and scales in one launch), for any s (the
reference routes only s <= 16 to its kernel: its XLA scatter copies whole
pools, a TPU trade-off that does not carry over). ``paged_write_tokens_plain``
is an indexed store per pool and runs for tensors on the CPU.
"""

from __future__ import annotations

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops.decode_attention import _device_route, quantize_kv_chunk

P, I, L = kernels.P, kernels.I, kernels.L
# k, v (pointer, layer / batch / token strides) + pools + start, page table
# + PPS L B S NKV HD P PS + stream
_SRC = [P, L, L, L] * 2
_ARGS = _SRC + [P, P] + [P, P] + [I] * 8 + [P]
_ARGS8 = _SRC + [P, P, P, P] + [P, P] + [I] * 8 + [P]


def paged_write_tokens(k_pages, v_pages, k_new, v_new, page_indices, start_pos, ks_pages=None,
                       vs_pages=None):
    """Store (L, b, s, nkv, hd) new tokens into the pools (module docstring).
    Returns (k_pages, v_pages) or, with int8 scale pools, the four pools."""
    if not _device_route("paged_write_tokens", k_new):
        return paged_write_tokens_plain(k_pages, v_pages, k_new, v_new, page_indices, start_pos,
                                        ks_pages, vs_pages)
    n_layers, b, s, nkv, hd = k_new.shape
    int8 = ks_pages is not None
    pools = (k_pages, v_pages) + ((ks_pages, vs_pages) if int8 else ())
    n_pages, ps = k_pages.shape[2], k_pages.shape[3]
    shape = (n_layers, nkv, n_pages, ps, hd)
    # bf16: 16-byte pieces; int8: hd / 32 elements a lane
    align = hd // 32 if int8 else 8
    ok = ((hd in (64, 128, 256) if int8 else hd % 8 == 0)
          and all(t.dtype == (torch.int8 if int8 else torch.bfloat16) and t.is_contiguous()
                  and t.data_ptr() % 16 == 0 and tuple(t.shape) == shape
                  for t in (k_pages, v_pages))
          and all(t.dtype == torch.float32 and t.is_contiguous() and tuple(t.shape) == shape[:-1]
                  for t in pools[2:])
          and all(t.dtype == torch.bfloat16 and tuple(t.shape) == tuple(k_new.shape)
                  and t.stride(4) == 1 and t.stride(3) == hd
                  and all(st % align == 0 for st in t.stride()[:3])
                  and t.data_ptr() % (2 * align) == 0 for t in (k_new, v_new))
          and start_pos.dtype == torch.int32 and tuple(start_pos.shape) == (b,)
          and start_pos.is_contiguous()
          and page_indices.dtype == torch.int32 and page_indices.ndim == 2
          and page_indices.shape[0] == b and page_indices.stride(1) == 1
          and all(t.device == k_new.device for t in pools + (v_new, start_pos, page_indices)))
    if not ok:
        raise ValueError(
            "paged_write_tokens: needs bf16 k/v (L,b,s,nkv,hd) with contiguous, aligned heads, "
            "contiguous 16-byte aligned pools (L,nkv,P,ps,hd) (bf16 with hd % 8 == 0, or int8 "
            "with f32 scale pools (L,nkv,P,ps) and hd 64/128/256), int32 start (b,) and page "
            f"table (b,pps), all on one device; got {tuple(k_new.shape)} {k_new.dtype} into "
            f"{tuple(k_pages.shape)} {k_pages.dtype}, start {start_pos.dtype}, page table "
            f"{page_indices.dtype}")
    name = "paged_write_q8" if int8 else "paged_write"
    rc = kernels.function("paged_write", name, _ARGS8 if int8 else _ARGS)(
        k_new.data_ptr(), *k_new.stride()[:3], v_new.data_ptr(), *v_new.stride()[:3],
        *(t.data_ptr() for t in pools), start_pos.data_ptr(), page_indices.data_ptr(),
        page_indices.stride(0), n_layers, b, s, nkv, hd, n_pages, ps, kernels.stream_ptr(k_new))
    kernels.check(name, rc)
    return pools


def token_slots(page_indices, start_pos, s: int, page_size: int):
    """(physical page, offset) of token j of every slot at start_pos + j,
    each (b * s,) int64: positions past the table's last page map to the
    TRASH page 0."""
    pps = page_indices.shape[1]
    pos = start_pos.to(torch.int64)[:, None] + torch.arange(s, device=start_pos.device)[None, :]
    lp = pos // page_size
    page = torch.gather(page_indices.to(torch.int64), 1, lp.clamp(max=pps - 1))
    page = torch.where(lp < pps, page, torch.zeros_like(page))
    return page.reshape(-1), (pos % page_size).reshape(-1)


def paged_write_tokens_plain(k_pages, v_pages, k_new, v_new, page_indices, start_pos,
                             ks_pages=None, vs_pages=None):
    """Plain version: quantize_kv_chunk for int8 pools, then one indexed
    store per pool."""
    n_layers, b, s, nkv, hd = k_new.shape
    page, off = token_slots(page_indices, start_pos, s, k_pages.shape[3])
    if ks_pages is not None:
        k_new, ksc = quantize_kv_chunk(k_new)
        v_new, vsc = quantize_kv_chunk(v_new)
    kn = k_new.permute(0, 3, 1, 2, 4).reshape(n_layers, nkv, b * s, hd)
    vn = v_new.permute(0, 3, 1, 2, 4).reshape(n_layers, nkv, b * s, hd)
    k_pages[:, :, page, off] = kn.to(k_pages.dtype)
    v_pages[:, :, page, off] = vn.to(v_pages.dtype)
    if ks_pages is None:
        return k_pages, v_pages
    ks_pages[:, :, page, off] = ksc.permute(0, 3, 1, 2).reshape(n_layers, nkv, b * s)
    vs_pages[:, :, page, off] = vsc.permute(0, 3, 1, 2).reshape(n_layers, nkv, b * s)
    return k_pages, v_pages, ks_pages, vs_pages
