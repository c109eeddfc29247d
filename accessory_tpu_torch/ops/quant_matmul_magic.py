"""W4A16 matmul over the magic layout: the bf16 bit-pattern unpack.

Port of ``accessory_tpu/ops/quant_matmul_magic.py`` (``repack_for_magic``,
``magic_constants``, ``magic_qmm``). A nibble q becomes the bf16 value
v = 256 + 16 q by its bit pattern alone (0x4380 | q << 3), and the affine
map folds into the constants: with s' = s / 16 and z' = 256 + 16 z,
(v - z') * s' = (q - z) * s. As in the TPU kernel s' and z' are rounded to
bf16 and the weight is computed in bf16 arithmetic.

Words are packed per K tile of ``tk`` rows so that the kernel's natural
extraction order is row order: word w of a tile holds, at nibble i + 4h,
the tile's row i * tk/4 + 2w + h. The CUDA kernel is
``csrc/w4_matmul_magic.cu`` (a tensor-core GEMV for M <= 8 rows, the
many-row tile of ``csrc/w4_tile.cuh`` above, K split over blocks by the
plans of ``ops/w4_tile.py``); ``magic_qmm_plain`` is its plain PyTorch
version and the path for tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops.quant_matmul_pallas import elem_kernel_call
from accessory_tpu_torch.quant.qtensor import pack_int, unpack_int


def _perm(in_dim: int, tk: int, device) -> torch.Tensor:
    """perm[t * tk + 8w + p] = the row that magic word w of tile t holds at
    nibble p: t * tk + (p % 4) * tk/4 + 2w + p // 4."""
    if in_dim % tk or tk % 8:
        raise ValueError(f"in_dim {in_dim} must be a multiple of the magic tile {tk}, "
                         "itself a multiple of 8")
    quarter = tk // 4
    w = torch.arange(tk // 8, device=device)[:, None]
    p = torch.arange(8, device=device)[None, :]
    local = ((p % 4) * quarter + 2 * w + p // 4).reshape(-1)
    tiles = torch.arange(in_dim // tk, device=device)[:, None] * tk
    return (tiles + local[None, :]).reshape(-1)


def repack_for_magic(packed_std: torch.Tensor, in_dim: int, tk: int) -> torch.Tensor:
    """Std W4 words (``pack_int``) -> the magic per-tile word order."""
    q = unpack_int(packed_std, 4, in_dim)
    return pack_int(q[_perm(in_dim, tk, q.device)], 4)


def unpack_magic(packed: torch.Tensor, in_dim: int, tk: int) -> torch.Tensor:
    """Magic words -> (in_dim, N) int32 nibbles in row order."""
    qp = unpack_int(packed, 4, in_dim)
    q = torch.empty_like(qp)
    q[_perm(in_dim, tk, qp.device)] = qp
    return q


def magic_constants(scales: torch.Tensor, zeros: torch.Tensor):
    """Standard (s, z) -> the kernel's folded (s / 16, 256 + 16 z)."""
    return scales / 16.0, 256.0 + 16.0 * zeros


def magic_dequant(packed: torch.Tensor, scales: torch.Tensor, zeros_plus: torch.Tensor, *,
                  in_dim: int, group_size: int, tk: int) -> torch.Tensor:
    """The kernel's (in_dim, N) bf16 weight: (v - bf16(z')) * bf16(s') in bf16
    arithmetic, v = 256 + 16 q (exact in bf16)."""
    groups = in_dim // group_size
    n = packed.shape[1]
    q = unpack_magic(packed, in_dim, tk).reshape(groups, group_size, n)
    v = (256 + 16 * q).to(torch.bfloat16)
    zp = zeros_plus[:groups].to(torch.bfloat16)[:, None, :]
    s = scales[:groups].to(torch.bfloat16)[:, None, :]
    return ((v - zp) * s).reshape(in_dim, n)


def magic_qmm(x2d: torch.Tensor, packed_magic: torch.Tensor, scales: torch.Tensor,
              zeros_plus: torch.Tensor, *, group_size: int, tk: int,
              split: Optional[int] = None) -> torch.Tensor:
    """x2d (M, Kx) @ magic-packed W4 (K, N) -> (M, N) in x2d's dtype.

    packed_magic (K/8, N) int32 words (``repack_for_magic``); scales = s / 16
    and zeros_plus = 256 + 16 z, (>= K/gs, N) f32 (``magic_constants``);
    Kx <= K (missing columns count as zero). ``split``: the K split on the
    card (None: the plan's, as ``quant_matmul_pallas``)."""
    k = packed_magic.shape[0] * 8
    if x2d.device.type == "cpu":
        return magic_qmm_plain(x2d, packed_magic, scales, zeros_plus, group_size=group_size,
                               tk=tk)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"magic_qmm: no kernel for device {x2d.device}")
    m, kx = x2d.shape
    n = packed_magic.shape[1]
    _check(m >= 1 and x2d.dtype == torch.bfloat16 and x2d.stride(1) == 1
           and x2d.stride(0) % 8 == 0 and x2d.data_ptr() % 16 == 0,
           "x2d must be bf16 with 16-byte aligned rows")
    _check(group_size % 64 == 0 and tk % 4 == 0 and (tk // 4) % group_size == 0
           and k % tk == 0 and 0 < kx <= k and kx % 64 == 0,
           f"K {k} must be a multiple of the tile {tk}, (tk / 4) of group_size "
           f"{group_size}, itself a multiple of 64; Kx {kx} <= K a multiple of 64")
    _check(all(t.device == x2d.device for t in (packed_magic, scales, zeros_plus)),
           f"every operand must be on x2d's device ({x2d.device})")
    _check(packed_magic.dtype == torch.int32 and packed_magic.is_contiguous() and n % 8 == 0,
           "packed_magic must be contiguous int32 (K/8, N) with N % 8 == 0")
    for t in (scales, zeros_plus):
        _check(t.dtype == torch.float32 and t.is_contiguous() and t.shape[1] == n
               and t.shape[0] >= k // group_size, "scales/zeros_plus must be contiguous f32 (G, N)")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2d.device)
    rc = elem_kernel_call(x2d, packed_magic, scales, zeros_plus, out, k=k,
                          group_size=group_size, tk=tk, split=split)
    kernels.check("w4_matmul_magic", rc)
    return out


def magic_qmm_plain(x2d, packed_magic, scales, zeros_plus, *, group_size: int,
                    tk: int) -> torch.Tensor:
    """Plain PyTorch version: the weight of ``magic_dequant``, an f32 product,
    one cast to x2d's dtype."""
    w = magic_dequant(packed_magic, scales, zeros_plus, in_dim=packed_magic.shape[0] * 8,
                      group_size=group_size, tk=tk)[:x2d.shape[1]]
    return (x2d.to(torch.float32) @ w.to(torch.float32)).to(x2d.dtype)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"magic_qmm: {msg}")
