"""W4A16 matmul over the std layout: the weights GPTQ / OmniQuant imports
give (``quant/omniquant.py``), zeros in quantized units and not folded.

Port of ``accessory_tpu/ops/quant_matmul_pallas.py::quant_matmul_pallas``.
The CUDA kernel is ``csrc/w4_matmul_std.cu`` (a tensor-core GEMV for M <= 8
rows, the many-row tile of ``csrc/w4_tile.cuh`` above, K split over blocks by
the plans of ``ops/w4_tile.py``); ``quant_matmul_pallas_plain`` is its plain
PyTorch version and the path for tensors on the CPU. Both compute the TPU
kernel's numerics: each weight (q - z) * s in f32, rounded to the
activation dtype, then an f32 product. No prologue or epilogue.
"""

from __future__ import annotations

from typing import Optional

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops import w4_tile
from accessory_tpu_torch.quant.qtensor import QuantizedWeight, dequantize_weight

_ARGS = [kernels.P, kernels.I, kernels.I, kernels.L, kernels.P, kernels.P, kernels.P,
         kernels.I, kernels.I, kernels.I, kernels.P, kernels.P, kernels.P, kernels.I, kernels.P]
# w4_matmul_magic: the same with the magic tile tk after group_size
_MAGIC_ARGS = _ARGS[:10] + [kernels.I] + _ARGS[10:]


def quant_matmul_pallas(x: torch.Tensor, qw: QuantizedWeight, *,
                        split: Optional[int] = None) -> torch.Tensor:
    """x (..., Kx) @ std-layout W4 qw (in_dim, out_dim) -> (..., out_dim) in
    qw.act_dtype; Kx <= in_dim (missing columns count as zero). ``split``:
    the K split on the card (None: the plan's, ``w4_tile.gemv_split`` for
    the GEMV at M <= 8, ``w4_tile.elem_plan`` for the many-row tile)."""
    if qw.layout != "std" or qw.bits != 4:
        raise ValueError(f"quant_matmul_pallas takes std-layout W4 weights, not "
                         f"{qw.layout!r} W{qw.bits}")
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).to(qw.act_dtype)
    if x2d.device.type == "cpu":
        return quant_matmul_pallas_plain(x2d, qw).reshape(*lead, qw.out_dim)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"quant_matmul_pallas: no kernel for device {x2d.device}")
    m, kx = x2d.shape
    n, k, gs = qw.out_dim, qw.in_dim, qw.group_size
    _check(m >= 1 and x2d.dtype == torch.bfloat16 and x2d.stride(1) == 1
           and x2d.stride(0) % 8 == 0 and x2d.data_ptr() % 16 == 0,
           "x must be bf16 with 16-byte aligned rows")
    _check(k % 64 == 0 and gs % 64 == 0 and k % gs == 0 and 0 < kx <= k and kx % 64 == 0,
           f"in_dim {k} and Kx {kx} (<= in_dim) must be multiples of 64, in_dim of "
           f"group_size {gs}, itself a multiple of 64")
    _check(all(t.device == x2d.device for t in (qw.packed, qw.scales, qw.zeros)),
           f"every operand must be on x's device ({x2d.device})")
    _check(qw.packed.dtype == torch.int32 and qw.packed.is_contiguous()
           and tuple(qw.packed.shape) == (k // 8, n) and n % 8 == 0,
           "packed must be contiguous int32 (in_dim/8, N) words with N % 8 == 0")
    for t in (qw.scales, qw.zeros):
        _check(t.dtype == torch.float32 and t.is_contiguous() and t.shape[1] == n
               and t.shape[0] >= k // gs, "scales/zeros must be contiguous f32 (G, N)")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2d.device)
    rc = elem_kernel_call(x2d, qw.packed, qw.scales, qw.zeros, out, k=k, group_size=gs,
                          split=split)
    kernels.check("w4_matmul_std", rc)
    return out.reshape(*lead, n)


def elem_kernel_call(x2d, packed, scales, zeros, out, *, k: int, group_size: int,
                     tk: Optional[int] = None, split: Optional[int] = None) -> int:
    """The std (tk None) or magic (tile tk) C call on operands the wrapper
    checked: the 16-byte alignment every row count needs (the GEMV and the
    tile copy packed, scales and zeros rows in 16-byte pieces; rows of N
    words or floats, N % 8 == 0, are then aligned too), the plan's K split
    and, for M > 8, the tile's scratch, held to the launch. Returns the C
    entry's cudaError_t."""
    m, kx = x2d.shape
    n = packed.shape[1]
    name = "quant_matmul_pallas" if tk is None else "magic_qmm"
    if not all(t.data_ptr() % 16 == 0 for t in (packed, scales, zeros)):
        raise ValueError(f"{name}: the kernels copy packed, scales and zeros rows in 16-byte "
                         "pieces: they must be 16-byte aligned")
    buf, xt, ws, nsplit = _plan_scratch(m, n, kx, tk, split, x2d.device)
    entry = "w4_matmul_std" if tk is None else "w4_matmul_magic"
    fn = kernels.function(entry, entry, _ARGS if tk is None else _MAGIC_ARGS)
    rc = fn(x2d.data_ptr(), m, kx, x2d.stride(0), packed.data_ptr(), scales.data_ptr(),
            zeros.data_ptr(), k, n, group_size, *(() if tk is None else (tk,)), out.data_ptr(),
            xt, ws, nsplit, kernels.stream_ptr(x2d))
    del buf   # the caching allocator reuses it only for later work on the stream
    return rc


def _plan_scratch(m: int, n: int, kx: int, tk: Optional[int], split: Optional[int], device):
    """The K split of the std (tk None) or magic kernel, and for M > 8 the
    tile's scratch (one allocation: the tiled x, the split's partials):
    (buffer, xt, ws, split). The GEMV (M <= 8) splits K over a cluster and
    needs none."""
    units = w4_tile.elem_units(kx, tk)
    if m <= 8:
        return None, None, None, w4_tile.gemv_split(n, units, split)
    plan = w4_tile.elem_plan(m, n, kx, tk, split=split)
    buf, xt, _, ws = w4_tile.scratch(plan, device, xsum=False)
    return buf, xt, ws, plan.split


def quant_matmul_pallas_plain(x2d: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """Plain PyTorch version: the weight (q - z) * s rounded to x2d's dtype
    (``dequantize_weight``), an f32 product, one cast."""
    w = dequantize_weight(qw, x2d.dtype)[:x2d.shape[1]]
    return (x2d.to(torch.float32) @ w.to(torch.float32)).to(x2d.dtype)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"quant_matmul_pallas: {msg}")
