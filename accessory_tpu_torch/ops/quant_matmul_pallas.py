"""W4A16 matmul over the std layout: the weights GPTQ / OmniQuant imports
give (``quant/omniquant.py``), zeros in quantized units and not folded.

Port of ``accessory_tpu/ops/quant_matmul_pallas.py::quant_matmul_pallas``.
The CUDA kernel is ``csrc/w4_matmul_std.cu`` (a GEMV for M <= 8 rows, the
many-row tile of ``csrc/w4_tile.cuh`` above, K split over blocks by the plan
of ``ops/w4_tile.py``); ``quant_matmul_pallas_plain`` is its plain
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


def quant_matmul_pallas(x: torch.Tensor, qw: QuantizedWeight, *,
                        split: Optional[int] = None) -> torch.Tensor:
    """x (..., Kx) @ std-layout W4 qw (in_dim, out_dim) -> (..., out_dim) in
    qw.act_dtype; Kx <= in_dim (missing columns count as zero). ``split``:
    the many-row tile's K split on the card (None: ``w4_tile.elem_plan``'s)."""
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
    _check(m <= 8 or all(t.data_ptr() % 16 == 0 for t in (qw.packed, qw.scales, qw.zeros)),
           "the many-row tile bulk-copies packed, scales and zeros rows: they must be "
           "16-byte aligned")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2d.device)
    buf = xt = ws = None
    nsplit = 1
    if m > 8:
        plan = w4_tile.elem_plan(m, n, kx, split=split)
        buf, xt, _, ws = w4_tile.scratch(plan, x2d.device, xsum=False)   # buf: held to the launch
        nsplit = plan.split
    fn = kernels.function("w4_matmul_std", "w4_matmul_std", _ARGS)
    rc = fn(x2d.data_ptr(), m, kx, x2d.stride(0), qw.packed.data_ptr(), qw.scales.data_ptr(),
            qw.zeros.data_ptr(), k, n, gs, out.data_ptr(), xt, ws, nsplit,
            kernels.stream_ptr(x2d))
    kernels.check("w4_matmul_std", rc)
    return out.reshape(*lead, n)


def quant_matmul_pallas_plain(x2d: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """Plain PyTorch version: the weight (q - z) * s rounded to x2d's dtype
    (``dequantize_weight``), an f32 product, one cast."""
    w = dequantize_weight(qw, x2d.dtype)[:x2d.shape[1]]
    return (x2d.to(torch.float32) @ w.to(torch.float32)).to(x2d.dtype)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"quant_matmul_pallas: {msg}")
