"""W4A16 matmul for many rows (M >= 1024: a batched prefill), and the
one-pass W4 dequant of the QPEFT backward.

Port of ``accessory_tpu/ops/quant_matmul_bigm.py::planes_qmm_bigm`` and
``planes_dequant``. The CUDA kernels are ``csrc/w4_matmul_bigm.cu`` (a
persistent, warp-specialized ``wgmma`` tile of 256 x rows by 128 weight
columns fed by TMA, its grid from ``ops.w4_tile.bigm_plan``) and
``csrc/w4_dequant.cu``; ``planes_qmm_bigm_plain`` and
``quant.qtensor.dequantize_weight`` are their plain PyTorch versions and the
paths for tensors on the CPU.

Numerics are the TPU kernel's and differ from ``planes_qmm``'s: here every
weight is dequantized ``w = q * s - zs`` in f32 and rounded once to bf16, and
``x @ w`` accumulates in f32 over the whole of K before one cast to the
activation type; ``planes_qmm`` keeps q exact and applies the scale per group
in f32. The two are kept apart on purpose. No prologue, no epilogue: callers
(``ops.linear.module_linear_nr``) use the unfused composition around it.

The JAX package's ``bigm_supported`` is a budget of TPU VMEM for the
dequantized (K, tn) panel; the kernel here stages 64-row pieces of K in
shared memory and has no limit on K.
"""

from __future__ import annotations

from typing import Optional

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops.w4_tile import bigm_plan
from accessory_tpu_torch.quant.qtensor import QuantizedWeight, dequantize_weight

_ARGS = [kernels.P, kernels.I, kernels.I, kernels.L, kernels.P, kernels.P, kernels.P,
         kernels.I, kernels.I, kernels.P, kernels.I, kernels.P]
_DEQUANT_ARGS = [kernels.P, kernels.P, kernels.P, kernels.P, kernels.I, kernels.I, kernels.I,
                 kernels.I, kernels.P]


def planes_qmm_bigm(x2d: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                    zs: torch.Tensor, *, in_dim: int, group_size: int,
                    ctas: Optional[int] = None) -> torch.Tensor:
    """x2d (M, Kx) @ folded W4 (in_dim, N) -> (M, N) in x2d's dtype, any M.

    packed (in_dim/8, N) int32 words; scales/zs (>= in_dim/gs, N) f32;
    Kx <= in_dim (missing columns count as zero). ``ctas``: the persistent
    grid (``w4_tile.bigm_plan``'s default when None; every grid gives the
    same bits)."""
    if x2d.device.type == "cpu":
        return planes_qmm_bigm_plain(x2d, packed, scales, zs, in_dim=in_dim,
                                     group_size=group_size)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"planes_qmm_bigm: no kernel for device {x2d.device}")
    m, kx = x2d.shape
    n = packed.shape[1]
    _check(m >= 1 and x2d.dtype == torch.bfloat16 and x2d.stride(1) == 1
           and x2d.stride(0) % 8 == 0 and x2d.stride(0) >= kx and x2d.data_ptr() % 16 == 0,
           "x2d must be bf16 with 16-byte aligned rows")
    _check(kx <= in_dim and kx % group_size == 0 and group_size % 64 == 0,
           f"Kx {kx} must be <= in_dim {in_dim} and a multiple of group_size "
           f"{group_size}, itself a multiple of 64")
    _check(all(t.device == x2d.device for t in (packed, scales, zs)),
           f"every operand must be on x2d's device ({x2d.device})")
    _check(packed.dtype == torch.int32 and packed.is_contiguous()
           and packed.shape[0] * 8 >= in_dim and packed.data_ptr() % 16 == 0,
           "packed must be contiguous int32 (in_dim/8, N), 16-byte aligned")
    for t in (scales, zs):
        _check(t.dtype == torch.float32 and t.is_contiguous() and t.shape[1] == n
               and t.shape[0] >= in_dim // group_size and t.data_ptr() % 16 == 0,
               "scales/zs must be contiguous f32 (G, N), 16-byte aligned")
    _check(n % 64 == 0, f"N {n} must be a multiple of 64 (half the kernel's 128-column tile)")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2d.device)
    kernels.check("w4_matmul_bigm", _kernel_call(x2d, packed, scales, zs, out,
                                                 group_size=group_size, ctas=ctas))
    return out


def _kernel_call(x2d, packed, scales, zs, out, *, group_size: int,
                 ctas: Optional[int] = None) -> int:
    """The C call on checked operands (its return code): the persistent grid
    of ``bigm_plan`` (the caller's ``ctas`` where given)."""
    m, kx = x2d.shape
    n = packed.shape[1]
    fn = kernels.function("w4_matmul_bigm", "w4_matmul_bigm", _ARGS)
    return fn(x2d.data_ptr(), m, kx, x2d.stride(0), packed.data_ptr(), scales.data_ptr(),
              zs.data_ptr(), n, group_size, out.data_ptr(), bigm_plan(m, n, ctas).ctas,
              kernels.stream_ptr(x2d))


def planes_qmm_bigm_plain(x2d, packed, scales, zs, *, in_dim: int,
                          group_size: int) -> torch.Tensor:
    """Plain PyTorch version, the TPU kernel's op order: the weight
    dequantized to bf16 (``dequantize_weight``), an f32 product summed over
    all of K, one cast to x2d's dtype."""
    qw = QuantizedWeight(packed=packed, scales=scales, zeros=zs, bits=4,
                         group_size=group_size, in_dim=in_dim, out_dim=packed.shape[1],
                         layout="folded")
    w = dequantize_weight(qw, torch.bfloat16)[:x2d.shape[1]]
    return (x2d.to(torch.float32) @ w.to(torch.float32)).to(x2d.dtype)


def planes_dequant(packed: torch.Tensor, scales: torch.Tensor, zs: torch.Tensor, *,
                   in_dim: int, group_size: int,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Folded W4 (in_dim, N) -> dense (in_dim, N) ``dtype`` (bf16 or f32):
    q * s - zs in f32, cast once. packed (in_dim/8, N) int32 words; scales /
    zs (>= in_dim/gs, N) f32. Bit-equal to ``dequantize_weight``, which is
    its plain version and the path for tensors on the CPU."""
    if packed.device.type == "cpu":
        qw = QuantizedWeight(packed=packed, scales=scales, zeros=zs, bits=4,
                             group_size=group_size, in_dim=in_dim, out_dim=packed.shape[1],
                             layout="folded")
        return dequantize_weight(qw, dtype)
    if packed.device.type != "cuda":
        raise RuntimeError(f"planes_dequant: no kernel for device {packed.device}")
    n = packed.shape[1]

    def check(ok, msg):
        if not ok:
            raise ValueError(f"planes_dequant: {msg}")

    check(dtype in (torch.bfloat16, torch.float32), f"dtype {dtype} (bf16 or f32)")
    check(in_dim % group_size == 0 and group_size % 8 == 0,
          f"in_dim {in_dim} must be a multiple of group_size {group_size}, itself of 8")
    check(packed.dtype == torch.int32 and packed.is_contiguous()
          and packed.shape[0] * 8 >= in_dim and n % 8 == 0 and packed.data_ptr() % 16 == 0,
          "packed must be contiguous int32 (in_dim/8, N) with N a multiple of 8")
    for t in (scales, zs):
        check(t.device == packed.device and t.dtype == torch.float32 and t.is_contiguous()
              and t.shape[1] == n and t.shape[0] >= in_dim // group_size
              and t.data_ptr() % 16 == 0, "scales/zs must be contiguous f32 (G, N) on "
              "packed's device")
    out = torch.empty((in_dim, n), dtype=dtype, device=packed.device)
    fn = kernels.function("w4_dequant", "w4_dequant", _DEQUANT_ARGS)
    rc = fn(packed.data_ptr(), scales.data_ptr(), zs.data_ptr(), out.data_ptr(), in_dim, n,
            group_size, int(dtype == torch.float32), kernels.stream_ptr(packed))
    kernels.check("w4_dequant", rc)
    return out


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"planes_qmm_bigm: {msg}")
