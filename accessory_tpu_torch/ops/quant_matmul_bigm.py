"""W4A16 matmul for many rows (M >= 1024: a batched prefill).

Port of ``accessory_tpu/ops/quant_matmul_bigm.py::planes_qmm_bigm``. The CUDA
kernel is ``csrc/w4_matmul_bigm.cu`` (a 128-row tile, so a dequantized weight
stage is shared by twice the rows of ``planes_qmm``'s tile kernel);
``planes_qmm_bigm_plain`` is its plain PyTorch version and the path for
tensors on the CPU.

Numerics are the TPU kernel's and differ from ``planes_qmm``'s: here every
weight is dequantized ``w = q * s - zs`` in f32 and rounded once to bf16, and
``x @ w`` accumulates in f32 over the whole of K before one cast to the
activation type; ``planes_qmm`` keeps q exact and applies the scale per group
in f32. The two are kept apart on purpose. No prologue, no epilogue: callers
(``ops.linear.module_linear_nr``) use the unfused composition around it.

The JAX package's ``bigm_supported`` is a budget of TPU VMEM for the
dequantized (K, tn) panel; the kernel here stages (64, 128) pieces in shared
memory and has no limit on K.
"""

from __future__ import annotations

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.quant.qtensor import QuantizedWeight, dequantize_weight

_ARGS = [kernels.P, kernels.I, kernels.I, kernels.L, kernels.P, kernels.P, kernels.P,
         kernels.I, kernels.I, kernels.P, kernels.P]


def planes_qmm_bigm(x2d: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                    zs: torch.Tensor, *, in_dim: int, group_size: int) -> torch.Tensor:
    """x2d (M, Kx) @ folded W4 (in_dim, N) -> (M, N) in x2d's dtype, any M.

    packed (in_dim/8, N) int32 words; scales/zs (>= in_dim/gs, N) f32;
    Kx <= in_dim (missing columns count as zero)."""
    if x2d.device.type == "cpu":
        return planes_qmm_bigm_plain(x2d, packed, scales, zs, in_dim=in_dim,
                                     group_size=group_size)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"planes_qmm_bigm: no kernel for device {x2d.device}")
    m, kx = x2d.shape
    n = packed.shape[1]
    _check(m >= 1 and x2d.dtype == torch.bfloat16 and x2d.stride(1) == 1
           and x2d.stride(0) % 8 == 0 and x2d.data_ptr() % 16 == 0,
           "x2d must be bf16 with 16-byte aligned rows")
    _check(kx <= in_dim and kx % group_size == 0 and group_size % 64 == 0,
           f"Kx {kx} must be <= in_dim {in_dim} and a multiple of group_size "
           f"{group_size}, itself a multiple of 64")
    _check(all(t.device == x2d.device for t in (packed, scales, zs)),
           f"every operand must be on x2d's device ({x2d.device})")
    _check(packed.dtype == torch.int32 and packed.is_contiguous()
           and packed.shape[0] * 8 >= in_dim, "packed must be contiguous int32 (in_dim/8, N)")
    for t in (scales, zs):
        _check(t.dtype == torch.float32 and t.is_contiguous() and t.shape[1] == n
               and t.shape[0] >= in_dim // group_size, "scales/zs must be contiguous f32 (G, N)")
    _check(n % 128 == 0, f"N {n} must be a multiple of the kernel's 128-column tile")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2d.device)
    fn = kernels.function("w4_matmul_bigm", "w4_matmul_bigm", _ARGS)
    rc = fn(x2d.data_ptr(), m, kx, x2d.stride(0), packed.data_ptr(), scales.data_ptr(),
            zs.data_ptr(), n, group_size, out.data_ptr(), kernels.stream_ptr(x2d))
    kernels.check("w4_matmul_bigm", rc)
    return out


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


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"planes_qmm_bigm: {msg}")
