"""W8A16 matmul with fused RMSNorm prologue, RoPE and residual epilogues.

Port of ``accessory_tpu/ops/quant_matmul_w8.py`` (``repack_for_w8``,
``w8_qmm``, ``choose_tile_k_w8``). The CUDA kernel is ``csrc/w8_matmul.cu``
(for M <= 8 rows the tensor-core GEMV of ``csrc/qgemv.cuh``, K split over a
cluster; a wgmma tile above with a row-prep pass and K split over blocks;
both by the plans of ``ops/w4_tile.py``, any M);
``w8_qmm_plain`` is its plain PyTorch version and the path for tensors on the
CPU. Both compute the TPU kernel's numerics:

    y = x @ bf16(q8 * s) - sum_g xsum_g * zs_g

with q8 = q - 128 as int8 rows (K, N), zs = (zeros - 128) * scales folded at
repack (``quant.qtensor.to_w8_layout``), each weight rounded to bf16 before
the product and f32 accumulation. Unlike the W4 planes kernel, one kernel
takes every row count, fused or not: ``quant.qtensor.quant_matmul`` sends the
1024-row prefill here unfused (``ops.linear.module_linear_nr``).
"""

from __future__ import annotations

from typing import Optional

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops import w4_tile
from accessory_tpu_torch.ops.norms import rms_norm
from accessory_tpu_torch.ops.rope import rotate_flat

_STYLES = {"": 0, "interleaved": 1, "half": 2}
_ARGS = [kernels.P, kernels.I, kernels.I, kernels.L, kernels.P, kernels.P, kernels.P,
         kernels.I, kernels.I, kernels.P, kernels.F, kernels.P, kernels.P, kernels.P,
         kernels.I, kernels.I, kernels.P, kernels.P, kernels.P, kernels.P, kernels.I,
         kernels.P]


def repack_for_w8(packed_std: torch.Tensor, in_dim: int) -> torch.Tensor:
    """Std 32-bit words of a W8 weight (``pack_int``, 4 values a word) ->
    (in_dim, N) int8 rows holding q - 128."""
    from accessory_tpu_torch.quant.qtensor import unpack_int

    return (unpack_int(packed_std, 8, in_dim) - 128).to(torch.int8)


def choose_tile_k_w8(in_dim: int, group_size: int, max_tk: int = 2048) -> int:
    """The JAX package's K tile for a W8 weight: the largest tk <= max_tk that
    is a power-of-two multiple of group_size dividing in_dim. The kernel here
    has no K tile; the value is recorded in checkpoints (``tile_k``) so the
    JAX package loads a W8 leaf as it stands."""
    tk = group_size
    while in_dim % (2 * tk) == 0 and 2 * tk <= max_tk:
        tk *= 2
    if in_dim % tk:
        raise ValueError(f"in_dim {in_dim} is not a multiple of group_size {group_size}")
    return tk


def w8_qmm(x2d: torch.Tensor, q8: torch.Tensor, scales: torch.Tensor, zs: torch.Tensor,
           norm_weight: Optional[torch.Tensor] = None,
           residual: Optional[torch.Tensor] = None,
           rope_cos: Optional[torch.Tensor] = None,
           rope_sin: Optional[torch.Tensor] = None, *, group_size: int,
           norm_eps: float = 1e-5, rope_style: str = "", rope_hd: int = 0,
           split: Optional[int] = None) -> torch.Tensor:
    """x2d (M, Kx) @ W8 (K, N) -> (M, N) in x2d's dtype.

    q8 (K, N) int8 (q - 128); scales / zs (>= K/gs, N) f32, zs = (zeros - 128)
    * scales; Kx <= K (missing columns count as zero). norm_weight (Kx,):
    RMSNorm prologue; residual (M, N): added after the cast; rope_cos /
    rope_sin (N,): decode-RoPE rows (ops.rope.rope_rows). ``split``: the K
    split on the card, the GEMV's cluster at M <= 8, the tile's above (None:
    ``w4_tile.w8_gemv_split``'s / ``w8_plan``'s)."""
    if (rope_cos is None) != (not rope_style):
        raise ValueError("rope rows and rope_style go together")
    if x2d.device.type == "cpu":
        return w8_qmm_plain(x2d, q8, scales, zs, norm_weight, residual, rope_cos, rope_sin,
                            group_size=group_size, norm_eps=norm_eps, rope_style=rope_style,
                            rope_hd=rope_hd)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"w8_qmm: no kernel for device {x2d.device}")
    m, kx = x2d.shape
    k, n = q8.shape
    _check(m >= 1 and x2d.dtype == torch.bfloat16 and x2d.stride(1) == 1
           and x2d.stride(0) % 8 == 0 and x2d.data_ptr() % 16 == 0,
           "x2d must be bf16 with 16-byte aligned rows")
    _check(0 < kx <= k and kx % group_size == 0 and group_size % 64 == 0,
           f"Kx {kx} must be <= K {k} and a multiple of group_size {group_size}, "
           "itself a multiple of 64")
    _check(all(t is None or t.device == x2d.device for t in (q8, scales, zs, norm_weight,
                                                              residual, rope_cos, rope_sin)),
           f"every operand must be on x2d's device ({x2d.device})")
    _check(q8.dtype == torch.int8 and q8.is_contiguous() and n % 8 == 0
           and q8.data_ptr() % 16 == 0, "q8 must be contiguous int8 (K, N) with N % 8 == 0")
    for t in (scales, zs):
        _check(t.dtype == torch.float32 and t.is_contiguous() and t.shape[1] == n
               and t.shape[0] >= k // group_size and t.data_ptr() % 16 == 0,
               "scales/zs must be contiguous f32 (G, N)")
    if rope_style:
        _check(rope_hd % 2 == 0 and n % rope_hd == 0
               and (rope_style != "half" or 128 % rope_hd == 0),
               f"N {n} must hold whole heads of {rope_hd} in the kernel's 128-column tile")
    for t, shape, dt in ((norm_weight, (kx,), torch.float32), (residual, (m, n), torch.bfloat16),
                         (rope_cos, (n,), torch.float32), (rope_sin, (n,), torch.float32)):
        if t is not None:
            _check(t.dtype == dt and t.is_contiguous() and tuple(t.shape) == shape,
                   f"fusion operand must be contiguous {dt} {shape}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2d.device)
    rc = _kernel_call(x2d, q8, scales, zs, norm_weight, residual, rope_cos, rope_sin, out,
                      group_size=group_size, norm_eps=norm_eps, rope_style=rope_style,
                      rope_hd=rope_hd, split=split)
    kernels.check("w8_matmul", rc)
    return out


def _kernel_call(x2d, q8, scales, zs, norm_weight, residual, rope_cos, rope_sin, out, *,
                 group_size: int, norm_eps: float, rope_style: str, rope_hd: int,
                 split: Optional[int]) -> int:
    """The C call on checked operands: M <= 8 with the GEMV's cluster split
    (``w4_tile.w8_gemv_split``, no scratch), M > 8 with the tile plan's
    scratch (the tiled x, sum(x) per group and 1 / rms, the split's
    partials) in one allocation held to the launch. Returns the C entry's
    cudaError_t."""
    m, kx = x2d.shape
    n = q8.shape[1]
    buf = xt = xsum = ws = None
    if m <= 8:
        nsplit = w4_tile.w8_gemv_split(n, kx, split)
    else:
        plan = w4_tile.w8_plan(m, n, kx, group_size, split)
        buf, xt, xsum, ws = w4_tile.scratch(plan, x2d.device, xsum=True)
        nsplit = plan.split
    fn = kernels.function("w8_matmul", "w8_matmul", _ARGS)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = fn(x2d.data_ptr(), m, kx, x2d.stride(0), q8.data_ptr(), scales.data_ptr(),
            zs.data_ptr(), n, group_size, ptr(norm_weight), norm_eps, ptr(residual),
            ptr(rope_cos), ptr(rope_sin), _STYLES[rope_style], rope_hd, out.data_ptr(), xt,
            xsum, ws, nsplit, kernels.stream_ptr(x2d))
    del buf   # the caching allocator reuses it only for later work on the stream
    return rc


def w8_dequant(q8: torch.Tensor, scales: torch.Tensor, kx: int, group_size: int,
               dtype: torch.dtype) -> torch.Tensor:
    """The kernel's weight: ``(q8 * s)`` in f32, rounded to ``dtype`` (the
    first kx rows)."""
    groups = kx // group_size
    n = q8.shape[1]
    qf = q8[:kx].to(torch.float32).reshape(groups, group_size, n)
    return (qf * scales[:groups].to(torch.float32)[:, None, :]).reshape(kx, n).to(dtype)


def w8_qmm_plain(x2d, q8, scales, zs, norm_weight=None, residual=None, rope_cos=None,
                 rope_sin=None, *, group_size: int, norm_eps: float = 1e-5,
                 rope_style: str = "", rope_hd: int = 0) -> torch.Tensor:
    """Plain PyTorch version, the TPU kernel's op order: rms_norm cast to the
    activation dtype, the weight rounded to it as q8 * s, an f32 product, the
    f32 zero-point term xsum_g @ zs, RoPE in f32 before the cast, the residual
    added in the activation dtype."""
    dtype = x2d.dtype
    if norm_weight is not None:
        x2d = rms_norm(x2d, norm_weight, norm_eps)
    m, kx = x2d.shape
    groups = kx // group_size
    xf = x2d.to(torch.float32)
    w = w8_dequant(q8, scales, kx, group_size, dtype).to(torch.float32)
    xsum = xf.reshape(m, groups, group_size).sum(dim=-1)
    acc = xf @ w - xsum @ zs[:groups].to(torch.float32)
    if rope_style:
        acc = rotate_flat(acc, rope_cos, rope_sin, rope_style, rope_hd)
    out = acc.to(dtype)
    return out if residual is None else residual.to(dtype) + out


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"w8_qmm: {msg}")
