"""W4A16 matmul with fused RMSNorm prologue, RoPE and residual epilogues.

Port of ``accessory_tpu/ops/quant_matmul_planes.py::planes_qmm``. The CUDA
kernel is ``csrc/w4_matmul.cu`` (for M <= 16 rows the tensor-core GEMV of
``csrc/qgemv.cuh``, K split over a cluster; above, a row-prep pass and the
many-row tile of ``csrc/w4_tile.cuh``, K split over blocks; both by the plans
of ``ops/w4_tile.py``); ``planes_qmm_plain`` is its plain PyTorch
version and the path for tensors on the CPU. Both fold the zero point out
per group:

    y = sum_g  s_g * (x_g @ q_g)  -  sum(x_g) * zs_g

with q exact and f32 accumulation. Calls of BIGM_ROWS (1024) rows or more
belong to ``ops/quant_matmul_bigm.py::planes_qmm_bigm`` (other numerics: the
weight rounded to bf16, see there), which ``quant.qtensor.quant_matmul``
dispatches to when no fusion operand is given. The CUDA kernel here does not
take that many rows, so a direct call with them raises on CUDA.
"""

from __future__ import annotations

from typing import Optional

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops import w4_tile
from accessory_tpu_torch.ops.norms import rms_norm
from accessory_tpu_torch.ops.rope import rotate_flat
from accessory_tpu_torch.quant.qtensor import BIGM_ROWS, unpack_int

_STYLES = {"": 0, "interleaved": 1, "half": 2}
_ARGS = [kernels.P, kernels.I, kernels.I, kernels.I, kernels.P, kernels.P, kernels.P,
         kernels.I, kernels.I, kernels.P, kernels.F, kernels.P, kernels.P, kernels.P,
         kernels.I, kernels.I, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
         kernels.I, kernels.P]


def planes_qmm(x2d: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
               zs: torch.Tensor, norm_weight: Optional[torch.Tensor] = None,
               residual: Optional[torch.Tensor] = None,
               rope_cos: Optional[torch.Tensor] = None,
               rope_sin: Optional[torch.Tensor] = None, *, in_dim: int,
               group_size: int, norm_eps: float = 1e-5, rope_style: str = "",
               rope_hd: int = 0, split: Optional[int] = None,
               gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x2d (M, Kx) @ folded W4 (in_dim, N) -> (M, N) in x2d's dtype.

    packed (in_dim/8, N) int32 words; scales/zs (>= in_dim/gs, N) f32;
    Kx <= in_dim (missing columns count as zero). norm_weight (Kx,): RMSNorm
    prologue over the Kx columns; residual (M, N): added after the cast;
    rope_cos/rope_sin (N,): decode-RoPE rows (ops.rope.rope_rows). ``split``:
    the K split on the card, the GEMV's cluster at M <= 16, the many-row
    tile's above (None: ``w4_tile.folded_gemv_split``'s / ``folded_plan``'s).
    ``gate``: a 0-d int32 tensor on x2d's device, M <= 16; where it holds 0
    the output is zeros (whatever the fusion operands) and the kernel reads
    no weight byte: the MoE FFN's skip of an expert no row chose, decided on
    the card (ops/moe.py)."""
    if (rope_cos is None) != (not rope_style):
        raise ValueError("rope rows and rope_style go together")
    if gate is not None:
        _check(gate.dim() == 0 and gate.dtype == torch.int32 and gate.device == x2d.device
               and x2d.shape[0] <= 16,
               "gate must be a 0-d int32 tensor on x2d's device, for M <= 16 rows")
    if x2d.device.type == "cpu":
        out = planes_qmm_plain(x2d, packed, scales, zs, norm_weight, residual, rope_cos,
                               rope_sin, in_dim=in_dim, group_size=group_size,
                               norm_eps=norm_eps, rope_style=rope_style, rope_hd=rope_hd)
        return out if gate is None or bool(gate) else torch.zeros_like(out)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"planes_qmm: no kernel for device {x2d.device}")
    m, kx = x2d.shape
    n = packed.shape[1]
    if m >= BIGM_ROWS:
        raise NotImplementedError(
            f"planes_qmm with M={m} >= {BIGM_ROWS} rows: the many-row kernel "
            "(ops/quant_matmul_bigm.py::planes_qmm_bigm, PERF.md kernel table row 5) "
            "takes such calls and has no norm / RoPE / residual fusion; compose them "
            "unfused as ops.linear.module_linear_nr does")
    _check(x2d.dtype == torch.bfloat16 and x2d.stride(1) == 1 and x2d.stride(0) % 8 == 0
           and x2d.data_ptr() % 16 == 0, "x2d must be bf16 with 16-byte aligned rows")
    _check(m <= 16 or (all(t.data_ptr() % 16 == 0 for t in (packed, scales, zs))
                       and (residual is None or residual.data_ptr() % 8 == 0)),
           "the many-row tile bulk-copies packed, scales and zs rows (16-byte aligned) "
           "and reads the residual 8 bytes at a time (8-byte aligned)")
    _check(kx <= in_dim and kx % group_size == 0 and group_size % 64 == 0,
           f"Kx {kx} must be <= in_dim {in_dim} and a multiple of group_size "
           f"{group_size}, itself a multiple of 64")
    _check(all(t is None or t.device == x2d.device for t in (packed, scales, zs, norm_weight,
                                                              residual, rope_cos, rope_sin)),
           f"every operand must be on x2d's device ({x2d.device})")
    _check(packed.dtype == torch.int32 and packed.is_contiguous()
           and packed.shape[0] * 8 >= in_dim, "packed must be contiguous int32 (in_dim/8, N)")
    for t in (scales, zs):
        _check(t.dtype == torch.float32 and t.is_contiguous() and t.shape[1] == n
               and t.shape[0] >= in_dim // group_size, "scales/zs must be contiguous f32 (G, N)")
    # both kernels take a half-empty last 128-column tile (Falcon-7B's N 4544)
    _check(n % 64 == 0 and (rope_style != "half" or (128 % rope_hd == 0
                                                     and n % rope_hd == 0)),
           f"N {n} must be a multiple of 64, with whole heads in the kernel's "
           "128-column tile")
    for t, shape, dt in ((norm_weight, (kx,), torch.float32), (residual, (m, n), torch.bfloat16),
                         (rope_cos, (n,), torch.float32), (rope_sin, (n,), torch.float32)):
        if t is not None:
            _check(t.dtype == dt and t.is_contiguous() and tuple(t.shape) == shape,
                   f"fusion operand must be contiguous {dt} {shape}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2d.device)
    kernels.check("w4_matmul", _kernel_call(x2d, packed, scales, zs, norm_weight, residual,
                                            rope_cos, rope_sin, out, group_size=group_size,
                                            norm_eps=norm_eps, rope_style=rope_style,
                                            rope_hd=rope_hd, split=split, gate=gate))
    return out


def _kernel_call(x2d, packed, scales, zs, norm_weight, residual, rope_cos, rope_sin, out, *,
                 group_size: int, norm_eps: float = 1e-5, rope_style: str = "",
                 rope_hd: int = 0, split: Optional[int] = None,
                 gate: Optional[torch.Tensor] = None) -> int:
    """One call of the C entry on operands ``planes_qmm`` has checked (or
    that a measurement script vouches for): the GEMV's cluster split from
    ``w4_tile.folded_gemv_split`` (M <= 16, no scratch), or the scratch and
    split of the many-row path from ``w4_tile.folded_plan`` (``split`` None:
    the plan's own), the CUDA error code back; counts nothing."""
    m, kx = x2d.shape
    n = packed.shape[1]
    buf = xt = xsum = ws = None
    if m <= 16:
        nsplit = w4_tile.folded_gemv_split(n, kx, split)
    else:
        plan = w4_tile.folded_plan(m, n, kx, group_size, split)
        buf, xt, xsum, ws = w4_tile.scratch(plan, x2d.device, xsum=True)
        nsplit = plan.split
    fn = kernels.function("w4_matmul", "w4_matmul", _ARGS)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = fn(x2d.data_ptr(), m, kx, x2d.stride(0), packed.data_ptr(), scales.data_ptr(),
            zs.data_ptr(), n, group_size, ptr(norm_weight), norm_eps, ptr(residual),
            ptr(rope_cos), ptr(rope_sin), _STYLES[rope_style], rope_hd, out.data_ptr(),
            ptr(gate), xsum, xt, ws, nsplit, kernels.stream_ptr(x2d))
    del buf   # the launches are queued: the stream orders any reuse after them
    return rc


def planes_qmm_plain(x2d, packed, scales, zs, norm_weight=None, residual=None,
                     rope_cos=None, rope_sin=None, *, in_dim: int, group_size: int,
                     norm_eps: float = 1e-5, rope_style: str = "",
                     rope_hd: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same op order: rms_norm cast to the
    activation dtype, per-group f32 products over exact q, RoPE in f32 before
    the cast, residual added in the activation dtype."""
    dtype = x2d.dtype
    if norm_weight is not None:
        x2d = rms_norm(x2d, norm_weight, norm_eps)
    if x2d.shape[1] < in_dim:
        x2d = torch.nn.functional.pad(x2d, (0, in_dim - x2d.shape[1]))
    m, n, gs = x2d.shape[0], packed.shape[1], group_size
    groups = in_dim // gs
    q = unpack_int(packed, 4, in_dim).to(torch.float32).reshape(groups, gs, n)
    xg = x2d.to(torch.float32).reshape(m, groups, gs)
    s = scales[:groups].to(torch.float32)
    z = zs[:groups].to(torch.float32)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x2d.device)
    for g in range(groups):
        acc += (xg[:, g] @ q[g]) * s[g] - xg[:, g].sum(dim=-1, keepdim=True) * z[g]
    if rope_style:
        acc = rotate_flat(acc, rope_cos, rope_sin, rope_style, rope_hd)
    out = acc.to(dtype)
    return out if residual is None else residual.to(dtype) + out


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"planes_qmm: {msg}")
