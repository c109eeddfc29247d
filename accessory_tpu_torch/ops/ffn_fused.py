"""The whole W4 decode FFN in one kernel: w13, SwiGLU, then w2 plus the
residual.

Port of ``accessory_tpu/ops/ffn_fused.py`` (``ffn_qmm``, ``ffn_fusible``).
The CUDA kernel is ``csrc/ffn_fused.cu`` (a persistent cooperative launch:
phase A x @ [W1|W3] into a bf16 scratch, a grid barrier, phase B SwiGLU @ W2
plus the residual); ``ffn_qmm_plain`` is its plain PyTorch version in the
reference's op order and the path for tensors on the CPU. Both weights are
folded W4 (``quant.qtensor``), the layout ``planes_qmm`` serves, and each
product has its numerics (q exact, the scale per group in f32, the zero
point as sum(x_g) * zs_g), so the fused route differs from the unfused one
only by the SwiGLU rounding: once here, as on the TPU, where the unfused
chain rounds silu(h1) and the product apart.

The RMSNorm folds in as a prologue (``norm_weight``), as ``planes_qmm``'s
does at any K; the reference runs ``rms_norm`` before its call. The model
takes this route only when the caller asks for it (``ffn_fuse``, the
reference's ``ACCESSORY_FFN_FUSE=1``) and ``ffn_fusible`` holds.
"""

from __future__ import annotations

from typing import Optional

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm_plain
from accessory_tpu_torch.quant.qtensor import QuantizedWeight
from accessory_tpu_torch.quant.quantize import pad_to

# the most rows a call takes (the reference's decode-only tile bound)
MAX_ROWS = 128
# the kernel's output tile: 64 columns of both products
_TILE_N = 64

_P, _I, _F = kernels.P, kernels.I, kernels.F
_ARGS = [_P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _F, _P, _P, _P, _P]


def _refusal(w13, w2, m_rows: int) -> Optional[str]:
    """Why the fused kernel cannot take this FFN, or None when it can."""
    if not (isinstance(w13, QuantizedWeight) and isinstance(w2, QuantizedWeight)):
        return "both w13 and w2 must be quantized weights"
    if not (w13.layout == "folded" and w2.layout == "folded"):
        return (f"both weights must be folded W4 (got {w13.layout!r} and {w2.layout!r}; std, "
                "magic, w8 and W3 take the unfused route)")
    if m_rows > MAX_ROWS:
        return f"{m_rows} rows: the fused FFN is a decode kernel of at most {MAX_ROWS} rows"
    if w13.group_size != w2.group_size:
        return f"group sizes differ ({w13.group_size} and {w2.group_size})"
    gs, ffn = w13.group_size, w13.out_dim // 2
    if w13.out_dim % 2 or ffn % gs or gs % 64:
        return (f"w13's out_dim {w13.out_dim} must be twice an FFN width that is a multiple "
                f"of the group size {gs}, itself a multiple of 64")
    if w2.in_dim not in (ffn, ffn + (-ffn) % pad_to(ffn, gs)):
        return (f"w2's in_dim {w2.in_dim} is neither the FFN width {ffn} nor that width "
                "padded by the quantizer (quant.quantize.pad_to)")
    if w2.out_dim % _TILE_N:
        return f"w2's out_dim {w2.out_dim} must be a multiple of {_TILE_N}"
    return None


def ffn_fusible(w13, w2, m_rows: int) -> bool:
    """Whether the fused kernel takes this FFN (the port's form of the
    reference's predicate, without its environment variable: the caller's
    ``ffn_fuse`` takes its place). True when both weights are folded W4 of
    one group size, ``m_rows`` <= 128, and w2 reads the FFN width w13 makes.
    The reference's TPU tile conditions (its N tiles, its K tile) give way to
    the CUDA kernel's alignment: a group size that is a multiple of 64, an
    FFN width that is a multiple of the group size, w2's out_dim a multiple
    of 64. Where the reference refuses any K padding of w2 (its kernel tiles
    w2 over the FFN width exactly), the kernel reads w2's first FFN rows, so
    it takes the padding the quantizer itself gives (5632 -> 6144 at
    TinyLlama, 11008 -> 11264 at LLaMA2-7B), which meets zero activations
    as on the unfused route; any other in_dim is refused."""
    return _refusal(w13, w2, m_rows) is None


def ffn_qmm(x2d: torch.Tensor, w13: QuantizedWeight, w2: QuantizedWeight,
            residual: Optional[torch.Tensor] = None,
            norm_weight: Optional[torch.Tensor] = None, *,
            norm_eps: float = 1e-5) -> torch.Tensor:
    """x2d (M, K) -> (silu(x' @ W1) * (x' @ W3)) @ W2 [+ residual] in x2d's
    dtype, x' = rms_norm(x2d, norm_weight) when a norm weight (K,) is given.
    w13 is [W1|W3] fused along its out_dim (quant.fuse.fuse_for_decode);
    residual (M, N2). On the card one launch of the fused kernel, which
    raises where it cannot take the call (``ffn_fusible``, dtypes, shapes)."""
    if x2d.device.type == "cpu":
        return ffn_qmm_plain(x2d, w13, w2, residual, norm_weight, norm_eps=norm_eps)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"ffn_qmm: no kernel for device {x2d.device}")
    m, kx = x2d.shape
    why = _refusal(w13, w2, m)
    _check(why is None, why or "")
    n13, n2, gs = w13.out_dim, w2.out_dim, w13.group_size
    _check(x2d.dtype == torch.bfloat16 and x2d.stride(1) == 1 and x2d.stride(0) % 8 == 0
           and x2d.data_ptr() % 16 == 0, "x2d must be bf16 with 16-byte aligned rows")
    _check(kx <= w13.in_dim and kx % gs == 0,
           f"x2d's width {kx} must be <= w13's in_dim {w13.in_dim} and a multiple of {gs}")
    tensors = (w13.packed, w13.scales, w13.zeros, w2.packed, w2.scales, w2.zeros, residual,
               norm_weight)
    _check(all(t is None or t.device == x2d.device for t in tensors),
           f"every operand must be on x2d's device ({x2d.device})")
    for qw, k in ((w13, kx), (w2, n13 // 2)):
        _check(qw.packed.dtype == torch.int32 and qw.packed.is_contiguous()
               and qw.packed.shape[0] * 8 >= k, "packed words must be contiguous int32")
        for t in (qw.scales, qw.zeros):
            _check(t.dtype == torch.float32 and t.is_contiguous() and t.shape[1] == qw.out_dim
                   and t.shape[0] >= k // gs, "scales / zs must be contiguous f32 (G, N)")
    for t, shape, dt in ((norm_weight, (kx,), torch.float32), (residual, (m, n2), torch.bfloat16)):
        if t is not None:
            _check(t.dtype == dt and t.is_contiguous() and tuple(t.shape) == shape,
                   f"fusion operand must be contiguous {dt} {shape}")
    h = torch.empty((m, n13), dtype=torch.bfloat16, device=x2d.device)
    out = torch.empty((m, n2), dtype=torch.bfloat16, device=x2d.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = kernels.function("ffn_fused", "ffn_fused", _ARGS)(
        x2d.data_ptr(), m, kx, x2d.stride(0), w13.packed.data_ptr(), w13.scales.data_ptr(),
        w13.zeros.data_ptr(), n13, w2.packed.data_ptr(), w2.scales.data_ptr(),
        w2.zeros.data_ptr(), n2, gs, ptr(norm_weight), norm_eps, ptr(residual), h.data_ptr(),
        out.data_ptr(), kernels.stream_ptr(x2d))
    kernels.check("ffn_fused", rc)
    return out


def ffn_qmm_plain(x2d, w13: QuantizedWeight, w2: QuantizedWeight, residual=None,
                  norm_weight=None, *, norm_eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version, the TPU kernel's op order: [rms_norm cast to
    the activation dtype], x @ W13 rounded to the activation dtype once (the
    slab h), silu(h1) * h3 in f32 rounded once, @ W2 cast to the activation
    dtype, then the residual added in it."""
    dtype, ffn = x2d.dtype, w13.out_dim // 2
    h = planes_qmm_plain(x2d, w13.packed, w13.scales, w13.zeros, norm_weight,
                         in_dim=w13.in_dim, group_size=w13.group_size, norm_eps=norm_eps)
    h1, h3 = h[:, :ffn].to(torch.float32), h[:, ffn:].to(torch.float32)
    hh = (h1 * torch.sigmoid(h1) * h3).to(dtype)
    return planes_qmm_plain(hh, w2.packed, w2.scales, w2.zeros, residual=residual,
                            in_dim=w2.in_dim, group_size=w2.group_size)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"ffn_qmm: {msg}")
