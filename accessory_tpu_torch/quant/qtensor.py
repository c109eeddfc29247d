"""Packed W4 weights: pack/unpack, quantize, dequantize and the W4 matmul.

Port of ``accessory_tpu/quant/qtensor.py``. Format (uniform asymmetric
group quantization along the reduction dim):

  * q in [0, 15]; groups of ``group_size`` rows along in_dim;
  * ``packed``: (ceil(in_dim / 8), out_dim) 32-bit words, 8 nibbles per word,
    little-endian along in_dim (word w holds rows 8w..8w+7) -- the "std"
    packing of ``pack_int``. Torch has no general uint32 arithmetic, so the
    words are held as int32 bit patterns;
  * ``scales``: (in_dim // group_size, out_dim) f32.

Two layouts share that packing. ``std`` keeps ``zeros`` in quantized units,
dequant (q - z) * s, bit-exact with the JAX package. ``folded`` (the port's
kernel layout, produced by ``quantize_params`` and ``params_from_jax``) holds
zs = zeros * scales in the ``zeros`` field, dequant q * s - zs, the same math
as the TPU planes kernel (ops/quant_matmul_planes.py there). One layout
serves the CPU and the GPU alike.

The plain (no-fusion) W4 product is differentiable in x (``_KernelQmm``, the
port of the reference's ``_kernel_qmm`` custom VJP): QPEFT trains LoRA, bias
and norm weights over a frozen W4 base, so activation gradients cross every
frozen matmul as dx = g @ dense_weight(w)^T; packed words, scales and zeros
get no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# rows from which a W4 matmul takes the many-row kernel (the JAX default)
BIGM_ROWS = 1024
W3_W8_QUEUE = ("only W4 is ported; W3 is ROADMAP A1 and the W8 kernel "
               "(ops/quant_matmul_w8.py::w8_qmm) is ROADMAP B10")


@dataclasses.dataclass
class QuantizedWeight:
    """Group-wise quantized (in_dim, out_dim) weight (see module docstring)."""

    packed: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor
    bits: int
    group_size: int
    in_dim: int
    out_dim: int
    act_dtype: torch.dtype = torch.bfloat16
    layout: str = "std"

    def to(self, device) -> "QuantizedWeight":
        return dataclasses.replace(self, packed=self.packed.to(device),
                                   scales=self.scales.to(device),
                                   zeros=self.zeros.to(device))


def _to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same bit pattern."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def pack_int(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack (in_dim, out_dim) small ints into 32-bit words along axis 0."""
    in_dim = q.shape[0]
    pw = 32 // bits
    pad = (-in_dim) % pw
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad))
    q = q.to(torch.int64).reshape(-1, pw, q.shape[1])
    shifts = (torch.arange(pw, dtype=torch.int64, device=q.device) * bits)[None, :, None]
    return _to_int32_bits(torch.sum(q << shifts, dim=1))


def unpack_int(packed: torch.Tensor, bits: int, in_dim: int) -> torch.Tensor:
    """Inverse of pack_int -> (in_dim, out_dim) int32 in [0, 2^bits)."""
    pw = 32 // bits
    words = packed.to(torch.int64) & 0xFFFFFFFF
    shifts = (torch.arange(pw, dtype=torch.int64, device=packed.device) * bits)[None, :, None]
    vals = (words[:, None, :] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(-1, packed.shape[1])[:in_dim].to(torch.int32)


def quantize_weight(w: torch.Tensor, bits: int = 4, group_size: int = 128,
                    act_dtype: torch.dtype = torch.bfloat16,
                    pad_in_to: Optional[int] = None) -> QuantizedWeight:
    """Asymmetric min/max group quantization of an (in_dim, out_dim) weight
    (std layout). ``pad_in_to`` zero-pads the reduction dim to a multiple
    first; ``quant_matmul`` zero-pads activations to match, so results are
    exact. Same op order as the JAX package, so the result is bit-exact."""
    if bits != 4:
        raise NotImplementedError(f"W{bits} quantization: {W3_W8_QUEUE}")
    if pad_in_to:
        pad = (-w.shape[0]) % pad_in_to
        if pad:
            w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    in_dim, out_dim = w.shape
    if in_dim % group_size:
        raise ValueError(f"in_dim {in_dim} is not a multiple of group_size {group_size}")
    wf = w.to(torch.float32).reshape(in_dim // group_size, group_size, out_dim)
    qmax = float(2 ** bits - 1)
    wmin = torch.amin(wf, dim=1)
    wmax = torch.amax(wf, dim=1)
    scales = torch.clamp_min((wmax - wmin) / qmax, 1e-10)
    zeros = torch.round(-wmin / scales)
    q = torch.clamp(torch.round(wf / scales[:, None, :]) + zeros[:, None, :], 0, qmax)
    q = q.reshape(in_dim, out_dim).to(torch.int32)
    return QuantizedWeight(packed=pack_int(q, bits), scales=scales, zeros=zeros,
                           bits=bits, group_size=group_size, in_dim=in_dim,
                           out_dim=out_dim, act_dtype=act_dtype)


def to_folded_layout(qw: QuantizedWeight) -> QuantizedWeight:
    """std -> folded: zeros become zs = zeros * scales (f32); packing is kept."""
    if qw.layout == "folded":
        return qw
    if qw.layout != "std" or qw.bits != 4:
        raise NotImplementedError(f"folding layout {qw.layout!r} W{qw.bits}: {W3_W8_QUEUE}")
    s = qw.scales.to(torch.float32)
    return dataclasses.replace(qw, scales=s, zeros=qw.zeros.to(torch.float32) * s,
                               layout="folded")


def dequantize_weight(qw: QuantizedWeight, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dense (in_dim, out_dim) weight: (q - z) * s for std, q * s - zs for
    folded (scale rows past in_dim // group_size, if padded, are ignored)."""
    dtype = dtype or qw.act_dtype
    g = qw.group_size
    rows = qw.in_dim // g
    q = unpack_int(qw.packed, qw.bits, qw.in_dim).to(torch.float32)
    q = q.reshape(rows, g, qw.out_dim)
    s = qw.scales[:rows].to(torch.float32)[:, None, :]
    z = qw.zeros[:rows].to(torch.float32)[:, None, :]
    w = (q - z) * s if qw.layout == "std" else q * s - z
    return w.reshape(qw.in_dim, qw.out_dim).to(dtype)


def dense_weight(qw: QuantizedWeight, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dense (in_dim, out_dim) weight of either layout. The folded layout goes
    through ``ops.quant_matmul_bigm.planes_dequant`` (the one-pass dequant
    kernel on the card, ``dequantize_weight`` on the CPU); port of the
    reference's dense_weight (quant/qtensor.py:285-315) for the port's
    layouts."""
    dtype = dtype or qw.act_dtype
    if qw.layout == "std":
        return dequantize_weight(qw, dtype)
    if qw.layout != "folded" or qw.bits != 4:
        raise NotImplementedError(f"dense_weight for layout {qw.layout!r} W{qw.bits}: "
                                  f"{W3_W8_QUEUE}")
    from accessory_tpu_torch.ops.quant_matmul_bigm import planes_dequant

    return planes_dequant(qw.packed, qw.scales, qw.zeros, in_dim=qw.in_dim,
                          group_size=qw.group_size, dtype=dtype)


def _kernel_qmm_impl(x2d: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """The no-fusion W4 product: ``planes_qmm`` below BIGM_ROWS rows, the
    many-row kernel from there on (reference :333-357)."""
    from accessory_tpu_torch.ops.quant_matmul_bigm import planes_qmm_bigm
    from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm

    if x2d.shape[0] >= BIGM_ROWS:
        return planes_qmm_bigm(x2d, qw.packed, qw.scales, qw.zeros, in_dim=qw.in_dim,
                               group_size=qw.group_size)
    return planes_qmm(x2d, qw.packed, qw.scales, qw.zeros, in_dim=qw.in_dim,
                      group_size=qw.group_size)


class _KernelQmm(torch.autograd.Function):
    """x2d @ W4 with the reference's backward (quant/qtensor.py:373-379):
    dx = (g in the weight's dtype) @ dense_weight(w)^T, cast to the
    activation dtype; the weight's arrays get no gradient. The product is a
    plain matmul outside any kernel, as the reference leaves it to XLA."""

    @staticmethod
    def forward(ctx, x2d, qw):
        ctx.qw = qw
        ctx.kx = x2d.shape[1]
        return _kernel_qmm_impl(x2d, qw)

    @staticmethod
    def backward(ctx, g):
        qw = ctx.qw
        w = dense_weight(qw)[:ctx.kx]
        return torch.matmul(g.to(w.dtype), w.t()).to(qw.act_dtype), None


def quant_matmul(x: torch.Tensor, qw: QuantizedWeight,
                 norm_weight: Optional[torch.Tensor] = None, norm_eps: float = 1e-5,
                 residual: Optional[torch.Tensor] = None,
                 rope: Optional[tuple] = None) -> torch.Tensor:
    """x @ dequant(qw), with the optional RMSNorm prologue (``norm_weight``),
    decode-RoPE epilogue (``rope`` = (cos_row, sin_row, style, head_dim)) and
    residual add, all in one W4 kernel call (ops/quant_matmul_planes.py).
    Activations narrower than a padded in_dim count as zero-padded.

    A call without fusion operands is the differentiable ``_KernelQmm``
    (when x needs a gradient) and goes to the many-row kernel
    (ops/quant_matmul_bigm.py) from ``BIGM_ROWS`` rows on, as in the JAX
    package; with fusion operands it stays on ``planes_qmm``, which has no
    backward (training passes ``allow_fused=False`` to
    ``ops.linear.module_linear_nr``) and whose CUDA kernel refuses that many
    rows (``module_linear_nr`` composes such calls unfused)."""
    if qw.bits != 4:
        raise NotImplementedError(f"W{qw.bits} matmul: {W3_W8_QUEUE}")
    if qw.layout != "folded":
        raise ValueError("quant_matmul serves the folded layout; convert with "
                         "to_folded_layout (quantize_params does)")
    from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm

    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).to(qw.act_dtype)
    if norm_weight is None and residual is None and rope is None:
        if torch.is_grad_enabled() and x2d.requires_grad:
            out = _KernelQmm.apply(x2d, qw)
        else:
            out = _kernel_qmm_impl(x2d, qw)
        return out.reshape(*lead, qw.out_dim)
    res2d = None if residual is None else residual.reshape(-1, qw.out_dim)
    cos_row, sin_row, style, hd = rope if rope is not None else (None, None, "", 0)
    out = planes_qmm(x2d, qw.packed, qw.scales, qw.zeros, norm_weight, res2d,
                     cos_row, sin_row, in_dim=qw.in_dim, group_size=qw.group_size,
                     norm_eps=norm_eps, rope_style=style, rope_hd=hd)
    return out.reshape(*lead, qw.out_dim)
