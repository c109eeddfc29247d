"""Quantized weights: pack/unpack, quantize, dequantize, layouts and the
quantized matmul.

Port of ``accessory_tpu/quant/qtensor.py``. Format (uniform asymmetric
group quantization along the reduction dim):

  * q in [0, 2^bits - 1], bits 3, 4 or 8; groups of ``group_size`` rows
    along in_dim;
  * ``packed``: (ceil(in_dim / per_word), out_dim) 32-bit words, 32 // bits
    values per word, little-endian along in_dim -- the "std" packing of
    ``pack_int``. Torch has no general uint32 arithmetic, so the words are
    held as int32 bit patterns;
  * ``scales``: (in_dim // group_size, out_dim) f32.

Layouts, each served on the CPU (plain versions) and the GPU (kernels) alike:

  * ``std``: zeros in quantized units, dequant (q - z) * s, bit-exact with the
    JAX package. W4 std weights (GPTQ / OmniQuant imports) take the std
    kernel (ops/quant_matmul_pallas.py); W3 and anything that kernel does not
    take, the reference's dequant + plain matmul.
  * ``folded`` (the port's W4 kernel layout, from ``quantize_params`` and
    ``params_from_jax``): std packing with zs = zeros * scales in the
    ``zeros`` field, dequant q * s - zs, the TPU planes kernel's math
    (ops/quant_matmul_planes.py).
  * ``w8`` (W8A16, ``to_w8_layout``): ``packed`` is (in_dim, out_dim) int8
    rows holding q - 128, ``zeros`` holds zs = (zeros - 128) * scales
    (ops/quant_matmul_w8.py).
  * ``magic`` (W4, ``to_magic_layout``): words in the per-tile magic order of
    tile ``tile_k``, scales s / 16, zeros 256 + 16 z
    (ops/quant_matmul_magic.py).

The plain (no-fusion) product is differentiable in x (``_KernelQmm``, the
port of the reference's ``_kernel_qmm`` custom VJP): QPEFT trains LoRA, bias
and norm weights over a frozen quantized base, so activation gradients cross
every frozen matmul as dx = g @ dense_weight(w)^T; packed words, scales and
zeros get no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# rows from which a W4 matmul takes the many-row kernel (the JAX default)
BIGM_ROWS = 1024
# layouts whose kernels carry the norm prologue and the RoPE / residual epilogues
FUSED_LAYOUTS = ("folded", "w8")


@dataclasses.dataclass
class QuantizedWeight:
    """Group-wise quantized (in_dim, out_dim) weight (see module docstring).
    ``tile_k``: the magic layout's K tile; for ``w8`` the JAX package's K tile
    (recorded in checkpoints only); 0 otherwise."""

    packed: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor
    bits: int
    group_size: int
    in_dim: int
    out_dim: int
    act_dtype: torch.dtype = torch.bfloat16
    layout: str = "std"
    tile_k: int = 0

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
    if bits == 4:
        # nibbles straight from the words' little-endian bytes: byte b of a
        # word holds rows 2b (low nibble) and 2b + 1 (high nibble)
        by = packed.contiguous().view(torch.uint8).reshape(*packed.shape, 4)
        q = torch.stack([by & 15, by >> 4], dim=-1)           # (K/8, N, 4, 2)
        return q.permute(0, 2, 3, 1).reshape(-1, packed.shape[1])[:in_dim].to(torch.int32)
    pw = 32 // bits
    words = packed.to(torch.int64) & 0xFFFFFFFF
    shifts = (torch.arange(pw, dtype=torch.int64, device=packed.device) * bits)[None, :, None]
    vals = (words[:, None, :] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(-1, packed.shape[1])[:in_dim].to(torch.int32)


def quantize_weight(w: torch.Tensor, bits: int = 4, group_size: int = 128,
                    act_dtype: torch.dtype = torch.bfloat16,
                    pad_in_to: Optional[int] = None,
                    nibble_pack: bool = False) -> QuantizedWeight:
    """Asymmetric min/max group quantization of an (in_dim, out_dim) weight
    (std layout). ``pad_in_to`` zero-pads the reduction dim to a multiple
    first; ``quant_matmul`` zero-pads activations to match, so results are
    exact. ``nibble_pack`` (bits 3 only): quantize on the 3-bit grid but
    store nibbles, a W4 weight whose q lies in [0, 7], so the W4 kernels
    serve it. Same op order as the JAX package, so the result is bit-exact."""
    if bits not in (3, 4, 8):
        raise ValueError(f"bits {bits}: the format has 3, 4 and 8")
    if nibble_pack and bits != 3:
        raise ValueError("nibble_pack stores a W3 grid in nibbles: bits must be 3")
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
    stored = 4 if nibble_pack else bits
    return QuantizedWeight(packed=pack_int(q, stored), scales=scales, zeros=zeros,
                           bits=stored, group_size=group_size, in_dim=in_dim,
                           out_dim=out_dim, act_dtype=act_dtype)


def _require(qw: QuantizedWeight, bits: int, target: str) -> None:
    if qw.layout != "std" or qw.bits != bits:
        raise ValueError(f"the {target} layout is made from a std W{bits} weight, "
                         f"not {qw.layout!r} W{qw.bits}")


def to_folded_layout(qw: QuantizedWeight) -> QuantizedWeight:
    """std W4 -> folded: zeros become zs = zeros * scales (f32); packing is kept."""
    if qw.layout == "folded":
        return qw
    _require(qw, 4, "folded")
    s = qw.scales.to(torch.float32)
    return dataclasses.replace(qw, scales=s, zeros=qw.zeros.to(torch.float32) * s,
                               layout="folded")


def to_w8_layout(qw: QuantizedWeight) -> QuantizedWeight:
    """std W8 -> w8: (in_dim, out_dim) int8 rows of q - 128, zeros folded to
    (zeros - 128) * scales (f32), so the kernel computes q8 * s - zs."""
    from accessory_tpu_torch.ops.quant_matmul_w8 import choose_tile_k_w8, repack_for_w8

    if qw.layout == "w8":
        return qw
    _require(qw, 8, "w8")
    s = qw.scales.to(torch.float32)
    return dataclasses.replace(
        qw, packed=repack_for_w8(qw.packed, qw.in_dim), scales=s,
        zeros=(qw.zeros.to(torch.float32) - 128.0) * s, layout="w8",
        tile_k=choose_tile_k_w8(qw.in_dim, qw.group_size))


def _magic_tile_k(in_dim: int, group_size: int) -> int:
    """The magic layout's K tile: from four groups, doubled while it divides
    in_dim up to 2048 (the JAX package's choice)."""
    tk = 4 * group_size
    while in_dim % (2 * tk) == 0 and 2 * tk <= 2048:
        tk *= 2
    if in_dim % tk:
        raise ValueError(f"in_dim {in_dim} has no magic K tile (a multiple of 4 x "
                         f"group_size {group_size} that divides it)")
    return tk


def to_magic_layout(qw: QuantizedWeight) -> QuantizedWeight:
    """std W4 -> magic: words in the per-tile magic order, scales s / 16,
    zeros 256 + 16 z (ops/quant_matmul_magic.py)."""
    from accessory_tpu_torch.ops.quant_matmul_magic import magic_constants, repack_for_magic

    if qw.layout == "magic":
        return qw
    _require(qw, 4, "magic")
    tk = _magic_tile_k(qw.in_dim, qw.group_size)
    s2, z2 = magic_constants(qw.scales.to(torch.float32), qw.zeros.to(torch.float32))
    return dataclasses.replace(qw, packed=repack_for_magic(qw.packed, qw.in_dim, tk),
                               scales=s2, zeros=z2, layout="magic", tile_k=tk)


def dequantize_weight(qw: QuantizedWeight, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dense (in_dim, out_dim) weight of the std and folded layouts: (q - z) * s
    for std (any bits), q * s - zs for folded (scale rows past
    in_dim // group_size, if padded, are ignored)."""
    if qw.layout not in ("std", "folded"):
        raise ValueError(f"dequantize_weight reads std and folded; {qw.layout!r} goes "
                         "through dense_weight")
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
    """Dense (in_dim, out_dim) weight of any layout; port of the reference's
    dense_weight (quant/qtensor.py:285-315) for the port's layouts. The
    folded layout goes through ``ops.quant_matmul_bigm.planes_dequant`` (the
    one-pass dequant kernel on the card, ``dequantize_weight`` on the CPU);
    w8 is q8 * s - zs in f32 (two roundings, as the reference); magic is the
    magic kernel's own bf16 weight."""
    dtype = dtype or qw.act_dtype
    if qw.layout == "std":
        return dequantize_weight(qw, dtype)
    if qw.layout == "folded":
        from accessory_tpu_torch.ops.quant_matmul_bigm import planes_dequant

        return planes_dequant(qw.packed, qw.scales, qw.zeros, in_dim=qw.in_dim,
                              group_size=qw.group_size, dtype=dtype)
    rows = qw.in_dim // qw.group_size
    if qw.layout == "w8":
        qf = qw.packed.to(torch.float32).reshape(rows, qw.group_size, qw.out_dim)
        w = (qf * qw.scales[:rows].to(torch.float32)[:, None, :]
             - qw.zeros[:rows].to(torch.float32)[:, None, :])
        return w.reshape(qw.in_dim, qw.out_dim).to(dtype)
    if qw.layout == "magic":
        from accessory_tpu_torch.ops.quant_matmul_magic import magic_dequant

        return magic_dequant(qw.packed, qw.scales, qw.zeros, in_dim=qw.in_dim,
                             group_size=qw.group_size, tk=qw.tile_k).to(dtype)
    raise ValueError(f"unknown layout {qw.layout!r}")


def std_kernel_takes(qw: QuantizedWeight) -> bool:
    """Whether the std W4 kernel serves this weight (the reference's
    eligibility, quant/qtensor.py:499-505: W4, 2-D, the group a multiple of
    the 8-row word, N a multiple of 128); W3 and the rest take the dequant +
    plain matmul."""
    return (qw.layout == "std" and qw.bits == 4 and qw.packed.ndim == 2
            and qw.group_size % 8 == 0 and qw.in_dim % qw.group_size == 0
            and qw.out_dim % 128 == 0)


def _kernel_qmm_impl(x2d: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """The no-fusion product through the layout's kernel (reference
    :336-365): folded W4 to ``planes_qmm`` below BIGM_ROWS rows and to the
    many-row kernel from there on, w8 to ``w8_qmm``, magic to ``magic_qmm``,
    std W4 to ``quant_matmul_pallas``."""
    if qw.layout == "folded":
        from accessory_tpu_torch.ops.quant_matmul_bigm import planes_qmm_bigm
        from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm

        if x2d.shape[0] >= BIGM_ROWS:
            return planes_qmm_bigm(x2d, qw.packed, qw.scales, qw.zeros, in_dim=qw.in_dim,
                                   group_size=qw.group_size)
        return planes_qmm(x2d, qw.packed, qw.scales, qw.zeros, in_dim=qw.in_dim,
                          group_size=qw.group_size)
    if qw.layout == "w8":
        from accessory_tpu_torch.ops.quant_matmul_w8 import w8_qmm

        return w8_qmm(x2d, qw.packed, qw.scales, qw.zeros, group_size=qw.group_size)
    if qw.layout == "magic":
        from accessory_tpu_torch.ops.quant_matmul_magic import magic_qmm

        return magic_qmm(x2d, qw.packed, qw.scales, qw.zeros, group_size=qw.group_size,
                         tk=qw.tile_k)
    from accessory_tpu_torch.ops.quant_matmul_pallas import quant_matmul_pallas

    return quant_matmul_pallas(x2d, qw)


class _KernelQmm(torch.autograd.Function):
    """x2d @ W with the reference's backward (quant/qtensor.py:373-379):
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
    """x @ dequant(qw), dispatched by layout (reference :408-511).
    Activations narrower than a padded in_dim count as zero-padded.

    The folded and w8 layouts take the optional RMSNorm prologue
    (``norm_weight``), decode-RoPE epilogue (``rope`` = (cos_row, sin_row,
    style, head_dim)) and residual add in one kernel call
    (ops/quant_matmul_planes.py, ops/quant_matmul_w8.py); the fused call has
    no backward (training passes ``allow_fused=False`` to
    ``ops.linear.module_linear_nr``), and the W4 planes kernel refuses
    BIGM_ROWS rows or more (``module_linear_nr`` composes such calls
    unfused). Other layouts take no fusion operand.

    A call without fusion operands is the differentiable ``_KernelQmm`` (when
    x needs a gradient) over the layout's kernel: folded (the many-row
    kernel from BIGM_ROWS rows on), w8, magic, and std W4 where its kernel
    takes the weight (``std_kernel_takes``). W3 and the rest go through the
    dense weight and a plain matmul, as the reference's XLA route does."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).to(qw.act_dtype)
    if norm_weight is not None or residual is not None or rope is not None:
        if qw.layout not in FUSED_LAYOUTS:
            raise ValueError(f"norm / RoPE / residual fusion is for the {FUSED_LAYOUTS} "
                             f"layouts, not {qw.layout!r}")
        res2d = None if residual is None else residual.reshape(-1, qw.out_dim)
        cos_row, sin_row, style, hd = rope if rope is not None else (None, None, "", 0)
        if qw.layout == "w8":
            from accessory_tpu_torch.ops.quant_matmul_w8 import w8_qmm

            out = w8_qmm(x2d, qw.packed, qw.scales, qw.zeros, norm_weight, res2d, cos_row,
                         sin_row, group_size=qw.group_size, norm_eps=norm_eps,
                         rope_style=style, rope_hd=hd)
        else:
            from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm

            out = planes_qmm(x2d, qw.packed, qw.scales, qw.zeros, norm_weight, res2d,
                             cos_row, sin_row, in_dim=qw.in_dim, group_size=qw.group_size,
                             norm_eps=norm_eps, rope_style=style, rope_hd=hd)
        return out.reshape(*lead, qw.out_dim)
    if qw.layout in ("folded", "w8", "magic") or std_kernel_takes(qw):
        if torch.is_grad_enabled() and x2d.requires_grad:
            out = _KernelQmm.apply(x2d, qw)
        else:
            out = _kernel_qmm_impl(x2d, qw)
        return out.reshape(*lead, qw.out_dim)
    w = dense_weight(qw)[:x2d.shape[1]]
    return torch.matmul(x2d, w).reshape(*lead, qw.out_dim)
