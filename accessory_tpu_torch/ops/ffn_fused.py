"""The whole W4 decode FFN in one kernel: w13, SwiGLU, then w2 plus the
residual.

Port of ``accessory_tpu/ops/ffn_fused.py`` (``ffn_qmm``, ``ffn_fusible``).
The CUDA kernel is ``csrc/ffn_fused.cu``: a persistent cooperative launch
on row 1's tensor-core GEMV body (``csrc/qgemv.cuh``), phase A x @ [W1|W3]
with the SwiGLU in its epilogue into a bf16 scratch hh, a grid barrier,
phase B hh @ W2 plus the residual, each phase's column tiles split over K
ranks by ``ffn_plan`` (the ranks' f32 partials summed in rank order by the
tile's last arriving rank); ``ffn_qmm_plain`` is its plain PyTorch version
in the reference's op order and the path for tensors on the CPU. Both weights are
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

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm_plain
from accessory_tpu_torch.quant.qtensor import QuantizedWeight
from accessory_tpu_torch.quant.quantize import pad_to

# the most rows a call takes (the reference's decode-only tile bound)
MAX_ROWS = 128
# the column multiple w2's out_dim must be (phase B's tiles are 128 columns,
# the last one ragged)
_TILE_N = 64
UNIT = 64                # K rows of a weight stage; the plan splits K in whole units
TILE_A = 64              # FFN columns of a phase-A tile: W1's 64 and W3's 64
TILE_B = 128             # W2 columns of a phase-B tile
# a work item's fixed cost (its x staging, partial write and arrival), in
# units of K: the plan weighs it against the waves of items
ITEM_OVERHEAD_UNITS = 2

_P, _I, _F = kernels.P, kernels.I, kernels.F
_ARGS = [_P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _F, _P, _P, _P, _P, _P,
         _I, _I, _I, _P]
_RESIDENT_ARGS = [_I, ctypes.POINTER(ctypes.c_int)]


@dataclass(frozen=True)
class FfnPlan:
    """The fused kernel's launch: phase A's ``tiles_a`` tiles (FFN / 64) over
    ``units_a`` = K / 64 units and phase B's ``tiles_b`` (ceil(N2 / 128))
    over ``units_b`` = FFN / 64, each tile's K split over ``split`` ranks;
    work item i of a phase is tile i // split, rank i % split. ``grid``
    persistent blocks walk them (block b: items b, b + grid, ..)."""
    m: int
    units_a: int
    tiles_a: int
    split_a: int
    units_b: int
    tiles_b: int
    split_b: int
    grid: int

    @property
    def items_a(self) -> int:
        return self.tiles_a * self.split_a

    @property
    def items_b(self) -> int:
        return self.tiles_b * self.split_b

    def ranges(self, phase: str):
        """[first, last) 64-row unit of each rank of a phase ("a" or "b"), as
        the kernel computes them."""
        units, split = (self.units_a, self.split_a) if phase == "a" else (self.units_b,
                                                                         self.split_b)
        return [(r * units // split, (r + 1) * units // split) for r in range(split)]

    @property
    def part_elems(self) -> int:
        """f32 elements of the partial-tile scratch (both phases share it)."""
        return max(self.items_a, self.items_b) * self.m * TILE_B


def _split(tiles: int, units: int, resident: int) -> int:
    """The K split of a phase: the fewest waves of items times an item's
    units plus its fixed cost, the smaller split on a tie."""
    def cost(s: int) -> int:
        return math.ceil(tiles * s / resident) * (math.ceil(units / s) + ITEM_OVERHEAD_UNITS)

    return min(range(1, units + 1), key=lambda s: (cost(s), s))


@functools.lru_cache(maxsize=4096)
def ffn_plan(m: int, k: int, ffn: int, n2: int, group_size: int, resident: int,
             split_a: Optional[int] = None, split_b: Optional[int] = None) -> FfnPlan:
    """The plan of one fused call of ``m`` rows: x (m, k) @ W13 (k, 2 ffn),
    then (m, ffn) @ W2 (ffn, n2), on a card that holds ``resident`` blocks of
    the kernel at once (``csrc/ffn_fused.cu`` ffn_fused_resident). A split
    None is ``_split``'s; the grid is the most items of a phase, at most
    ``resident``."""
    if not (1 <= m <= MAX_ROWS and group_size % UNIT == 0 and k % group_size == 0
            and ffn % group_size == 0 and n2 % _TILE_N == 0 and k > 0 and ffn > 0):
        raise ValueError(f"ffn_plan: no plan for m {m}, k {k}, ffn {ffn}, n2 {n2}, "
                         f"group size {group_size}")
    if resident < 1:
        raise ValueError(f"ffn_plan: {resident} resident blocks (the kernel cannot be resident)")
    units_a, units_b = k // UNIT, ffn // UNIT
    tiles_a, tiles_b = ffn // TILE_A, math.ceil(n2 / TILE_B)
    split_a = _split(tiles_a, units_a, resident) if split_a is None else split_a
    split_b = _split(tiles_b, units_b, resident) if split_b is None else split_b
    if not (1 <= split_a <= units_a and 1 <= split_b <= units_b):
        raise ValueError(f"ffn_plan: splits ({split_a}, {split_b}) must lie in [1, {units_a}] "
                         f"and [1, {units_b}] units")
    grid = min(resident, max(tiles_a * split_a, tiles_b * split_b))
    return FfnPlan(m, units_a, tiles_a, split_a, units_b, tiles_b, split_b, grid)


_resident: Dict[Tuple[int, int], int] = {}
_arrivals: Dict[Tuple[int, int], torch.Tensor] = {}


def resident_blocks(device: torch.device, m: int) -> int:
    """Blocks of the kernel for ``m`` rows that ``device`` holds at once
    (raises where it has no cooperative launch or cannot hold one)."""
    key = (device.index, max(8, 1 << (m - 1).bit_length()))   # the kernel's row template
    if key not in _resident:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = kernels.function("ffn_fused", "ffn_fused_resident", _RESIDENT_ARGS)(
                m, ctypes.byref(blocks))
        if rc != 0:
            msg = kernels.load("ffn_fused").kernel_error_string(rc).decode()
            raise RuntimeError(f"ffn_qmm: the fused kernel cannot run on {device}: "
                               f"CUDA error {rc} ({msg})")
        _resident[key] = blocks.value
    return _resident[key]


def _arrival_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The kernel's per-tile arrival counters: zeroed once and left zeroed by
    every launch, one buffer a (device, stream) so concurrent launches never
    share one."""
    key = (device.index, stream)
    buf = _arrivals.get(key)
    if buf is None or buf.numel() < n:
        buf = _arrivals[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


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
    _check(all(t.data_ptr() % 16 == 0 for qw in (w13, w2)
               for t in (qw.packed, qw.scales, qw.zeros)), "weights must be 16-byte aligned")
    out = torch.empty((m, n2), dtype=torch.bfloat16, device=x2d.device)
    rc = _kernel_call(x2d, w13, w2, residual, norm_weight, norm_eps, out,
                      resident_blocks(x2d.device, m))
    kernels.check("ffn_fused", rc)
    return out


def _kernel_call(x2d, w13: QuantizedWeight, w2: QuantizedWeight, residual, norm_weight,
                 norm_eps: float, out: torch.Tensor, resident: int) -> int:
    """The C call of a checked launch: the plan for ``resident`` blocks, its
    scratch (hh, the partial tiles) and the stream's arrival counters."""
    m, kx = x2d.shape
    n13, n2, gs = w13.out_dim, w2.out_dim, w13.group_size
    ffn = n13 // 2
    pl = ffn_plan(m, kx, ffn, n2, gs, resident)
    stream = kernels.stream_ptr(x2d)
    hh = torch.empty((m, ffn), dtype=torch.bfloat16, device=x2d.device)
    part = torch.empty(pl.part_elems, dtype=torch.float32, device=x2d.device)
    arrivals = _arrival_counters(x2d.device, stream, pl.tiles_a + pl.tiles_b)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return kernels.function("ffn_fused", "ffn_fused", _ARGS)(
        x2d.data_ptr(), m, kx, x2d.stride(0), w13.packed.data_ptr(), w13.scales.data_ptr(),
        w13.zeros.data_ptr(), n13, w2.packed.data_ptr(), w2.scales.data_ptr(),
        w2.zeros.data_ptr(), n2, gs, ptr(norm_weight), norm_eps, ptr(residual), hh.data_ptr(),
        part.data_ptr(), arrivals.data_ptr(), out.data_ptr(), pl.split_a, pl.split_b, pl.grid,
        stream)


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
