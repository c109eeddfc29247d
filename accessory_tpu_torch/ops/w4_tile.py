"""Launch plans of the many-row W4 tile (``csrc/w4_tile.cuh``), the W8 tile
(``csrc/w8_matmul.cu``), the std / magic GEMV (``csrc/w4_elem.cuh``), the
fused GEMV of rows 1 and 22 (``csrc/qgemv.cuh``) and the persistent grid of
the many-row W4 matmul with bigm's numerics (``csrc/w4_matmul_bigm.cu``,
``bigm_plan``).

Row 1's fused tile (``csrc/w4_matmul.cu``, M > 16), the std / magic tile
(``csrc/w4_elem.cuh``, M > 8) and the W8 tile (M > 8) cover the output with
tiles of ``tile_m`` rows and ``tile_n`` columns. Where those tiles are too
few to fill the blocks the H100's 132 SMs hold at once, K is split over
blocks: split i takes granules [i * G // split, (i + 1) * G // split) of the
G K granules (whole quantization groups for the folded layout and W8, whose
zero point is folded out per group; 64-row units for std / magic), writes
its f32 partial tile to a (split, M, N) workspace, and the C call's
reduction pass sums the partials in split order (deterministic) before the
epilogue. The C call's row-prep pass first writes x, tiled in the order the
stages copy it, to a scratch of ``xt_shape``.

The GEMVs split K over the blocks of a cluster: the std / magic GEMV (M <=
8, ``gemv_split``) and the fused GEMV of rows 1 (M <= 16,
``folded_gemv_split``) and 22 (M <= 8, ``w8_gemv_split``); the blocks'
partial tiles are summed in rank order through distributed shared memory,
so they need no scratch.

``plan`` is a pure function of the shape (cached: a model calls a few shapes
many times), so the CPU tests check its rules; the wrappers allocate the
scratch it names with one ``torch.empty`` (``scratch``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

SMS = 132               # streaming multiprocessors of the H100 SXM
TILE_N = 128
TILE_K = 64             # K rows of a pipeline stage
TILE_M = 64             # csrc/w4_tile.cuh BM (wgmma's N)
W8_TILE_M, W8_TILE_N = 256, 128   # csrc/w8_matmul.cu TBM x TBN
# tile blocks an SM holds at once (the compiled kernels' registers and shared
# memory, chip_smoke.py's build line: folded 161 registers a thread, std 116
# and 53 KB, magic 106 and 65 KB)
FOLDED_SLOTS, STD_SLOTS, MAGIC_SLOTS = 3, 4, 3
W8_SLOTS = 1            # the W8 tile's 208 KB of shared memory: one block an SM
MIN_SPLIT_STEPS = 2     # K stages a split takes at least
MAX_SPLIT = 16
BLOCK_OVERHEAD_STEPS = 4   # a block's fill, epilogue and partial write, in K stages


@dataclass(frozen=True)
class TilePlan:
    m: int
    n: int
    tile_m: int
    granules: int        # K granules: groups (folded, W8) or 64-row units (std / magic)
    granule_rows: int    # K rows per granule
    split: int
    tile_n: int = TILE_N

    @property
    def tiles(self) -> int:
        return math.ceil(self.m / self.tile_m) * math.ceil(self.n / self.tile_n)

    @property
    def blocks(self) -> int:
        return self.tiles * self.split

    def ranges(self):
        """[first, last) granule of each split, as the kernel computes them."""
        g, s = self.granules, self.split
        return [(i * g // s, (i + 1) * g // s) for i in range(s)]

    @property
    def ws_shape(self) -> Optional[Tuple[int, int, int]]:
        return (self.split, self.m, self.n) if self.split > 1 else None

    @property
    def m_pad(self) -> int:
        return math.ceil(self.m / self.tile_m) * self.tile_m

    @property
    def xt_shape(self) -> Tuple[int, int]:
        """The row-prep pass's x, tiled for the stages' bulk copies: every
        padded row over every K row the tile walks."""
        return (self.m_pad, self.granules * self.granule_rows)

    @property
    def xsum_shape(self) -> Tuple[int, int]:
        """Folded and W8 only: sum(x) per (group, row), then 1 / rms per row
        (the norm's), rows padded to the tile."""
        return (self.granules + 1, self.m_pad)


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, granules: int, granule_rows: int, tile_m: int, slots: int,
         split: Optional[int] = None, tile_n: int = TILE_N) -> TilePlan:
    """The tile plan of an (m, n) output over ``granules`` K granules.

    ``split`` None: 1 when the output tiles alone fill half the blocks the
    card holds at once (``slots`` a SM; past that the partials' traffic
    costs more than the idle slots); else the split (up to ``MAX_SPLIT``,
    each split at least ``MIN_SPLIT_STEPS`` stages) that minimises the waves
    of blocks times a block's stages (its longest split plus
    ``BLOCK_OVERHEAD_STEPS``), the smaller on a tie: a model fitted to the
    card's times at the serving shapes (PERF.md, rows 1, 24 and 25)."""
    if split is None:
        tiles = math.ceil(m / tile_m) * math.ceil(n / tile_n)
        split = 1
        if 2 * tiles < SMS * slots:
            steps_per_granule = granule_rows // TILE_K
            most = min(MAX_SPLIT, granules,
                       max(1, granules * steps_per_granule // MIN_SPLIT_STEPS))

            def cost(s: int) -> int:
                waves = math.ceil(tiles * s / (SMS * slots))
                return waves * (math.ceil(granules / s) * steps_per_granule
                                + BLOCK_OVERHEAD_STEPS)

            split = min(range(1, most + 1), key=lambda s: (cost(s), s))
    if not 1 <= split <= max(1, granules):
        raise ValueError(f"split {split} must lie in [1, {granules}] granules")
    return TilePlan(m, n, tile_m, granules, granule_rows, split, tile_n)


def folded_plan(m: int, n: int, kx: int, group_size: int,
                split: Optional[int] = None) -> TilePlan:
    """Row 1 (``planes_qmm``, M > 16): K split in whole groups."""
    return plan(m, n, kx // group_size, group_size, TILE_M, FOLDED_SLOTS, split)


def w8_plan(m: int, n: int, kx: int, group_size: int,
             split: Optional[int] = None) -> TilePlan:
    """Row 22's tile (``w8_qmm``, M > 8): 256 x 128 tiles, K split in whole
    groups (the zero-point term is summed per split)."""
    return plan(m, n, kx // group_size, group_size, W8_TILE_M, W8_SLOTS, split, W8_TILE_N)


def elem_units(kx: int, tk: Optional[int] = None) -> int:
    """64-row units the std (tk None) or magic (tile tk) tile walks for Kx
    columns of x: std stops at Kx; magic takes whole K tiles, since a unit
    holds a slice of each quarter of its tile."""
    if tk is None:
        return kx // TILE_K
    return math.ceil(kx / tk) * (tk // TILE_K)


def elem_plan(m: int, n: int, kx: int, tk: Optional[int] = None,
              split: Optional[int] = None) -> TilePlan:
    """Rows 24 / 25 (std / magic, M > 8): K split in whole units."""
    return plan(m, n, elem_units(kx, tk), TILE_K, TILE_M,
                STD_SLOTS if tk is None else MAGIC_SLOTS, split)


GEMV_TILE_N = 128        # csrc/w4_elem.cuh GEMV_BN, csrc/qgemv.cuh BN
GEMV_MAX_SPLIT = 8       # blocks of a cluster (the portable most)
GEMV_BLOCKS = 352        # blocks the GEMVs aim at, ~2.7 an SM
GEMV_MIN_UNITS = 2       # 64-row units a split takes at least
# the largest cluster the W8 GEMV's plan picks: on 32 column tiles (7B wo and
# w2) a cluster of 7 ran 10-19% faster than one of 8 in a sweep on the card
W8_GEMV_MOST = 7


def _cluster_split(n: int, units: int, split: Optional[int],
                   most: int = GEMV_MAX_SPLIT) -> int:
    """The K split (a cluster's blocks) of a GEMV over ``ceil(n / 128)``
    column tiles and ``units`` 64-row units: None gives the split nearest
    ``GEMV_BLOCKS`` blocks, at most ``most``, each split at least
    ``GEMV_MIN_UNITS`` units; a given split must lie in [1, min(8, units)]."""
    if split is None:
        tiles = math.ceil(n / GEMV_TILE_N)
        split = max(1, min(most, units // GEMV_MIN_UNITS, int(GEMV_BLOCKS / tiles + 0.5)))
    if not 1 <= split <= min(GEMV_MAX_SPLIT, units):
        raise ValueError(f"split {split} must lie in [1, {min(GEMV_MAX_SPLIT, units)}]: "
                         f"a cluster of at most {GEMV_MAX_SPLIT} blocks over {units} units")
    return split


@functools.lru_cache(maxsize=4096)
def gemv_split(n: int, units: int, split: Optional[int] = None) -> int:
    """Rows 24 / 25's GEMV (M <= 8): the K split for ``units`` 64-row units,
    nearest ``GEMV_BLOCKS`` blocks: a model fitted to a sweep of every split
    at the GPTQ decode's shapes on the card (PERF.md, rows 24 and 25)."""
    return _cluster_split(n, units, split)


@functools.lru_cache(maxsize=4096)
def folded_gemv_split(n: int, kx: int, split: Optional[int] = None) -> int:
    """Row 1's GEMV (``planes_qmm``, M <= 16, csrc/qgemv.cuh): the K split
    over the Kx / 64 units of x, nearest ``GEMV_BLOCKS`` blocks (a split may
    cut a quantization group: each rank folds its part); a sweep of every
    split on the card put the best within 10% of it at every decode shape
    (PERF.md, PR 11)."""
    return _cluster_split(n, kx // TILE_K, split)


@functools.lru_cache(maxsize=4096)
def w8_gemv_split(n: int, kx: int, split: Optional[int] = None) -> int:
    """Row 22's GEMV (``w8_qmm``, M <= 8, csrc/qgemv.cuh): the K split over
    the Kx / 64 units of x, nearest ``GEMV_BLOCKS`` blocks and at most
    ``W8_GEMV_MOST`` (PERF.md, PR 11)."""
    return _cluster_split(n, kx // TILE_K, split, W8_GEMV_MOST)


BIGM_TILE_M, BIGM_TILE_N = 256, 128   # csrc/w4_matmul_bigm.cu BM x BN
BIGM_MIN_N = 64         # N's step: a last column panel may be half a tile (4544 = 35.5 x 128)
BIGM_SLOTS = 1          # its 190 KB ring: one block an SM
BIGM_KERNEL = "w4_bigm_wgmma_kernel"   # the kernel's name in a profiler trace


@dataclass(frozen=True)
class BigmPlan:
    m: int
    n: int
    tiles_m: int         # 256-row tiles (the last one ragged where m % 256 != 0)
    tiles: int           # output tiles: tiles_m x ceil(n / 128) (a last panel of 64)
    ctas: int            # the persistent grid: block c computes tiles c, c + ctas, ..., tile
    #                      i being row tile i % tiles_m of column panel i // tiles_m
    kernel: str = BIGM_KERNEL


@functools.lru_cache(maxsize=4096)
def bigm_plan(m: int, n: int, ctas: Optional[int] = None) -> BigmPlan:
    """The many-row W4 matmul's persistent grid (``planes_qmm_bigm``, M >=
    1024 on the model's route): 256 x 128 output tiles and ``ctas`` blocks,
    by default one a streaming multiprocessor (never more than the tiles).
    No K split: every output is one f32 sum over all of K, whatever the
    grid, so any ``ctas`` gives the same bits."""
    if m < 1 or n < 1 or n % BIGM_MIN_N:
        raise ValueError(f"bigm_plan: m {m} >= 1 and n {n} a multiple of {BIGM_MIN_N}")
    tiles_m = math.ceil(m / BIGM_TILE_M)
    tiles = tiles_m * math.ceil(n / BIGM_TILE_N)
    if ctas is None:
        ctas = SMS * BIGM_SLOTS
    if ctas < 1:
        raise ValueError(f"bigm_plan: ctas {ctas} must be >= 1")
    return BigmPlan(m, n, tiles_m, tiles, min(ctas, tiles))


def scratch_layout(p: TilePlan, xsum: bool):
    """The byte offsets of the tiled x, the x sums and the split partials in
    the C call's scratch (each 256-byte aligned), and its bytes in all."""
    sizes = [math.prod(p.xt_shape) * 2, math.prod(p.xsum_shape) * 4 if xsum else 0,
             math.prod(p.ws_shape) * 4 if p.ws_shape else 0]
    offs, total = [], 0
    for size in sizes:
        offs.append(total)
        total += -(-size // 256) * 256
    return offs, total


def scratch(p: TilePlan, device, xsum: bool):
    """One allocation for the C call's scratch, and the addresses in it of
    the tiled x (bf16 ``xt_shape``), the x sums (f32 ``xsum_shape``, folded
    and W8 only, else None) and the split partials (f32 ``ws_shape``, None unless K
    is split), each 256-byte aligned. The tensor must outlive the launch (the
    caching allocator reuses it only for later work on the stream)."""
    offs, total = scratch_layout(p, xsum)
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    return buf, base + offs[0], (base + offs[1] if xsum else None), \
        (base + offs[2] if p.ws_shape else None)
