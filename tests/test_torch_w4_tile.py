"""The many-row W4 tile on the CPU: row 1's plain version at prefill row
counts against the JAX planes kernel (interpret mode), and the launch plans
of ``ops/w4_tile.py`` (tile, K split, scratch shapes; the W8 tile's, the
std / magic GEMV's and rows 1 and 22's fused GEMV's cluster splits too) over
the main path's shapes, with the C-call arguments the wrappers pass. The
kernels themselves run only on the card (tests/test_torch_cuda.py).

Tolerances as tests/test_torch_ops.py: f32 inputs ~2e-5 relative (same op
order, sums in another order); bf16 1.5e-2 of the output scale (the JAX
kernel rounds q * s to bf16 before its dot where the port keeps q exact)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.ops import rope as jrope
from accessory_tpu.ops.quant_matmul_planes import planes_qmm as jplanes_qmm
from accessory_tpu.quant import qtensor as jq

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops import quant_matmul_planes as tplanes
from accessory_tpu_torch.ops import w4_tile
from accessory_tpu_torch.quant import qtensor as tq

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def assert_close(got, want, dtype):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    tol = 2e-5 if dtype == "float32" else 1.5e-2
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [40, 130])
@pytest.mark.parametrize("fusion", ["norm+res", "rope_interleaved", "rope_half"])
def test_planes_plain_prefill_rows_vs_jax(dtype, m, fusion):
    """planes_qmm_plain (what a CPU tensor takes through planes_qmm) at row
    counts of the many-row tile against JAX planes_qmm in interpret mode."""
    k, n, hd = 256, 384, 64
    rng = np.random.RandomState(m)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    jqw = jq.to_planes_layout(jq.quantize_weight(jnp.asarray(w), 4, 128, jnp.float32))
    tqw = tq.to_folded_layout(tq.quantize_weight(torch.from_numpy(w), 4, 128, torch.float32))
    jx, tx = both(rng.standard_normal((m, k)), dtype)
    jkw, tkw = {}, {}
    if fusion == "norm+res":
        nw = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
        jkw["norm_weight"], tkw["norm_weight"] = jnp.asarray(nw), torch.from_numpy(nw)
        jkw["residual"], tkw["residual"] = both(rng.standard_normal((m, n)), dtype)
    else:
        style = fusion.split("_")[1]
        jc, js = jrope.precompute_rope(hd, 512)
        jcr, jsr = jrope.rope_rows(jc[300], js[300], n // hd - 2, 2, hd, style)
        jkw.update(rope_cos=jcr, rope_sin=jsr, rope_style=style, rope_hd=hd)
        tkw.update(rope_cos=torch.tensor(np.asarray(jcr)), rope_sin=torch.tensor(np.asarray(jsr)),
                   rope_style=style, rope_hd=hd)
    want = jplanes_qmm(jx, jqw.packed, jqw.scales, jqw.zeros, group_size=128,
                       tk=jqw.tile_k, interpret=True, **jkw)
    got = tplanes.planes_qmm(tx, tqw.packed, tqw.scales, tqw.zeros, in_dim=tqw.in_dim,
                             group_size=128, **tkw)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    assert_close(got, want, dtype)


# (name, K, N) of TinyLlama's projections on the serving paths (wqkv with
# RoPE, wo and w2 with the residual, w13 with the norm; the stacked path's
# separate wq, wk / wv, w1 / w3), at the stream (105), batcher (128) and
# serve (512) prefill rows; 7B runs its 1024-row prefill on row 5
TINY = [("wqkv", 2048, 2560), ("wo", 2048, 2048), ("w13", 2048, 11264), ("w2", 5632, 2048),
        ("wq", 2048, 2048), ("wk/wv", 2048, 256), ("w1/w3", 2048, 5632)]
ROWS = [17, 105, 128, 256, 512, 1023]


def _check_plan(p: w4_tile.TilePlan, m: int, n: int, granule_rows: int, slots: int):
    assert p.tiles == math.ceil(m / p.tile_m) * math.ceil(n / p.tile_n)
    # K is split only where the tiles leave half the resident blocks idle,
    # and then the blocks fill the card unless K has no more splits to give;
    # with one block an SM (the W8 tile) they stay in one wave, with as few
    # K granules a block as any split that does
    if 2 * p.tiles >= w4_tile.SMS * slots:
        assert p.split == 1
    steps = p.granules * granule_rows // w4_tile.TILE_K
    most = min(w4_tile.MAX_SPLIT, p.granules, max(1, steps // w4_tile.MIN_SPLIT_STEPS))
    if slots > 1:
        assert p.blocks >= w4_tile.SMS or p.tiles * most < w4_tile.SMS
    elif p.split > 1:
        assert p.blocks <= w4_tile.SMS
        one_wave = [s for s in range(1, most + 1) if p.tiles * s <= w4_tile.SMS]
        assert math.ceil(p.granules / p.split) == min(math.ceil(p.granules / s)
                                                      for s in one_wave)
    # each split covers whole granules, contiguous, in order, none empty
    r = p.ranges()
    assert r[0][0] == 0 and r[-1][1] == p.granules
    assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
    assert all(hi > lo for lo, hi in r)
    assert all((hi - lo) * granule_rows >= w4_tile.MIN_SPLIT_STEPS * w4_tile.TILE_K
               for lo, hi in r) or p.split == 1
    assert p.ws_shape == ((p.split, m, n) if p.split > 1 else None)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("name,k,n", TINY)
def test_folded_plan_rules(m, name, k, n):
    """Row 1: 64-row tiles, K split in whole groups of 128 rows, sum(x) per
    (group, row) and 1 / rms per row with the rows padded to the tile."""
    p = w4_tile.folded_plan(m, n, k, 128)
    assert p.tile_m == w4_tile.TILE_M and p.granules == k // 128
    _check_plan(p, m, n, 128, w4_tile.FOLDED_SLOTS)
    assert p.xsum_shape == (k // 128 + 1, math.ceil(m / 64) * 64)
    assert p.xt_shape == (math.ceil(m / 64) * 64, k)


@pytest.mark.parametrize("m", [9, 128, 256, 512, 1030])
@pytest.mark.parametrize("name,k,n", TINY[:4] + [("N 136", 5632, 136)])
@pytest.mark.parametrize("tk", [None, 512])
def test_elem_plan_rules(m, name, k, n, tk):
    """Rows 24 / 25: 64-row tiles, K split in whole 64-row units; magic
    (tile tk) walks whole K tiles."""
    p = w4_tile.elem_plan(m, n, k, tk)
    assert p.tile_m == w4_tile.TILE_M
    assert p.granules == (k // 64 if tk is None else math.ceil(k / tk) * tk // 64)
    _check_plan(p, m, n, 64, w4_tile.STD_SLOTS if tk is None else w4_tile.MAGIC_SLOTS)
    assert p.xt_shape == (math.ceil(m / 64) * 64, 64 * p.granules)


def test_plan_main_path_splits():
    """The splits the serving prefills take: the ones the card measured
    fastest in a sweep of forced splits (PERF.md, rows 1, 24 and 25)."""
    got = {(name, m): w4_tile.folded_plan(m, n, k, 128).split
           for name, k, n in TINY[:4] for m in (128, 512)}
    assert got == {("wqkv", 128): 8, ("wo", 128): 8, ("w13", 128): 2, ("w2", 128): 11,
                   ("wqkv", 512): 2, ("wo", 512): 3, ("w13", 512): 1, ("w2", 512): 3}
    assert [w4_tile.elem_plan(512, n, k).split for _, k, n in TINY[:4]] == [3, 4, 1, 4]
    assert [w4_tile.elem_plan(512, n, k, 512).split for _, k, n in TINY[:4]] == [2, 3, 1, 3]
    assert w4_tile.elem_plan(256, 11264, 2048).split == 1


def test_plan_refuses_bad_split():
    with pytest.raises(ValueError, match="split"):
        w4_tile.folded_plan(40, 256, 256, 128, split=3)
    with pytest.raises(ValueError, match="split"):
        w4_tile.elem_plan(40, 256, 512, split=0)
    assert w4_tile.folded_plan(40, 256, 256, 128, split=2).ws_shape == (2, 40, 256)


@pytest.mark.parametrize("m,norm,split", [(5, True, None), (40, False, None), (300, True, 1),
                                          (300, True, 3), (1, False, None), (9, True, 2),
                                          (16, False, 8)])
def test_planes_kernel_call_abi(monkeypatch, m, norm, split):
    """The C entry's arguments as the wrapper passes them (a stand-in for the
    library records them): one per ctypes type in order, the scratch of the
    plan for M > 16 (sum(x), the prepared A operand, the workspace of a
    split); for the GEMV (M <= 16) no scratch and the cluster split of
    ``folded_gemv_split``, the caller's where given."""
    k, n = 512, 256
    seen = {}

    def fake(*args):
        seen["args"] = args
        return 0

    monkeypatch.setattr(kernels, "function", lambda lib, sym, argtypes: fake)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 0)
    qw = tq.to_folded_layout(tq.quantize_weight(torch.randn(k, n) * 0.05, 4, 128))
    x = torch.randn(m, k).to(torch.bfloat16)
    nw = torch.ones(k) if norm else None
    out = torch.empty(m, n, dtype=torch.bfloat16)
    rc = tplanes._kernel_call(x, qw.packed, qw.scales, qw.zeros, nw, None, None, None, out,
                              group_size=128, split=split)
    args = seen["args"]
    assert rc == 0 and len(args) == len(tplanes._ARGS)
    xsum, xt, ws, nsplit = args[-5:-1]
    if m <= 16:
        assert (xsum, xt, ws) == (None, None, None)
        assert nsplit == (split or w4_tile.folded_gemv_split(n, k)) == \
            w4_tile.folded_gemv_split(n, k, split)
        return
    p = w4_tile.folded_plan(m, n, k, 128, split)
    assert xsum is not None and xt is not None and nsplit == p.split
    assert (ws is not None) == (p.split > 1)


# LLaMA2-7B's projections (K 11008 unpadded: the W8 layout keeps in_dim)
LLAMA7B = [("wqkv", 4096, 12288), ("wo", 4096, 4096), ("w13", 4096, 22016), ("w2", 11008, 4096)]


@pytest.mark.parametrize("m", [9, 17, 128, 512, 1024, 1030])
@pytest.mark.parametrize("name,k,n", TINY[:4] + LLAMA7B + [("N 264", 1152, 264)])
def test_w8_plan_rules(m, name, k, n):
    """Row 22's tile: 256 x-row x 128-column tiles, K split in whole groups
    of 128 rows, sum(x) per (group, row) and 1 / rms per row with the rows
    padded to the tile."""
    p = w4_tile.w8_plan(m, n, k, 128)
    assert (p.tile_m, p.tile_n) == (w4_tile.W8_TILE_M, w4_tile.W8_TILE_N) == (256, 128)
    assert p.granules == k // 128
    _check_plan(p, m, n, 128, w4_tile.W8_SLOTS)
    assert p.xt_shape == (math.ceil(m / 256) * 256, k)
    assert p.xsum_shape == (k // 128 + 1, math.ceil(m / 256) * 256)


def test_w8_plan_main_path_splits():
    """The splits the W8 paths take: none at the 7B prefill's 1024 rows (the
    tiles fill the card), whole groups where a fused call leaves the card
    idle (PERF.md, row 22)."""
    assert [w4_tile.w8_plan(1024, n, k, 128).split for _, k, n in LLAMA7B] == [1, 1, 1, 1]
    assert [w4_tile.w8_plan(128, n, k, 128).split for _, k, n in LLAMA7B] == [1, 4, 1, 4]
    assert [w4_tile.w8_plan(512, n, k, 128).split for _, k, n in TINY[:4]] == [3, 4, 1, 4]
    with pytest.raises(ValueError, match="split"):
        w4_tile.w8_plan(40, 256, 256, 128, split=3)


@pytest.mark.parametrize("name,k,n", TINY[:4] + LLAMA7B + [("N 136", 512, 136),
                                                           ("N 2056", 1152, 2056)])
@pytest.mark.parametrize("tk", [None, 512])
def test_gemv_split_rules(name, k, n, tk):
    """Rows 24 / 25's GEMV: the cluster's blocks split K in 1 .. 8 ranges of
    at least two 64-row units, the split nearest 352 blocks where K allows
    it; a forced split outside 1 .. min(8, units) raises."""
    units = w4_tile.elem_units(k, tk)
    tiles = math.ceil(n / w4_tile.GEMV_TILE_N)
    split = w4_tile.gemv_split(n, units)
    assert 1 <= split <= w4_tile.GEMV_MAX_SPLIT and split <= units
    assert units // split >= w4_tile.GEMV_MIN_UNITS or split == 1
    if split < min(w4_tile.GEMV_MAX_SPLIT, units // w4_tile.GEMV_MIN_UNITS):
        assert abs(split * tiles - w4_tile.GEMV_BLOCKS) <= tiles / 2
    assert w4_tile.gemv_split(n, units, 1) == 1
    for bad in (0, min(w4_tile.GEMV_MAX_SPLIT, units) + 1):
        with pytest.raises(ValueError, match="split"):
            w4_tile.gemv_split(n, units, bad)


def test_gemv_main_path_splits():
    """The splits the GPTQ decode's GEMVs take: the fastest of a sweep of
    every split on the card (PERF.md, rows 24 and 25)."""
    got = [w4_tile.gemv_split(n, w4_tile.elem_units(k)) for _, k, n in TINY[:4]]
    assert got == [8, 8, 4, 8]
    assert [w4_tile.gemv_split(n, w4_tile.elem_units(k)) for _, k, n in LLAMA7B[2:]] == [2, 8]


def _fake_kernels(monkeypatch):
    """kernels.function returns a stand-in that records the C call's
    arguments (and the ctypes types it was given)."""
    seen = {}

    def function(lib, sym, argtypes):
        def fake(*args):
            seen.update(sym=sym, args=args, argtypes=argtypes)
            return 0
        return fake

    monkeypatch.setattr(kernels, "function", function)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 0)
    return seen


@pytest.mark.parametrize("m,split", [(5, None), (8, None), (9, None), (40, 2), (300, None),
                                     (1030, 1), (1, 3), (8, 8)])
def test_w8_kernel_call_abi(monkeypatch, m, split):
    """w8_qmm's C call as the wrapper makes it: one argument per ctypes type;
    the GEMV (M <= 8) gets no scratch and the cluster split of
    ``w8_gemv_split`` (the caller's where given), the tile the plan's tiled
    x, sums, split and (split > 1) partials."""
    from accessory_tpu_torch.ops import quant_matmul_w8 as tw8

    seen = _fake_kernels(monkeypatch)
    k, n = 512, 384
    qw = tq.to_w8_layout(tq.quantize_weight(torch.randn(k, n) * 0.05, 8, 128))
    x = torch.randn(m, k).to(torch.bfloat16)
    out = torch.empty(m, n, dtype=torch.bfloat16)
    rc = tw8._kernel_call(x, qw.packed, qw.scales, qw.zeros, torch.ones(k), None, None, None,
                          out, group_size=128, norm_eps=1e-5, rope_style="", rope_hd=0,
                          split=split)
    args = seen["args"]
    assert rc == 0 and seen["sym"] == "w8_matmul" and len(args) == len(tw8._ARGS) == 22
    assert args[1:4] == (m, k, k) and args[7:9] == (n, 128)
    xt, xsum, ws, nsplit = args[-5:-1]
    if m <= 8:
        assert (xt, xsum, ws) == (None, None, None)
        assert nsplit == (split or w4_tile.w8_gemv_split(n, k)) == \
            w4_tile.w8_gemv_split(n, k, split)
        return
    p = w4_tile.w8_plan(m, n, k, 128, split)
    assert xt is not None and xsum is not None and nsplit == p.split
    assert (ws is not None) == (p.split > 1)
    assert xt % 16 == 0 and xsum % 16 == 0   # the bulk copies need 16-byte aligned rows


@pytest.mark.parametrize("kind", ["std", "magic"])
@pytest.mark.parametrize("m,split", [(1, None), (8, None), (8, 3), (9, None), (300, 2)])
def test_elem_kernel_call_abi(monkeypatch, kind, m, split):
    """The std / magic C call: at M <= 8 the GEMV's cluster split (the
    plan's, or the caller's) and no scratch, above it the tile's plan and
    scratch; the magic call also carries its tile tk."""
    from accessory_tpu_torch.ops import quant_matmul_pallas as tstd

    seen = _fake_kernels(monkeypatch)
    k, n, tk = 2048, 256, 512
    packed = torch.zeros(k // 8, n, dtype=torch.int32)
    scales, zeros = torch.ones(k // 128, n), torch.ones(k // 128, n)
    x = torch.randn(m, k).to(torch.bfloat16)
    out = torch.empty(m, n, dtype=torch.bfloat16)
    rc = tstd.elem_kernel_call(x, packed, scales, zeros, out, k=k, group_size=128,
                               tk=None if kind == "std" else tk, split=split)
    args = seen["args"]
    want = tstd._ARGS if kind == "std" else tstd._MAGIC_ARGS
    assert rc == 0 and seen["sym"] == f"w4_matmul_{kind}" and len(args) == len(want)
    assert args[7:10] == (k, n, 128) and (kind == "std" or args[10] == tk)
    xt, ws, nsplit = args[-4:-1]
    units = w4_tile.elem_units(k, None if kind == "std" else tk)
    if m <= 8:
        assert (xt, ws) == (None, None)
        assert nsplit == (split or w4_tile.gemv_split(n, units))
        return
    p = w4_tile.elem_plan(m, n, k, None if kind == "std" else tk, split)
    assert xt is not None and nsplit == p.split and (ws is not None) == (p.split > 1)


@pytest.mark.parametrize("n", [136, 2056, 2560])
@pytest.mark.parametrize("m", [4, 9])
def test_elem_alignment_on_stacked_layer_slices(monkeypatch, n, m):
    """The 16-byte alignment the std / magic kernels need now holds at every
    row count, the GEMV's too: each layer's slice of a weight stacked over
    layers (L, K/8, N), with its (L, G, N) scales and zeros, starts 16-byte
    aligned since N % 8 == 0 (also where N % 16 == 8), so the check passes
    it; a view 8 bytes off raises."""
    from accessory_tpu_torch.ops import quant_matmul_pallas as tstd

    _fake_kernels(monkeypatch)
    layers, k = 3, 512
    words = torch.zeros(layers, k // 8, n, dtype=torch.int32)
    scales, zeros = torch.ones(layers, k // 128, n), torch.ones(layers, k // 128, n)
    x = torch.randn(m, k).to(torch.bfloat16)
    out = torch.empty(m, n, dtype=torch.bfloat16)
    for layer in range(layers):
        args = (x, words[layer], scales[layer], zeros[layer], out)
        assert all(t.data_ptr() % 16 == 0 for t in args[1:4])
        assert tstd.elem_kernel_call(*args, k=k, group_size=128) == 0
    off = torch.zeros(k // 8 * n + 2, dtype=torch.int32)[2:].view(k // 8, n)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tstd.elem_kernel_call(x, off, scales[0], zeros[0], out, k=k, group_size=128)


def _rank_ranges(units: int, split: int):
    """[first, last) 64-row unit of each rank of a cluster, as csrc/qgemv.cuh
    computes them."""
    return [(r * units // split, (r + 1) * units // split) for r in range(split)]


# (name, K, Kx, N) of the decode GEMVs: TinyLlama's four projections and the
# stacked path's separate ones, LLaMA2-7B's four (w2's in_dim 11008 padded
# to 11264 for W4; W8 keeps 11008), and shapes off the models'
GEMV_SHAPES = ([(nm, k, k, n) for nm, k, n in TINY] + [(nm, k, k, n) for nm, k, n in LLAMA7B[:3]]
               + [("7b w2", 11264, 11008, 4096), ("N 448", 2048, 1152, 448),
                  ("K 64", 64, 64, 256)])


@pytest.mark.parametrize("kind", ["w4", "w8"])
@pytest.mark.parametrize("name,k,kx,n", GEMV_SHAPES)
def test_fused_gemv_split_rules(monkeypatch, kind, name, k, kx, n):
    """Rows 1 and 22's GEMV: at every row count it takes (M 1-16 / 1-8) the
    wrapper passes the plan's cluster split, which lies in [1, 8] (the W8
    plan picks at most 7) and within the Kx / 64 units (each rank at least
    two where K allows it), nearest ``GEMV_BLOCKS`` blocks; the ranks' unit
    ranges partition Kx in order; every split in [1, min(8, units)] may be
    forced, one outside raises."""
    from accessory_tpu_torch.ops import quant_matmul_w8 as tw8

    plan = w4_tile.folded_gemv_split if kind == "w4" else w4_tile.w8_gemv_split
    most = w4_tile.GEMV_MAX_SPLIT if kind == "w4" else w4_tile.W8_GEMV_MOST
    units, tiles = kx // 64, math.ceil(n / 128)
    split = plan(n, kx)
    assert 1 <= split <= min(most, units)
    assert units // split >= w4_tile.GEMV_MIN_UNITS or split == 1
    if split < min(most, units // w4_tile.GEMV_MIN_UNITS):
        assert abs(split * tiles - w4_tile.GEMV_BLOCKS) <= tiles / 2
    for s in range(1, min(w4_tile.GEMV_MAX_SPLIT, units) + 1):
        r = _rank_ranges(units, s)
        assert r[0][0] == 0 and r[-1][1] * 64 == kx
        assert all(a[1] == b[0] and a[1] > a[0] for a, b in zip(r, r[1:]))
        assert plan(n, kx, s) == s
    for bad in (0, min(w4_tile.GEMV_MAX_SPLIT, units) + 1):
        with pytest.raises(ValueError, match="split"):
            plan(n, kx, bad)
    seen = _fake_kernels(monkeypatch)
    weight = (torch.zeros(k // 8, n, dtype=torch.int32) if kind == "w4"
              else torch.zeros(k, n, dtype=torch.int8))
    coef = torch.ones(k // 64, n)
    for m in range(1, 17 if kind == "w4" else 9):
        x = torch.zeros(m, kx, dtype=torch.bfloat16)
        out = torch.empty(m, n, dtype=torch.bfloat16)
        if kind == "w4":
            tplanes._kernel_call(x, weight, coef, coef, None, None, None, None, out,
                                 group_size=64)
        else:
            tw8._kernel_call(x, weight, coef, coef, None, None, None, None, out, group_size=64,
                             norm_eps=1e-5, rope_style="", rope_hd=0, split=None)
        assert seen["args"][-2] == split and seen["args"][1] == m


def test_fused_gemv_main_path_splits():
    """The splits the decode paths' GEMVs take (TinyLlama W4; LLaMA2-7B W4
    and W8): the plan's fit to a sweep of every split on the card (PERF.md,
    rows 1 and 22)."""
    tiny = [w4_tile.folded_gemv_split(n, k) for _, k, n in TINY[:4]]
    w4_7b = [w4_tile.folded_gemv_split(n, k) for _, k, n in LLAMA7B[:3]] + [
        w4_tile.folded_gemv_split(4096, 11008)]
    w8_7b = [w4_tile.w8_gemv_split(n, k) for _, k, n in LLAMA7B]
    assert (tiny, w4_7b, w8_7b) == (TINY_GEMV_SPLITS, W4_7B_GEMV_SPLITS, W8_7B_GEMV_SPLITS)


TINY_GEMV_SPLITS = [8, 8, 4, 8]
W4_7B_GEMV_SPLITS = [4, 8, 2, 8]
W8_7B_GEMV_SPLITS = [4, 7, 2, 7]
