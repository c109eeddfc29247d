"""The many-row W4 tile on the CPU: row 1's plain version at prefill row
counts against the JAX planes kernel (interpret mode), and the launch plan
of ``ops/w4_tile.py`` (tile, K split, scratch shapes) over the main path's
shapes. The kernels themselves run only on the card (tests/test_torch_cuda.py).

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
    assert p.tiles == math.ceil(m / p.tile_m) * math.ceil(n / w4_tile.TILE_N)
    # K is split only where the tiles leave half the resident blocks idle,
    # and then the blocks fill the card unless K has no more splits to give
    if 2 * p.tiles >= w4_tile.SMS * slots:
        assert p.split == 1
    steps = p.granules * granule_rows // w4_tile.TILE_K
    most = min(w4_tile.MAX_SPLIT, p.granules, max(1, steps // w4_tile.MIN_SPLIT_STEPS))
    assert p.blocks >= w4_tile.SMS or p.tiles * most < w4_tile.SMS
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
                                          (300, True, 3)])
def test_planes_kernel_call_abi(monkeypatch, m, norm, split):
    """The C entry's arguments as the wrapper passes them (a stand-in for the
    library records them): one per ctypes type in order, the scratch of the
    plan for M > 16 (sum(x), the prepared A operand, the workspace of a
    split) and none for the GEMV."""
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
        assert (xsum, xt, ws, nsplit) == (None, None, None, 1)
        return
    p = w4_tile.folded_plan(m, n, k, 128, split)
    assert xsum is not None and xt is not None and nsplit == p.split
    assert (ws is not None) == (p.split > 1)
