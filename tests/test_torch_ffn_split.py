"""The fused W4 decode FFN's split arithmetic (csrc/ffn_fused.cu) on the CPU:
its launch plan (``ops.ffn_fused.ffn_plan``), the C call the wrapper makes
(one argument per ctypes type, as many as the C entry in ``csrc/``
declares, the plan's splits and grid among them), and a torch model of the
kernel's arithmetic held against the JAX package.

The model, kept here and never on a path, does what the kernel does: in
phase A, rank r of a tile folds the 64-row units [r * U // split, (r + 1) *
U // split) of x' = bf16(rms_norm(x)) @ W13, each quantization group's part
in the rank as s * (x_part . q_part) - zs * sum(x_part) (at M > 16 each
32-row half of a unit on its own: the kernel's rows go in passes of 16 over
a half), the
ranks' f32 partials summed in rank order; h1 and h3 rounded to bf16, then
silu(h1) * h3 in f32 rounded once (the SwiGLU in phase A's epilogue); phase
B the same fold of that over W2's first FFN rows, the cast to bf16 and the
residual added in bf16. It is held against JAX's ``ffn_qmm`` in interpret
mode (after JAX's ``rms_norm`` where a norm is fused: the reference runs
it first) and the port's ``ffn_qmm_plain``, at M 1, 5, 8, 16, 17 and 128,
with and without the norm and residual, at the plan's splits and at a plan
with uneven ranks. JAX's kernel tiles w2's K in whole pairs of groups, so
the JAX comparisons take FFN 1536 (12 groups of 128); FFN 1408 (11
groups), w2's in_dim padded by the quantizer (1408 -> 2048), and
TinyLlama's widths are held against ``ffn_qmm_plain``.

Tolerance: the one the card holds the kernel to (tests/test_torch_cuda.py
``assert_close``): 2e-2 plus 2e-2 of the reference elementwise, bf16
inputs (the two packages round to bf16 at other points). The kernel itself
runs only on the card (tests/test_torch_cuda.py ``test_ffn_fused*``).
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.ops import ffn_fused as jffn
from accessory_tpu.ops import norms as jnorms
from accessory_tpu.ops.quant_matmul_planes import repack_for_planes
from accessory_tpu.quant.quantize import quantize_weight as jquantize_weight

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops import ffn_fused as tffn
from accessory_tpu_torch.quant.qtensor import quantize_weight, to_folded_layout, unpack_int
from accessory_tpu_torch.quant.quantize import pad_to

from test_torch_bigm_flash import c_signature
from test_torch_ffn_fused import _port_pair
from test_torch_generate import one_torch_thread  # noqa: F401  (fixture)

GS = 128
UNIT = 64
H100_RESIDENT = 396   # 3 blocks of the M <= 16 kernel on each of 132 SMs


def assert_card_close(got, want):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    bad = (g - w).abs() > 2e-2 + 2e-2 * w.abs()
    assert not bad.any(), f"{int(bad.sum())} of {g.numel()} off; max {float((g - w).abs().max())}"


def _phase(x, qw, k, ranges, per_half):
    """One phase: each rank's folded parts, then the ranks in rank order."""
    q = unpack_int(qw.packed, 4, qw.in_dim)[:k].to(torch.float32)
    s, z = qw.scales.to(torch.float32), qw.zeros.to(torch.float32)
    total = None
    for u0, u1 in ranges:
        part = torch.zeros((x.shape[0], qw.out_dim), dtype=torch.float32)
        a = u0 * UNIT
        while a < u1 * UNIT:
            b = min(u1 * UNIT, a + UNIT // 2 if per_half else (a // GS + 1) * GS)
            g = a // GS
            xs = x[:, a:b]
            part = part + (xs @ q[a:b]) * s[g] - xs.sum(-1, keepdim=True) * z[g]
            a = b
        total = part if total is None else total + part
    return total


def split_model(x, w13, w2, residual=None, norm_weight=None, eps=1e-5, plan=None):
    """A torch model of the fused kernel's arithmetic (the module docstring)."""
    m, k = x.shape
    ffn = w13.out_dim // 2
    dtype = x.dtype
    plan = plan or tffn.ffn_plan(m, k, ffn, w2.out_dim, GS, H100_RESIDENT)
    xf = x.to(torch.float32)
    if norm_weight is not None:
        rinv = 1.0 / torch.sqrt((xf * xf).sum(-1, keepdim=True) / k + eps)
        xf = ((xf * rinv) * norm_weight.to(torch.float32)).to(dtype).to(torch.float32)
    per_half = m > 16
    h = _phase(xf, w13, k, plan.ranges("a"), per_half)
    h1 = h[:, :ffn].to(dtype).to(torch.float32)
    h3 = h[:, ffn:].to(dtype).to(torch.float32)
    hh = (h1 * torch.sigmoid(h1) * h3).to(dtype).to(torch.float32)
    out = _phase(hh, w2, ffn, plan.ranges("b"), per_half).to(dtype)
    return out if residual is None else residual.to(dtype) + out


def _jax_weight(rng, k, n, tk):
    w = jnp.asarray(rng.standard_normal((k, n)) * k ** -0.5, jnp.float32)
    qw = jquantize_weight(w, bits=4, group_size=GS, act_dtype=jnp.float32)
    return dataclasses.replace(qw, packed=repack_for_planes(qw.packed, k, tk),
                               zeros=(qw.zeros * qw.scales).astype(qw.scales.dtype),
                               layout="planes", tile_k=tk)


@pytest.fixture(scope="module")
def jax_pair():
    """K 512, FFN 1536 (w2 unpadded, as JAX's kernel takes it), N2 512."""
    rng = np.random.RandomState(0)
    jw13, jw2 = _jax_weight(rng, 512, 2 * 1536, 256), _jax_weight(rng, 1536, 512, 512)
    tw13, tw2 = _port_pair(jw13, jw2, "bfloat16")
    return (jw13, jw2), (tw13, tw2)


def _inputs(rng, m, k, n2, fusion):
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    nw = (torch.from_numpy((1 + 0.1 * rng.standard_normal(k)).astype(np.float32))
          if "norm" in fusion else None)
    res = (torch.from_numpy(rng.standard_normal((m, n2)).astype(np.float32)).to(torch.bfloat16)
           if "res" in fusion else None)
    return x, nw, res


@pytest.mark.parametrize("fusion", ["none", "norm+res"])
@pytest.mark.parametrize("m", [1, 5, 8, 16, 17, 128])
def test_model_matches_jax_and_plain(jax_pair, m, fusion):
    (jw13, jw2), (tw13, tw2) = jax_pair
    rng = np.random.RandomState(m)
    x, nw, res = _inputs(rng, m, 512, 512, fusion)
    got = split_model(x, tw13, tw2, res, nw)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    if nw is not None:
        jx = jnorms.rms_norm(jx, jnp.asarray(nw.numpy()), 1e-5)
    jres = None if res is None else jnp.asarray(res.float().numpy(), jnp.bfloat16)
    want = jffn.ffn_qmm(jx, jw13.packed, jw13.scales, jw13.zeros, jw2.packed, jw2.scales,
                        jw2.zeros, residual=jres, group_size=GS, tk1=jw13.tile_k,
                        tk2=jw2.tile_k, interpret=True)
    assert got.dtype == torch.bfloat16 and got.shape == (m, 512)
    assert_card_close(got, torch.from_numpy(np.array(want.astype(jnp.float32))))
    assert_card_close(got, tffn.ffn_qmm_plain(x, tw13, tw2, res, nw))


def _port_weights(k, ffn, n2, seed=0):
    """[W1|W3] and W2 as quantize_params gives them: folded W4, in_dim padded
    by the quantizer's rule (w2: 1408 -> 2048, 5632 -> 6144)."""
    g = torch.Generator().manual_seed(seed)

    def w4(kk, nn):
        w = torch.randn((kk, nn), generator=g) * kk ** -0.5
        return to_folded_layout(quantize_weight(w, 4, GS, torch.bfloat16,
                                                pad_in_to=pad_to(kk, GS)))

    return w4(k, 2 * ffn), w4(ffn, n2)


@pytest.fixture(scope="module")
def narrow_pair():
    return _port_weights(512, 1408, 512)


@pytest.mark.parametrize("splits", [None, (3, 5), (8, 22)])
@pytest.mark.parametrize("m", [1, 5, 8, 16, 17, 128])
def test_model_padded_w2_matches_plain(narrow_pair, m, splits):
    """FFN 1408 (11 groups), w2's in_dim padded to 2048: the plan's splits, a
    plan whose ranks cut groups unevenly (8 units over 3 ranks, 22 over 5)
    and one unit a rank."""
    w13, w2 = narrow_pair
    assert w2.in_dim == 2048
    rng = np.random.RandomState(100 + m)
    x, nw, res = _inputs(rng, m, 512, 512, "norm+res")
    plan = tffn.ffn_plan(m, 512, 1408, 512, GS, H100_RESIDENT,
                         *(splits or (None, None)))
    assert_card_close(split_model(x, w13, w2, res, nw, plan=plan),
                      tffn.ffn_qmm_plain(x, w13, w2, res, nw))


@pytest.mark.parametrize("m", [8, 17])
def test_model_tinyllama_width_matches_plain(m):
    w13, w2 = _port_weights(2048, 5632, 2048, seed=1)
    rng = np.random.RandomState(m)
    x, nw, res = _inputs(rng, m, 2048, 2048, "norm+res")
    assert_card_close(split_model(x, w13, w2, res, nw), tffn.ffn_qmm_plain(x, w13, w2, res, nw))


# the decode FFNs of the model configurations: (k, ffn, n2)
SHAPES = {"narrow": (512, 1408, 512), "tinyllama": (2048, 5632, 2048),
          "llama2-7b": (4096, 11008, 4096), "ragged n2": (512, 1408, 576)}


@pytest.mark.parametrize("resident", [396, 264, 7, 1])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 128])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_covers_every_tile_and_unit(shape, m, resident):
    """Every column tile of each phase once, in ``split`` ranks whose K
    ranges are whole 64-row units, none empty, adding up to K (FFN for
    phase B); the grid within the resident blocks and no larger than a
    phase's items."""
    k, ffn, n2 = SHAPES[shape]
    p = tffn.ffn_plan(m, k, ffn, n2, GS, resident)
    assert p.tiles_a * 64 == ffn and (p.tiles_b - 1) * 128 < n2 <= p.tiles_b * 128
    for phase, units, tiles, split in (("a", k // UNIT, p.tiles_a, p.split_a),
                                       ("b", ffn // UNIT, p.tiles_b, p.split_b)):
        items = tiles * split
        assert sorted((i // split, i % split) for i in range(items)) == \
            [(t, r) for t in range(tiles) for r in range(split)]
        ranges = p.ranges(phase)
        assert len(ranges) == split and ranges[0][0] == 0 and ranges[-1][1] == units
        assert all(a < b for a, b in ranges)
        assert all(ranges[i][1] == ranges[i + 1][0] for i in range(split - 1))
        assert sum(b - a for a, b in ranges) * UNIT == (k if phase == "a" else ffn)
    assert 1 <= p.grid <= resident and p.grid <= max(p.items_a, p.items_b)
    assert p.part_elems == max(p.items_a, p.items_b) * m * 128


def test_plan_is_a_pure_function():
    """The same integers give the same plan (cached), a fresh computation
    agrees, and the default splits fill the card at decode: at TinyLlama
    and 7B every phase's items fill most of the 396 resident blocks."""
    args = (8, 2048, 5632, 2048, GS, 396)
    p = tffn.ffn_plan(*args)
    assert tffn.ffn_plan(*args) is p
    tffn.ffn_plan.cache_clear()
    assert tffn.ffn_plan(*args) == p
    for k, ffn, n2 in (SHAPES["tinyllama"], SHAPES["llama2-7b"]):
        q = tffn.ffn_plan(8, k, ffn, n2, GS, 396)
        assert q.items_a > 396 // 2 and q.items_b > 396 // 2 and q.grid == max(q.items_a,
                                                                              q.items_b)


def test_plan_refuses():
    with pytest.raises(ValueError, match="resident"):
        tffn.ffn_plan(8, 512, 1408, 512, GS, 0)
    with pytest.raises(ValueError, match="splits"):
        tffn.ffn_plan(8, 512, 1408, 512, GS, 396, 9, 1)   # 8 units of w13
    with pytest.raises(ValueError, match="splits"):
        tffn.ffn_plan(8, 512, 1408, 512, GS, 396, 1, 0)
    with pytest.raises(ValueError, match="no plan"):
        tffn.ffn_plan(129, 512, 1408, 512, GS, 396)


@pytest.mark.parametrize("m,fusion", [(1, "none"), (8, "norm+res"), (17, "res"),
                                      (128, "norm")])
def test_kernel_call_abi(monkeypatch, narrow_pair, m, fusion):
    """The C call as the wrapper makes it (a stand-in for the library records
    it): one argument per ctypes type of the C entry, in order; the plan's
    splits and grid; the fusion operands or null; scratch and counters."""
    seen = {}

    def function(lib, sym, argtypes):
        def fake(*args):
            seen.update(lib=lib, sym=sym, args=args, argtypes=list(argtypes))
            return 0
        return fake

    monkeypatch.setattr(kernels, "function", function)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 0)
    w13, w2 = narrow_pair
    x, nw, res = _inputs(np.random.RandomState(0), m, 512, 512, fusion)
    out = torch.empty((m, 512), dtype=torch.bfloat16)
    assert tffn._kernel_call(x, w13, w2, res, nw, 1e-5, out, 396) == 0
    args = seen["args"]
    assert (seen["lib"], seen["sym"]) == ("ffn_fused", "ffn_fused")
    assert seen["argtypes"] == tffn._ARGS == c_signature("ffn_fused", "ffn_fused")
    assert len(args) == len(tffn._ARGS)
    assert 'extern "C" int ffn_fused_resident(int M, int* blocks)' in \
        (kernels.CSRC / "ffn_fused.cu").read_text()
    assert tffn._RESIDENT_ARGS == [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    p = tffn.ffn_plan(m, 512, 1408, 512, GS, 396)
    assert args[1:4] == (m, 512, 512) and args[7] == 2816 and args[11:13] == (512, GS)
    assert args[-4:-1] == (p.split_a, p.split_b, p.grid)
    assert (args[13] is None) == (nw is None) and (args[15] is None) == (res is None)
    assert all(a is not None for a in args[16:20])   # hh, partials, counters, out
    assert args[19] == out.data_ptr()
    counters = tffn._arrivals[(None, 0)]
    assert counters.numel() >= p.tiles_a + p.tiles_b and not counters.any()
