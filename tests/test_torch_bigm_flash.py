"""The many-row W4 matmul (row 5) and the flash-attention forward (rows 3 and
26) on the CPU: their launch plans (``ops.w4_tile.bigm_plan``,
``ops.flash_attention.fwd_plan``) over the shapes the paths launch, the C
calls the wrappers make (one argument per ctypes type, as many as the C
entry in ``csrc/`` declares), the kernels' block-to-rows mapping replayed in
Python, and the plain versions against the JAX package at the new tiles'
edge shapes: ``planes_qmm_bigm_plain`` against JAX's ``planes_qmm_bigm`` in
interpret mode, the flash plain version (``grouped_attention``, with the
lse) against JAX's XLA attention. The kernels themselves run only on the
card (tests/test_torch_cuda.py).

Tolerances: bigm as tests/test_torch_mha_int8.py (the same bf16 weights and
an f32 sum over all of K in another order: f32 to 5e-5 of the output scale,
bf16 to one rounding step, 6e-3); attention in f32 to 2e-5 (the same
softmax in another summation order), the lse to 2e-5 of its magnitude.
"""

import ctypes
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.ops.attention import attention as jattention
from accessory_tpu.ops.quant_matmul_bigm import planes_qmm_bigm as jplanes_qmm_bigm
from accessory_tpu.quant import qtensor as jq

from accessory_tpu_torch import convert, kernels
from accessory_tpu_torch.ops import flash_attention as tflash
from accessory_tpu_torch.ops import quant_matmul_bigm as tbigm
from accessory_tpu_torch.ops import w4_tile
from accessory_tpu_torch.ops.attention import grouped_attention
from accessory_tpu_torch.quant import qtensor as tq

CSRC = Path(kernels.__file__).resolve().parent / "csrc"
_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "long long": ctypes.c_longlong, "float": ctypes.c_float}


def c_signature(source: str, symbol: str):
    """The ctypes types of the parameters of ``extern "C" int symbol(...)`` in
    csrc/<source>.cu, read from the source."""
    text = (CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, f"{symbol} not in csrc/{source}.cu"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    return [_CTYPES[p.rsplit(" ", 1)[0]] for p in params]


def _fake_kernels(monkeypatch):
    seen = {}

    def function(lib, sym, argtypes):
        def fake(*args):
            seen.update(lib=lib, sym=sym, args=args, argtypes=list(argtypes))
            return 0
        return fake

    monkeypatch.setattr(kernels, "function", function)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 0)
    return seen


# ---------------------------------------------------------------- row 5: bigm

# (name, K, N) of LLaMA2-7B's projections (w2's in_dim 11008 padded to 11264 in
# the weight) and TinyLlama's (train_parity's 2-layer QPEFT step at 4 x 256)
LLAMA7B = [("wqkv", 4096, 12288), ("wo", 4096, 4096), ("w13", 4096, 22016), ("w2", 11264, 4096)]
TINY = [("wqkv", 2048, 2560), ("wo", 2048, 2048), ("w13", 2048, 11264), ("w2", 5632, 2048)]


@pytest.mark.parametrize("m", [1000, 1024, 1100, 4096])
@pytest.mark.parametrize("name,k,n", LLAMA7B + TINY)
def test_bigm_plan_rules(m, name, k, n):
    """256 x 128 tiles over the output, one persistent block an SM (never
    more than the tiles); every tile lands on exactly one block, the row
    tiles of a column panel on neighbouring blocks."""
    p = w4_tile.bigm_plan(m, n)
    assert p.tiles_m == math.ceil(m / 256) and p.tiles == p.tiles_m * n // 128
    assert p.ctas == min(w4_tile.SMS, p.tiles) and p.kernel == "w4_bigm_wgmma_kernel"
    # block c walks tiles c, c + ctas, ... (the kernel's loop); tile i is row
    # tile i % tiles_m of panel i // tiles_m, so a panel's row tiles are on
    # neighbouring blocks
    walks = [list(range(c, p.tiles, p.ctas)) for c in range(p.ctas)]
    assert sorted(t for w in walks for t in w) == list(range(p.tiles))
    assert all(w for w in walks)
    assert max(len(w) for w in walks) == math.ceil(p.tiles / p.ctas)
    assert w4_tile.bigm_plan(m, n) is p   # cached: a model calls a few shapes many times


def test_bigm_plan_main_path_grids():
    """The 7B prefill's 1024 rows and the QPEFT step's 8 x 512 = 4096: every
    SM holds one block (wo at 1024 rows has 128 tiles, one a block)."""
    got = {(m, name): (w4_tile.bigm_plan(m, n).tiles, w4_tile.bigm_plan(m, n).ctas)
           for m in (1024, 4096) for name, _, n in LLAMA7B}
    assert got == {(1024, "wqkv"): (384, 132), (1024, "wo"): (128, 128),
                   (1024, "w13"): (688, 132), (1024, "w2"): (128, 128),
                   (4096, "wqkv"): (1536, 132), (4096, "wo"): (512, 132),
                   (4096, "w13"): (2752, 132), (4096, "w2"): (512, 132)}


def test_bigm_plan_refuses():
    for m, n, ctas in ((0, 128, None), (1024, 200, None), (1024, 128, 0)):
        with pytest.raises(ValueError, match="bigm_plan"):
            w4_tile.bigm_plan(m, n, ctas)
    assert w4_tile.bigm_plan(1024, 4096, 7).ctas == 7
    assert w4_tile.bigm_plan(256, 128, 50).ctas == 1


@pytest.mark.parametrize("m,kx,ctas", [(1024, 512, None), (1000, 384, None), (4096, 512, 5),
                                      (1, 512, None)])
def test_bigm_kernel_call_abi(monkeypatch, m, kx, ctas):
    """planes_qmm_bigm's C call: the C entry's own parameter list (read from
    csrc/w4_matmul_bigm.cu), x's row stride, and the plan's persistent grid
    (the caller's where given)."""
    seen = _fake_kernels(monkeypatch)
    k, n = 512, 384
    qw = tq.to_folded_layout(tq.quantize_weight(torch.randn(k, n) * 0.05, 4, 128))
    x = torch.randn(m, 640).to(torch.bfloat16)[:, :kx]
    out = torch.empty(m, n, dtype=torch.bfloat16)
    rc = tbigm._kernel_call(x, qw.packed, qw.scales, qw.zeros, out, group_size=128, ctas=ctas)
    args = seen["args"]
    assert rc == 0 and seen["sym"] == "w4_matmul_bigm"
    assert seen["argtypes"] == tbigm._ARGS == c_signature("w4_matmul_bigm", "w4_matmul_bigm")
    assert len(args) == len(tbigm._ARGS)
    assert args[1:4] == (m, kx, 640) and args[7:9] == (n, 128)
    assert args[10] == w4_tile.bigm_plan(m, n, ctas).ctas


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,kx,n,m", [(512, 512, 128, 255), (512, 512, 256, 256),
                                      (512, 384, 128, 257), (768, 768, 384, 511),
                                      (512, 512, 128, 1)])
def test_bigm_plain_vs_jax_at_tile_edges(dtype, k, kx, n, m):
    """planes_qmm_bigm's plain version (the path of a CPU tensor) against the
    JAX kernel in interpret mode at the 256-row tile's edges (one row short,
    exact, one over, two tiles less one; one row), a narrow x (``kx < k``: JAX
    gets it zero-padded) and a single 128-column panel. Both sides hold the
    same quantized weight (JAX's, carried over by ``convert``), so the test
    is of the product alone."""
    dt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    jd, td = dt[dtype]
    rng = np.random.RandomState(m + n)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    jqw = jq.to_planes_layout(jq.quantize_weight(jnp.asarray(w), 4, 128, jd))
    leaf = {f: getattr(jqw, f) for f in ("packed", "scales", "zeros", "bits", "group_size",
                                         "in_dim", "out_dim", "tile_k")}
    tqw = convert._quantized(dict(leaf, layout="planes"), td, "cpu")
    assert tqw.layout == "folded"
    x = rng.standard_normal((m, kx)).astype(np.float32)
    jx = jnp.pad(jnp.asarray(x, jd), ((0, 0), (0, k - kx)))
    want = np.asarray(jplanes_qmm_bigm(jx, jqw.packed, jqw.scales, jqw.zeros, group_size=128,
                                       tk=jqw.tile_k, interpret=True), np.float32)
    got = tbigm.planes_qmm_bigm(torch.from_numpy(x).to(td), tqw.packed, tqw.scales, tqw.zeros,
                                in_dim=k, group_size=128)
    assert got.dtype == td and got.shape == (m, n)
    got = got.to(torch.float32).numpy()
    if dtype == "bfloat16":
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=6e-3, atol=6e-3 * scale)
        return
    # f32: the port's weight is q * s then - zs, two f32 roundings, as the
    # TPU kernel's; XLA:CPU contracts the interpret run's q * s - zs into one
    # fused multiply-add, so a weight can round to the neighbouring bf16 value
    # there. Held exactly to the two-rounding formula (in f64 past the bf16
    # weights, 5e-5 of the output scale), and to JAX within one bf16 step of
    # every weight (2^-8 relative).
    q = tq.unpack_int(tqw.packed, 4, k).to(torch.float32)[:kx]
    gs = lambda a: torch.repeat_interleave(a, 128, 0)[:kx]  # noqa: E731
    wq = ((q * gs(tqw.scales)) - gs(tqw.zeros)).to(torch.bfloat16).to(torch.float64).numpy()
    exact = x.astype(np.float64) @ wq
    np.testing.assert_allclose(got, exact, rtol=5e-5, atol=5e-5 * float(np.abs(exact).max()))
    step = 2.0 ** -8 * (np.abs(x).astype(np.float64) @ np.abs(wq))
    assert (np.abs(got - want) <= step + 1e-6).all()


# ---------------------------------------------------------------- rows 3 / 26: flash forward

# (tag, b, sq, sk, q_offset, nq, nkv): the serving prefills, the training
# forwards (7B QPEFT 8 x 512, 700M 2 x 2048, train_parity's TinyLlama 4 x
# 256, train_cp 1 x 4096), cp shards (7B / TinyLlama S 8192 over 4, the
# ragged S 8000) and short sequences (the stream phase's and the tests')
PATH_SHAPES = [("tiny prefill", 4, 128, 128, 0, 32, 4), ("tiny prefill b1", 1, 128, 128, 0, 32, 4),
               ("tiny ragged", 4, 200, 200, 0, 32, 4), ("hd128", 4, 128, 128, 0, 16, 4),
               ("7b prefill", 8, 128, 128, 0, 32, 32), ("7b qpeft", 8, 512, 512, 0, 32, 32),
               ("700m", 2, 2048, 2048, 0, 16, 8), ("train_parity", 4, 256, 256, 0, 32, 4),
               ("train_cp", 1, 4096, 4096, 0, 32, 32),
               ("7b cp rank 3", 1, 2048, 8192, 6144, 32, 32),
               ("tiny cp rank 0", 1, 2048, 8192, 0, 32, 4), ("ragged", 1, 2000, 8000, 4000, 32, 4),
               ("s1", 2, 1, 1, 0, 4, 2), ("s17", 2, 17, 17, 0, 8, 2), ("s63", 2, 63, 63, 0, 32, 4),
               ("s64", 2, 64, 64, 0, 32, 4), ("s65", 2, 65, 65, 0, 32, 4),
               ("s16 r8", 1, 16, 16, 0, 32, 4), ("shard 26 rows", 2, 26, 130, 104, 8, 1)]


def blocks_of(p: tflash.FwdPlan, b: int, sq: int, sk: int, q0: int, nq: int, nkv: int):
    """The kernel's index arithmetic (csrc/flash_attention.cu, ``Item``)
    replayed: for each work item, in the order the persistent blocks take
    them, its (batch row, first query head, first position, key tiles,
    kv head), longest query tiles first."""
    r, ph = nq // nkv, p.heads_per_block
    groups, per = nq // ph, (nq // ph) * b
    out = []
    for blk in range(p.blocks):
        qt = p.q_tiles - 1 - blk // per
        hg, bb = (blk % per) % groups, (blk % per) // groups
        p0 = qt * p.positions
        last = min(sq, p0 + p.positions) - 1
        out.append((bb, hg * ph, p0, min(q0 + last, sk - 1) // tflash.FWD_KEYS + 1,
                    (hg * ph) // r))
    return out


@pytest.mark.parametrize("tag,b,sq,sk,q0,nq,nkv", PATH_SHAPES)
def test_fwd_plan_covers_every_row_once(tag, b, sq, sk, q0, nq, nkv):
    """Every (batch row, query head, position) is a row of exactly one work
    item; an item's heads are one GQA group's (one kv head); its key tiles
    reach its last row's diagonal and no further; items come longest first,
    so each persistent block's first item is among the longest."""
    p = tflash.fwd_plan(b, sq, sk, q0, nq, nkv)
    assert p.heads_per_block * p.positions == tflash.FWD_ROWS and p.kernel == tflash.FWD_KERNEL
    assert p.ctas == (min(tflash.SMS, p.blocks) if p.key_tiles <= tflash.PERSISTENT_TILES
                      else p.blocks)
    assert (nq // nkv) % p.heads_per_block == 0
    assert p.q_tiles == math.ceil(sq / p.positions)
    seen = set()
    tiles = []
    for bb, h0, p0, n_tiles, hk in blocks_of(p, b, sq, sk, q0, nq, nkv):
        rows = [(bb, h0 + row % p.heads_per_block, p0 + row // p.heads_per_block)
                for row in range(tflash.FWD_ROWS)]
        rows = [x for x in rows if x[2] < sq]
        assert rows and all(h // (nq // nkv) == hk for _, h, _ in rows)
        assert not seen & set(rows)
        seen |= set(rows)
        last = max(pos for _, _, pos in rows)
        assert (n_tiles - 1) * tflash.FWD_KEYS <= q0 + last < n_tiles * tflash.FWD_KEYS \
            or n_tiles * tflash.FWD_KEYS >= sk > (n_tiles - 1) * tflash.FWD_KEYS
        tiles.append(n_tiles)
    assert len(seen) == b * nq * sq
    assert tiles == sorted(tiles, reverse=True) and max(tiles) == p.key_tiles


@pytest.mark.parametrize("sq,r,want", [(1, 8, 8), (16, 8, 8), (17, 8, 4), (32, 8, 4),
                                       (33, 8, 2), (64, 8, 2), (65, 8, 1), (128, 8, 1),
                                       (4096, 8, 1), (1, 1, 1), (1, 2, 2), (1, 3, 1),
                                       (8, 6, 2), (1, 32, 32), (2, 128, 64)])
def test_fwd_plan_packs_short_sequences(sq, r, want):
    """The most heads of a group (a power of two dividing nq / nkv) whose
    positions fill no more than the 128-row block: a short sequence shares its
    block with its group's other heads; from 65 rows on, one head a block."""
    p = tflash.fwd_plan(1, sq, sq, 0, 4 * r, 4)
    assert p.heads_per_block == want and p.positions == 128 // want


def test_fwd_plan_grids_on_the_paths():
    """The persistent grid where every item is short (the prefills, the 7B
    QPEFT step's 512 rows), a block an item on the long rows (700M, train_cp,
    the cp shards)."""
    got = {tag: tflash.fwd_plan(b, sq, sk, q0, nq, nkv).ctas
           for tag, b, sq, sk, q0, nq, nkv in PATH_SHAPES[:9]}
    assert got == {"tiny prefill": 128, "tiny prefill b1": 32, "tiny ragged": 132,
                   "hd128": 64, "7b prefill": 132, "7b qpeft": 132, "700m": 512,
                   "train_parity": 132, "train_cp": 1024}


def test_fwd_plan_override_and_refusals():
    assert tflash.fwd_plan(4, 128, 128, 0, 32, 4, 8).heads_per_block == 8
    assert tflash.fwd_plan(4, 128, 128, 0, 32, 4, 8).blocks == 4 * 4 * 8
    for ph in (0, 3, 16):
        with pytest.raises(ValueError, match="heads a block"):
            tflash.fwd_plan(4, 128, 128, 0, 32, 4, ph)


@pytest.mark.parametrize("q_offset", [None, 0, 64])
def test_fwd_kernel_call_abi(monkeypatch, q_offset):
    """The forward's C calls: each entry's own parameter list (read from
    csrc/flash_attention.cu), the strides of strided q / k / v, and the plan's
    heads a block (the caller's where given)."""
    seen = _fake_kernels(monkeypatch)
    b, s, nq, nkv, hd = 2, 64, 8, 2, 64
    skv = s if q_offset is None else 2 * s
    q = torch.zeros(b, s, nq, hd, dtype=torch.bfloat16)
    kbuf = torch.zeros(b, skv, 2 * nkv * hd, dtype=torch.bfloat16)
    k, v = kbuf[..., :nkv * hd].view(b, skv, nkv, hd), kbuf[..., nkv * hd:].view(b, skv, nkv, hd)
    out = torch.empty_like(q)
    lse = torch.empty(b, nq, s)
    for ph in (None, 1):
        rc = tflash._fwd_call(q, k, v, out, lse, 0.125, q_offset, ph)
        sym = "flash_attention_fwd" if q_offset is None else "flash_attention_cp_fwd"
        want = tflash._ARGS if q_offset is None else tflash._CP_ARGS
        assert rc == 0 and seen["sym"] == sym and seen["argtypes"] == want
        assert want == c_signature("flash_attention", sym) and len(seen["args"]) == len(want)
        args = seen["args"]
        assert args[4:6] == (skv * 2 * nkv * hd, 2 * nkv * hd)   # k's batch and token strides
        dims = (b, s, nq, nkv, hd) if q_offset is None else (b, s, skv, q_offset, nq, nkv, hd)
        assert args[10:10 + len(dims)] == dims
        plan = tflash.fwd_plan(b, s, skv, q_offset or 0, nq, nkv, ph)
        assert args[-3] == plan.heads_per_block == (ph or 2) and args[-2] == plan.ctas


def _qkv(rng, b, sq, sk, nq, nkv, hd):
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd))]


@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 255])
@pytest.mark.parametrize("hd,nq,nkv", [(64, 8, 8), (64, 8, 4), (64, 16, 4), (128, 16, 2)])
def test_flash_plain_vs_jax_at_tile_edges(s, hd, nq, nkv):
    """The flash forward's plain version (the CPU path of ``_forward``, out
    and lse) against JAX's XLA attention at the 128-row and 128-key tiles'
    edges, R = 1, 2, 4, 8, head_dim 64 and 128; the lse against the
    log-sum-exp of JAX's scaled causal scores."""
    rng = np.random.RandomState(s + hd + nq)
    q, k, v = _qkv(rng, 2, s, s, nq, nkv, hd)
    tq_, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = tflash._forward(tq_, tk, tv, None, with_lse=True)
    want = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5)
    r = nq // nkv
    scores = np.einsum("bqkrh,bskh->bkrqs", q.reshape(2, s, nkv, r, hd).astype(np.float64),
                       k.astype(np.float64)) * hd ** -0.5
    scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    top = scores.max(-1, keepdims=True)
    ref = (top[..., 0] + np.log(np.exp(scores - top).sum(-1))).reshape(2, nq, s)
    np.testing.assert_allclose(lse.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sq,sk,q0", [(26, 130, 104), (100, 300, 129), (128, 384, 128),
                                      (129, 260, 131), (1, 500, 499)])
@pytest.mark.parametrize("hd,nq,nkv", [(64, 8, 2), (128, 4, 4)])
def test_flash_cp_plain_vs_jax_at_offsets(sq, sk, q0, hd, nq, nkv):
    """A context-parallel shard's plain forward at query offsets that are not
    multiples of the 128-row tile (and one that is) against JAX's XLA
    attention with the same q_offset (the reference cp_attention's XLA
    branch)."""
    rng = np.random.RandomState(sq + q0)
    q, k, v = _qkv(rng, 2, sq, sk, nq, nkv, hd)
    out, _ = tflash._forward(*(torch.from_numpy(a) for a in (q, k, v)), None, with_lse=True,
                             q_offset=q0)
    want = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                 q_offset=q0))
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5)
    # the same rows the wrapper computes with no key past the shard's last row
    part = grouped_attention(*(torch.from_numpy(a) for a in (q, k[:, :q0 + sq], v[:, :q0 + sq])),
                             causal=True, q_offset=q0)
    np.testing.assert_allclose(part.numpy(), want, rtol=2e-5, atol=2e-5)
