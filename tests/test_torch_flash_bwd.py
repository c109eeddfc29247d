"""The flash-attention backward (rows 3b and 26's backward) on the CPU: its
launch plan (``ops.flash_attention.bwd_plan``, mirrored by the kernels'
``DqItem`` / ``DkdvItem`` in csrc/flash_attention_bwd.cu) over the shapes the
training paths launch, the two C calls the wrapper makes for each of the
flash and cp entries (one argument per ctypes type, as many as the C entry
in ``csrc/`` declares), and the plain backward against ``jax.vjp`` of the
JAX package's attention at the new tiles' edges and at context-parallel
offsets. The kernels themselves run only on the card (tests/test_torch_cuda.py).

Tolerances as tests/test_torch_train_grad.py: relative L2 1e-5 in f32 (the
same formula summed in another order) and 2e-2 in bf16 (P and dS rounded at
other places in the two frameworks).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.ops.attention import attention as jattention

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops import flash_attention as tflash
from accessory_tpu_torch.ops.w4_tile import SMS

from test_torch_bigm_flash import c_signature

R_ROWS = tflash.BWD_ROWS

# (tag, b, sq, sk, q_offset, nq, nkv, hd): the 7B QPEFT step, the 700M full
# finetune, TinyLlama's GQA step, train_cp, shards of cp 4 over S 8192 at
# q_offset != 0 (7B and TinyLlama widths), and ragged lengths
PATH_SHAPES = [("7b qpeft", 8, 512, 512, 0, 32, 32, 128), ("700m", 2, 2048, 2048, 0, 16, 8, 128),
               ("tiny", 4, 256, 256, 0, 32, 4, 64), ("train_cp", 1, 4096, 4096, 0, 32, 32, 128),
               ("7b cp4 rank 1", 1, 2048, 8192, 2048, 32, 32, 128),
               ("7b cp4 rank 3", 1, 2048, 8192, 6144, 32, 32, 128),
               ("tiny cp4 rank 2", 1, 2048, 8192, 4096, 32, 4, 64),
               ("ragged", 2, 77, 77, 0, 32, 4, 64), ("ragged shard", 2, 77, 300, 150, 8, 2, 128)]


@pytest.mark.parametrize("tag,b,sq,sk,q0,nq,nkv,hd", PATH_SHAPES)
def test_bwd_plan_dq_covers_every_query_tile_once(tag, b, sq, sk, q0, nq, nkv, hd):
    """dq: every (query tile, query head, batch row) is exactly one block's;
    its key tiles reach its last row's diagonal and stop there; the blocks
    come longest first."""
    p = tflash.bwd_plan(b, sq, sk, q0, nq, nkv, hd)
    assert p.dq_tiles == math.ceil(sq / R_ROWS) and p.dq_blocks == p.dq_tiles * nq * b
    assert p.dq_keys == (64 if hd == 128 else 128) and p.kernels == tflash.BWD_KERNELS
    seen, walks = set(), []
    for w in range(p.dq_blocks):
        bb, hq, p0, n_tiles = p.dq_item(w)
        assert p0 % R_ROWS == 0 and p0 < sq and 0 <= hq < nq and 0 <= bb < b
        seen.add((p0, hq, bb))
        last = q0 + min(sq, p0 + R_ROWS) - 1            # the block's last row's position
        assert (n_tiles - 1) * p.dq_keys <= min(last, sk - 1) < n_tiles * p.dq_keys
        walks.append(n_tiles)
    assert len(seen) == p.dq_blocks
    assert walks == sorted(walks, reverse=True)


@pytest.mark.parametrize("tag,b,sq,sk,q0,nq,nkv,hd", PATH_SHAPES)
def test_bwd_plan_dkdv_covers_every_key_tile_and_head_once(tag, b, sq, sk, q0, nq, nkv, hd):
    """dk / dv: every (key tile, query head of its kv head's group, batch
    row) is exactly one block's; a cluster's blocks are neighbours and split
    the group evenly; each block walks the query tiles from the first one
    with a row at or past its first key to the end, none for a key tile
    past the shard's last row; items come longest first."""
    p = tflash.bwd_plan(b, sq, sk, q0, nq, nkv, hd)
    r = nq // nkv
    assert p.kv_tiles == math.ceil(sk / R_ROWS) and p.kv_items == p.kv_tiles * nkv * b
    assert p.kv_blocks == p.kv_items * p.split and r % p.split == 0
    assert p.kv_queries == tflash.BWD_QUERIES
    seen, walks = set(), []
    for x in range(p.kv_blocks):
        bb, hk, k0, rank, heads, i_first, n_qt = p.kv_block(x)
        assert rank == x % p.split and len(heads) == r // p.split
        if rank:   # the cluster's blocks share the item
            assert p.kv_block(x - 1)[:3] == (bb, hk, k0)
        for hq in heads:
            assert hq // r == hk
            seen.add((k0, hq, bb))
        tile_rows = p.kv_queries
        if n_qt:
            assert q0 + (i_first + 1) * tile_rows - 1 >= k0          # its first tile sees k0
            assert i_first == 0 or q0 + i_first * tile_rows - 1 < k0  # the one before cannot
            assert (i_first + n_qt) * tile_rows >= sq > (i_first + n_qt - 1) * tile_rows
        else:
            assert k0 > q0 + sq - 1
        walks.append(n_qt * len(heads))
    assert len(seen) == p.kv_tiles * nq * b
    assert walks == sorted(walks, reverse=True)


@pytest.mark.parametrize("b,s,nq,nkv,want", [(4, 256, 32, 4, 4), (2, 77, 32, 4, 4),
                                             (4, 128, 32, 4, 4), (2, 2048, 16, 8, 1),
                                             (8, 512, 32, 32, 1), (1, 1000, 12, 2, 3),
                                             (1, 64, 24, 2, 4), (132, 128, 8, 1, 1)])
def test_bwd_plan_split_fills_one_wave(b, s, nq, nkv, want):
    """The GQA split: the largest divisor of the group (at most 4) whose
    blocks still run in one wave on the SMs; 1 where the items alone fill
    them (the 700M's 16 / 8 heads) or the group is one head."""
    p = tflash.bwd_plan(b, s, s, 0, nq, nkv, 64)
    assert p.split == want
    assert p.split == 1 or p.kv_blocks <= SMS
    assert tflash.bwd_plan(b, s, s, 0, nq, nkv, 64) is p   # cached


@pytest.mark.parametrize("q0,want", [(0, 2), (2048, 1), (6144, 1)])
def test_bwd_plan_split_counts_the_items_with_work(q0, want):
    """A cp 4 shard of S 8192 at TinyLlama's 32 / 4 heads: the key tiles
    past the shard's last row only store zeros, so rank 0's 16 working key
    tiles (64 items) split their groups in two, the later ranks' do not."""
    p = tflash.bwd_plan(1, 2048, 8192, q0, 32, 4, 64)
    assert p.kv_items == 256 and p.split == want
    working = sum(1 for x in range(p.kv_blocks) if p.kv_block(x)[-1])
    assert working == min(256, (q0 + 2048) // R_ROWS * 4) * p.split


def _fake_calls(monkeypatch):
    calls = []

    def function(lib, sym, argtypes):
        def fake(*args):
            calls.append(dict(lib=lib, sym=sym, args=args, argtypes=list(argtypes)))
            return 0
        return fake

    monkeypatch.setattr(kernels, "function", function)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 0)
    return calls


@pytest.mark.parametrize("q_offset", [None, 0, 64])
def test_bwd_kernel_calls_abi(monkeypatch, q_offset):
    """The backward's two C calls (dq, then dk / dv) of the flash entries and
    of the cp entries: each entry's own parameter list (read from
    csrc/flash_attention_bwd.cu), the strides of strided k / v, the shape
    arguments and the scale."""
    calls = _fake_calls(monkeypatch)
    b, s, nq, nkv, hd = 2, 64, 8, 2, 64
    skv = s if q_offset is None else 2 * s
    q, out, dout = (torch.zeros(b, s, nq, hd, dtype=torch.bfloat16) for _ in range(3))
    kbuf = torch.zeros(b, skv, 2 * nkv * hd, dtype=torch.bfloat16)
    k, v = kbuf[..., :nkv * hd].view(b, skv, nkv, hd), kbuf[..., nkv * hd:].view(b, skv, nkv, hd)
    lse, d = torch.zeros(b, nq, s), torch.zeros(b, nq, s)
    dq, dk, dv = torch.empty_like(q), torch.empty(b, skv, nkv, hd), torch.empty(b, skv, nkv, hd)
    before = kernels.launch_counts()
    tflash._bwd_calls(q, k, v, out, dout, lse, d, dq, dk, dv, 0.125, q_offset)
    name = "flash_attention_bwd" if q_offset is None else "flash_attention_cp_bwd"
    want = ((tflash._BWD_DQ_ARGS, tflash._BWD_DKDV_ARGS) if q_offset is None
            else (tflash._CP_BWD_DQ_ARGS, tflash._CP_BWD_DKDV_ARGS))
    dims = (b, s, nq, nkv, hd) if q_offset is None else (b, s, skv, q_offset, nq, nkv, hd)
    assert [c["sym"] for c in calls] == [f"{name}_dq", f"{name}_dkdv"]
    for c, types in zip(calls, want):
        assert c["lib"] == "flash_attention_bwd" and c["argtypes"] == types
        assert types == c_signature("flash_attention_bwd", c["sym"])
        assert len(c["args"]) == len(types)
        assert c["args"][3:6] == (k.data_ptr(), skv * 2 * nkv * hd, 2 * nkv * hd)
        assert c["args"][-2 - len(dims):-2] == dims and c["args"][-2] == 0.125
    dq_args, dkdv_args = calls[0]["args"], calls[1]["args"]
    assert dq_args[15:18] == (lse.data_ptr(), d.data_ptr(), dq.data_ptr())
    assert dkdv_args[12:16] == (lse.data_ptr(), d.data_ptr(), dk.data_ptr(), dv.data_ptr())
    after = kernels.launch_counts()
    assert after[f"{name}_dq"] == before[f"{name}_dq"] + 1
    assert after[f"{name}_dkdv"] == before[f"{name}_dkdv"] + 1


def _np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_attention_vjp(q0: int):
    """(out, (dq, dk, dv)) of the JAX package's causal attention at query
    offset q0, jitted (one compile a shape rather than one an operation)."""
    def run(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: jattention(a, b, c, causal=True, q_offset=q0), q, k, v)
        return out, vjp(do)
    return jax.jit(run)


def _check_plain_against_jax(b, sq, sk, q0, nq, nkv, hd, dtype, seed):
    rng = np.random.RandomState(seed)
    q, do = (rng.standard_normal((b, sq, nq, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, sk, nkv, hd)).astype(np.float32) for _ in range(2))
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jout, jgrads = _jax_attention_vjp(q0)(jq, jk, jv, jdo)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    out = tflash.grouped_attention(tq, tk, tv, causal=True, q_offset=q0)
    lse = tflash.attention_lse(tq, tk, None, q0)
    got = tflash.flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse, None, q0)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, g, w in zip(("out", "dq", "dk", "dv"), (out,) + tuple(got), (jout,) + jgrads):
        g, w = g.to(torch.float32).numpy(), _np32(w)
        assert g.shape == w.shape, name
        assert np.linalg.norm(g - w) <= tol * np.linalg.norm(w), name


@pytest.mark.parametrize("s", [127, 128, 129, 255, 256])
@pytest.mark.parametrize("hd,nq,nkv", [(64, 2, 2), (64, 4, 2), (128, 8, 1), (128, 2, 2)])
def test_plain_backward_vs_jax_at_tile_edges(s, hd, nq, nkv):
    """flash_attention_bwd_plain (the CPU path) against jax.vjp of the JAX
    package's attention in f32 around the kernels' 128-row items and their
    64-row stages (one short, exact, one past, two items), R = 1, 2, 8,
    head_dim 64 and 128."""
    _check_plain_against_jax(1, s, s, 0, nq, nkv, hd, "float32", s + hd + nq)


@pytest.mark.parametrize("s,hd,nq,nkv", [(129, 64, 8, 1), (256, 128, 4, 2)])
def test_plain_backward_vs_jax_in_bf16(s, hd, nq, nkv):
    """The same in bf16 (the training dtype) at a ragged and a whole item."""
    _check_plain_against_jax(1, s, s, 0, nq, nkv, hd, "bfloat16", s + nq)


@pytest.mark.parametrize("sq,sk,q0", [(128, 512, 384), (77, 300, 150), (64, 256, 64),
                                      (129, 260, 131)])
@pytest.mark.parametrize("hd,nq,nkv", [(64, 8, 1), (128, 4, 2)])
def test_plain_backward_vs_jax_at_cp_offsets(sq, sk, q0, hd, nq, nkv):
    """A context-parallel shard's plain backward (its rows at q_offset over
    the gathered keys; dk / dv over every key, zero past its last row)
    against jax.vjp of the reference's XLA attention with the same q_offset
    (cp_attention's XLA branch), in f32, at offsets on and off the tiles."""
    _check_plain_against_jax(1, sq, sk, q0, nq, nkv, hd, "float32", sq + q0)
