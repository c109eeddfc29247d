"""The int8 KV kernels' pieces that the CPU can check: the one-query-head
decode kernel's widening of int8 without a conversion instruction
(csrc/decode_attention_mha.cu, ``unpack16<int8_t, 16>``), the walk of the
quantizing write body over its vectors (csrc/kv_quant.cuh,
``quantize_vectors`` under ``plan``), and the C calls of the int8 write
entries and the one-query-head decode entries (one ctypes type per argument,
as many as the C entry in ``csrc/`` declares, the dims in their places).

The widening and the walk are numpy models kept here and never on a path:
the kernels themselves run only on the card (tests/test_torch_cuda.py). The
widening model is exact, so it is held to the bits of ``float(v)``.
"""

import re

import numpy as np
import pytest
import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops import decode_attention as tda
from accessory_tpu_torch.ops import paged_write as tpw

from test_torch_bigm_flash import CSRC, c_signature
from test_torch_decode_split import _capture

# ---------------------------------------------------------------- the widening


def byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's ``__byte_perm``: byte n of the result is byte (s >> 4n) & 7 of
    the eight bytes y:x (x the low four)."""
    both = (y << 32) | x
    return sum(((both >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n) for n in range(4))


def widen16(load: bytes) -> np.ndarray:
    """The kernel's ``unpack16<int8_t, 16>`` on one 16-byte load: four
    little-endian words, each with its sign bits flipped, byte k of word j
    put under the exponent of 2^23 (the float 2^23 + b + 128), minus
    2^23 + 128 in f32; element 4 j + k."""
    out = np.empty(16, np.float32)
    for j, w in enumerate(np.frombuffer(load, dtype="<u4")):
        w = int(w) ^ 0x80808080
        for k in range(4):
            bits = np.array(byte_perm(w, 0x4B000000, 0x7540 + k), dtype=np.uint32)
            out[4 * j + k] = bits.view(np.float32) - np.float32(8388736.0)
    return out


@pytest.mark.parametrize("shuffle", [False, True])
def test_widening_is_float_of_every_byte(shuffle):
    """Every byte value -128..127, in order and shuffled, sixteen to a load:
    the widened floats have the bits of (float)v, element j from byte j."""
    values = np.arange(-128, 128, dtype=np.int8)
    if shuffle:
        values = np.random.default_rng(0).permutation(values)
    for load in values.reshape(16, 16):
        got = widen16(load.tobytes())
        assert np.array_equal(got.view(np.uint32), load.astype(np.float32).view(np.uint32))


def test_widening_model_is_the_kernels():
    """The constants and the order of the model are the source's, and the
    int8 unpack casts nothing."""
    src = (CSRC / "decode_attention_mha.cu").read_text()
    body = src[src.index("unpack16<int8_t, 16>(const uint4& raw"):]
    body = body[:body.index("\n}\n")]
    for token in ("raw.x ^ 0x80808080u", "raw.w ^ 0x80808080u",
                  "f[4 * j + k] = __uint_as_float(__byte_perm(w[j], 0x4B000000u, 0x7540u + k))"
                  " - 8388736.f"):
        assert token in " ".join(body.split()), token
    assert "(float)" not in body and "int2float" not in body


# ---------------------------------------------------------------- the write body's arithmetic


def rint_clip_byte(v: np.ndarray) -> np.ndarray:
    """kvq::rint_clip_byte: v clamped to [-127, 127] by fmaxf / fminf (which
    drop a NaN), plus 1.5 * 2^23 in f32 (round half to even), the low byte of
    the sum's bits as int8."""
    c = np.fmin(np.fmax(v.astype(np.float32), np.float32(-127)), np.float32(127))
    bits = (c + np.float32(12582912.0)).view(np.uint32)
    return (bits & 0xFF).astype(np.uint8).view(np.int8)


def test_rounding_add_is_float2int_rn_with_the_clip():
    """Every quotient near the int8 range: each k + 0.5 and its f32
    neighbours, a fine grid, +-0, values far outside, the infinities: the
    rounding add gives clip(rint(v), -127, 127); a NaN gives -127, as
    __float2int_rn's 0x80000000 clipped does."""
    halves = np.arange(-140, 140, dtype=np.float32) + np.float32(0.5)
    v = np.concatenate([halves, np.nextafter(halves, np.float32(np.inf)),
                        np.nextafter(halves, np.float32(-np.inf)),
                        np.linspace(-200, 200, 400001, dtype=np.float32),
                        np.float32([0.0, -0.0, 1e-30, -1e-30, 1e30, -1e30, np.inf, -np.inf])])
    want = np.clip(np.rint(v), -127, 127).astype(np.int8)
    assert np.array_equal(rint_clip_byte(v), want)
    assert rint_clip_byte(np.float32([np.nan]))[0] == -127
    src = (CSRC / "kv_quant.cuh").read_text()
    assert "fminf(fmaxf(v, -127.f), 127.f) + 12582912.f) & 0xffu" in " ".join(src.split())


def fast_div(d: int):
    """kvq::fast_div: (mul, shr) with mul = floor(2^32 (2^l - d) / d) + 1,
    l = ceil(log2 d)."""
    log2 = (d - 1).bit_length()
    return (1 << 32) * ((1 << log2) - d) // d + 1, log2


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7, 22, 32, 64, 77, 128, 1000, 4095, 65537,
                               (1 << 20) + 1, (1 << 30) - 1])
def test_fast_div_is_the_quotient(d):
    """The addressing's divisions by multiplication: ((n * mul) >> 32 + n) >>
    shr is n // d for every dividend the walk can give (below 2^30), at the
    edges of every multiple and at random."""
    mul, shr = fast_div(d)
    rng = np.random.default_rng(d)
    edges = (np.arange(1, 2000, dtype=np.int64) * d)[:, None] + np.array([-1, 0, 1])[None, :]
    n = np.concatenate([np.arange(0, 4096), rng.integers(0, 1 << 30, 20000),
                        edges.ravel()]).astype(np.uint64)
    n = n[(n < (1 << 30))]
    assert 0 < mul < 1 << 32
    got = (((n * np.uint64(mul)) >> np.uint64(32)) + n) >> np.uint64(shr)
    assert np.array_equal(got, n // np.uint64(d))


# ---------------------------------------------------------------- the write body's walk


def _kvq_constant(name: str) -> int:
    text = (CSRC / "kv_quant.cuh").read_text()
    return int(re.search(r"constexpr int " + name + r" = (\d+);", text).group(1))


THREADS, U_MAX = _kvq_constant("THREADS"), _kvq_constant("U")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(total: int, hd: int, pools: int, resident: int, sms: int = 132):
    """kvq::plan: (blocks a pool, vectors a thread)."""
    vpb = THREADS // (hd // 8)
    cap = max(sms * max(resident, 1) // pools, 1)
    un = min(max(cdiv(cdiv(total, cap), vpb), 1), U_MAX)
    return min(cdiv(total, vpb * un), cap), un


def walk(total: int, hd: int, blocks: int, un: int) -> np.ndarray:
    """How often quantize_vectors' loop stores each of ``total`` vectors:
    block x takes tiles x, x + blocks, ... of vpb * un vectors, segment g of
    the block vector t0 + u * vpb + g for u < un, masked at total."""
    vpb = THREADS // (hd // 8)
    tile = vpb * un
    seen = np.zeros(total, np.int64)
    for t0 in range(0, total, tile):   # every tile some block's loop reaches
        i = (t0 + np.arange(un)[:, None] * vpb + np.arange(vpb)[None, :]).ravel()
        np.add.at(seen, i[i < total], 1)
    return seen


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("resident", [1, 4, 8])
@pytest.mark.parametrize("total", [1, 31, 32, 77 * 15, 704, 2048, 32768, 90112])
def test_write_plan_covers_every_vector_once(hd, resident, total):
    """The plan's grid, walked as the kernel walks it, stores every vector of
    a pool once: ragged tails are masked, no tile is skipped or taken twice;
    the blocks never exceed one wave and vectors a thread stay in 1..U."""
    blocks, un = plan(total, hd, 2, resident)
    assert 1 <= un <= U_MAX and 1 <= blocks <= max(132 * resident // 2, 1)
    tile = THREADS // (hd // 8) * un
    # the tiles block x's loop reaches are x, x + blocks, ...: all of them
    reached = sorted(t for x in range(blocks) for t in range(x * tile, total, blocks * tile))
    assert reached == list(range(0, total, tile))
    assert (walk(total, hd, blocks, un) == 1).all()


def test_write_plan_spreads_small_and_loads_large_pools():
    """One wave of resident blocks at most, with as few vectors a thread as
    that allows (up to U): a small launch takes one vector a thread over as
    many blocks as it needs, a large one up to U over the wave."""
    assert plan(32, 64, 2, 5) == (1, 1)           # one token, TinyLlama B8
    assert plan(256, 128, 2, 5) == (16, 1)        # one token, 7B B8
    assert plan(2048, 64, 2, 5) == (64, 1)        # tiny B4 sq128
    assert plan(3520, 64, 2, 5) == (110, 1)       # paged L22 B8 s5
    assert plan(32768, 128, 2, 5) == (330, 4)     # 7B B8 sq128, 5 blocks an SM
    assert plan(90112, 64, 2, 5) == (330, 4)      # paged L22 B8 s128


# ---------------------------------------------------------------- the C calls


def _chunks(lead, sq, nkv, hd, offset=0):
    """k / v as strided views of a qkv-like buffer (B.., sq, 3 * NKV * HD)."""
    buf = torch.zeros(*lead, sq, 3 * nkv * hd + 8, dtype=torch.bfloat16)
    return (buf[..., nkv * hd + offset:2 * nkv * hd + offset].view(*lead, sq, nkv, hd),
            buf[..., 2 * nkv * hd:3 * nkv * hd].view(*lead, sq, nkv, hd))


def _int8_pools(lead, nkv, s_len, hd):
    return (torch.zeros(*lead, nkv, s_len, hd, dtype=torch.int8),
            torch.zeros(*lead, nkv, s_len, hd, dtype=torch.int8),
            torch.zeros(*lead, nkv, s_len), torch.zeros(*lead, nkv, s_len))


@pytest.mark.parametrize("sq,stacked", [(128, False), (1, False), (77, True), (1, True)])
def test_int8_write_call_abi(monkeypatch, sq, stacked):
    """kv_write_slab_q8 / kv_write_col_q8 / kv_write_stacked_q8: the
    parameters csrc/kv_write.cu declares, the chunks' pointers and strides in
    elements, and the dims."""
    seen = _capture(monkeypatch)
    n_layers, b, nkv, hd, s_len, pos = 3, 4, 5, 128, 192, 37
    lead = (n_layers, b) if stacked else (b,)
    nk, nv = _chunks(lead, sq, nkv, hd)
    pools = _int8_pools(lead, nkv, s_len, hd)
    assert tda._write("t", pools, nk, nv, pos) == pools
    sym = "kv_write_stacked_q8" if stacked else "kv_write_col_q8" if sq == 1 \
        else "kv_write_slab_q8"
    assert seen["lib"] == "kv_write" and seen["sym"] == sym
    assert seen["argtypes"] == c_signature("kv_write", sym)
    args = seen["args"]
    assert len(args) == len(seen["argtypes"])
    row = 3 * nkv * hd + 8
    if sq == 1 and not stacked:
        assert args[:4] == (nk.data_ptr(), sq * row, nv.data_ptr(), sq * row)
        assert args[4:8] == tuple(t.data_ptr() for t in pools)
        assert args[8:] == (b, nkv, hd, s_len, pos, None, 0)
        return
    assert args[:6] == (nk.data_ptr(), sq * row, nk.stride(-3), nv.data_ptr(), sq * row,
                        nv.stride(-3))
    assert args[6:10] == tuple(t.data_ptr() for t in pools)
    assert args[10:] == (*lead, sq, nkv, hd, s_len, pos, None, 0)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s", [1, 77])
def test_paged_write_call_abi(monkeypatch, int8, s):
    """paged_write / paged_write_q8: the declared parameters, the chunks'
    layer / batch / token strides and the dims (the start positions and the
    table are device tensors, never read here)."""
    seen = _capture(monkeypatch)
    monkeypatch.setattr(tpw, "_device_route", lambda fn, t: True)
    n_layers, b, nkv, hd, n_pages, ps, pps = 3, 4, 5, 64, 33, 16, 8
    kn, vn = _chunks((n_layers, b), s, nkv, hd)
    shape = (n_layers, nkv, n_pages, ps, hd)
    dt = torch.int8 if int8 else torch.bfloat16
    pools = (torch.zeros(shape, dtype=dt), torch.zeros(shape, dtype=dt)) \
        + ((torch.zeros(shape[:-1]), torch.zeros(shape[:-1])) if int8 else ())
    start = torch.zeros(b, dtype=torch.int32)
    table = torch.zeros(b, pps, dtype=torch.int32)
    assert tpw.paged_write_tokens(*pools[:2], kn, vn, table, start, *pools[2:]) == pools
    name = "paged_write_q8" if int8 else "paged_write"
    assert seen["lib"] == "paged_write" and seen["sym"] == name
    assert seen["argtypes"] == c_signature("paged_write", name)
    args = seen["args"]
    assert len(args) == len(seen["argtypes"])
    row = 3 * nkv * hd + 8
    assert args[:8] == (kn.data_ptr(), b * s * row, s * row, kn.stride(2),
                        vn.data_ptr(), b * s * row, s * row, vn.stride(2))
    assert args[8:8 + len(pools)] == tuple(t.data_ptr() for t in pools)
    assert args[8 + len(pools):] == (start.data_ptr(), table.data_ptr(), pps, n_layers, b, s,
                                     nkv, hd, n_pages, ps, 0)


def test_int8_writes_refuse_unaligned_chunks(monkeypatch):
    """Both write bodies read 16-byte pieces: a chunk 4 bytes into its row
    (which the int8 entries took before, at head_dim 64) raises."""
    _capture(monkeypatch)
    monkeypatch.setattr(tpw, "_device_route", lambda fn, t: True)
    b, sq, nkv, hd = 2, 5, 2, 64
    nk, nv = _chunks((b,), sq, nkv, hd, offset=2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tda._write("t", _int8_pools((b,), nkv, 16, hd), nk, nv, 3)
    kn, vn = _chunks((1, b), sq, nkv, hd, offset=2)
    shape = (1, nkv, 9, 16, hd)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tpw.paged_write_tokens(torch.zeros(shape, dtype=torch.int8),
                               torch.zeros(shape, dtype=torch.int8), kn, vn,
                               torch.zeros(b, 8, dtype=torch.int32),
                               torch.zeros(b, dtype=torch.int32),
                               torch.zeros(shape[:-1]), torch.zeros(shape[:-1]))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("write", [False, True])
def test_mha_decode_call_abi(monkeypatch, int8, write):
    """decode_attention_mha[8][_ro] (rows 7, 8 at R 1, 14, 15 at R 1): the
    parameters csrc/decode_attention_mha.cu declares, the dims and the
    softmax scale."""
    seen = _capture(monkeypatch)
    b, nkv, hd, s_len, pos = 8, 32, 128, 1024, 511
    q = torch.zeros(b, 1, nkv, hd, dtype=torch.bfloat16)
    kn = torch.zeros(b, 1, nkv, hd, dtype=torch.bfloat16)
    pools = _int8_pools((b,), nkv, s_len, hd) if int8 else \
        (torch.zeros(b, nkv, s_len, hd, dtype=torch.bfloat16),) * 2
    out = tda._decode_kernel("t", q, kn, kn, pools, pos, write=write)
    sym = "decode_attention_mha" + ("8" if int8 else "") + ("" if write else "_ro")
    assert seen["lib"] == "decode_attention_mha" and seen["sym"] == sym
    assert seen["argtypes"] == c_signature("decode_attention_mha", sym)
    args = seen["args"]
    assert len(args) == len(seen["argtypes"])
    assert args[:6] == (q.data_ptr(), nkv * hd, kn.data_ptr(), nkv * hd, kn.data_ptr(), nkv * hd)
    assert args[6:6 + len(pools)] == tuple(t.data_ptr() for t in pools)
    assert args[6 + len(pools):-3] == (b, nkv, s_len, hd, pos, None)
    assert args[-3] == hd ** -0.5 and args[-2] == out.data_ptr() and args[-1] == 0
