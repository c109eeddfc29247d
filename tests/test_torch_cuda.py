"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge shapes beyond chip_smoke.py's main-path shapes: every GEMV row-count
template and ragged mma tiles, both RoPE styles at head_dim 64 and 128,
padded in_dim, the LLaMA2-7B projection shapes, the many-row W4 kernel at
ragged row counts and a narrow x, decode attention at R = 1..8 (R = 1 is the
MHA kernel) and head_dim 128 over the bf16 and the int8 cache, flash
attention at lengths 1..130, bf16 and int8 slab writes; the GQA int8 fused
kernel, the read-only decode kernels (fused result == read-only + one-token
write), the one-token and the stacked writes, and the stacked-cache and unfused
model paths against the CPU. Each test carries the
``cuda`` marker, needs a CUDA device and skips without one (decided inside the
fixture). On the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX, which the card's machine
does not have; this file imports only the port.)

Tolerances: kernel and plain version compute the same f32 sums in another
order, so bf16 outputs differ by at most a rounding step or two: 2e-2
relative plus 2e-2 absolute on values of magnitude ~1-4.
"""

import pytest
import torch

from accessory_tpu_torch import kernels
from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.ops.attention import grouped_attention
from accessory_tpu_torch.ops.decode_attention import (cached_attention_decode8_plain,
                                                      cached_attention_decode_plain,
                                                      cached_attention_t, cached_attention_t8,
                                                      decode_attention_update,
                                                      decode_attention_update8,
                                                      decode_attention_update8_plain,
                                                      decode_attention_update_plain,
                                                      write_kv_layer, write_kv_layer8,
                                                      write_kv_layer8_plain,
                                                      write_kv_layer_plain, write_kv_t,
                                                      write_kv_t8, write_kv_t8_plain,
                                                      write_kv_t_plain)
from accessory_tpu_torch.ops.flash_attention import flash_attention
from accessory_tpu_torch.ops.quant_matmul_bigm import planes_qmm_bigm, planes_qmm_bigm_plain
from accessory_tpu_torch.ops.quant_matmul_planes import planes_qmm, planes_qmm_plain
from accessory_tpu_torch.ops.rope import precompute_rope, rope_rows
from accessory_tpu_torch.quant.fuse import fuse_for_decode
from accessory_tpu_torch.quant.qtensor import quantize_weight, to_folded_layout
from accessory_tpu_torch.quant.quantize import quantize_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def assert_close(got, want):
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    bad = (g - w).abs() > 2e-2 + 2e-2 * w.abs()
    assert not bad.any(), f"{int(bad.sum())} of {g.numel()} off; max {float((g - w).abs().max())}"


def _w4(gen, k, n, pad_in_to=None):
    w = randn(gen, k, n, dtype=torch.float32, scale=k ** -0.5)
    return to_folded_layout(quantize_weight(w, 4, 128, pad_in_to=pad_in_to))


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 11, 16, 17, 100, 300])
@pytest.mark.parametrize("fusion", ["none", "norm+res", "rope_interleaved", "rope_half"])
def test_w4_matmul(gen, m, fusion):
    k, n, hd = 256, 512, 64
    qw = _w4(gen, k, n)
    kw = {}
    if fusion == "norm+res":
        kw.update(norm_weight=1 + 0.1 * randn(gen, k, dtype=torch.float32),
                  residual=randn(gen, m, n))
    if fusion.startswith("rope"):
        style = fusion.split("_")[1]
        cos, sin = precompute_rope(hd, 64, device="cuda")
        cr, sr = rope_rows(cos[13], sin[13], n // hd - 2, 2, hd, style)
        kw.update(rope_cos=cr, rope_sin=sr, rope_style=style, rope_hd=hd)
    x = randn(gen, m, k)
    args = (x, qw.packed, qw.scales, qw.zeros)
    got = planes_qmm(*args, in_dim=qw.in_dim, group_size=128, **kw)
    assert_close(got, planes_qmm_plain(*args, in_dim=qw.in_dim, group_size=128, **kw))


@pytest.mark.parametrize("m", [4, 40])
@pytest.mark.parametrize("style", ["interleaved", "half"])
def test_w4_matmul_rope_head_dim_128(gen, m, style):
    k, n, hd = 256, 768, 128
    qw = _w4(gen, k, n)
    cos, sin = precompute_rope(hd, 64, device="cuda")
    cr, sr = rope_rows(cos[7], sin[7], 4, 2, hd, style)
    x = randn(gen, m, k)
    kw = dict(in_dim=k, group_size=128, rope_style=style, rope_hd=hd)
    assert_close(planes_qmm(x, qw.packed, qw.scales, qw.zeros, None, None, cr, sr, **kw),
                 planes_qmm_plain(x, qw.packed, qw.scales, qw.zeros, None, None, cr, sr, **kw))


@pytest.mark.parametrize("m", [8, 64])
def test_w4_matmul_padded_in_dim(gen, m):
    """x narrower than a padded in_dim (the w2 case: 5632 padded to 6144)."""
    qw = _w4(gen, 1152, 256, pad_in_to=1024)
    assert qw.in_dim == 2048
    x = randn(gen, m, 1152)
    res = randn(gen, m, 256)
    got = planes_qmm(x, qw.packed, qw.scales, qw.zeros, None, res, in_dim=2048, group_size=128)
    assert_close(got, planes_qmm_plain(x, qw.packed, qw.scales, qw.zeros, None, res,
                                       in_dim=2048, group_size=128))


def test_w4_matmul_refuses(gen):
    """A fused call of 1024 rows or more still raises (the tile kernel does
    not take it, the many-row kernel has no fusions); an unfused one runs the
    many-row kernel through quant_matmul."""
    from accessory_tpu_torch.quant.qtensor import quant_matmul

    qw = _w4(gen, 256, 256)
    x = randn(gen, 1024, 256)
    with pytest.raises(NotImplementedError, match="row 5"):
        planes_qmm(x, qw.packed, qw.scales, qw.zeros, None, randn(gen, 1024, 256), in_dim=256,
                   group_size=128)
    before = kernels.launch_counts()
    got = quant_matmul(x, qw)
    after = kernels.launch_counts()
    assert after["w4_matmul_bigm"] == before["w4_matmul_bigm"] + 1
    assert after["w4_matmul"] == before["w4_matmul"]
    assert_close(got, planes_qmm_bigm_plain(x, qw.packed, qw.scales, qw.zeros, in_dim=256,
                                            group_size=128))
    with pytest.raises(ValueError):
        planes_qmm(randn(gen, 8, 256, dtype=torch.float32), qw.packed, qw.scales, qw.zeros,
                   in_dim=256, group_size=128)


@pytest.mark.parametrize("m", [1, 127, 128, 129, 1000, 1024, 1100])
@pytest.mark.parametrize("k,kx,n,gs", [(256, 256, 128, 128), (2048, 1152, 384, 128),
                                       (512, 512, 256, 64)])
def test_w4_matmul_bigm(gen, m, k, kx, n, gs):
    """Ragged row tiles, x narrower than a padded in_dim, group size 64."""
    w = randn(gen, k, n, dtype=torch.float32, scale=k ** -0.5)
    qw = to_folded_layout(quantize_weight(w, 4, gs))
    x = randn(gen, m, kx)
    got = planes_qmm_bigm(x, qw.packed, qw.scales, qw.zeros, in_dim=k, group_size=gs)
    assert_close(got, planes_qmm_bigm_plain(x, qw.packed, qw.scales, qw.zeros, in_dim=k,
                                            group_size=gs))


def test_w4_matmul_bigm_strided_x(gen):
    """x as a column slice of a wider buffer (row stride > Kx)."""
    qw = _w4(gen, 256, 128)
    x = randn(gen, 1030, 512)[:, 128:384]
    got = planes_qmm_bigm(x, qw.packed, qw.scales, qw.zeros, in_dim=256, group_size=128)
    assert_close(got, planes_qmm_bigm_plain(x, qw.packed, qw.scales, qw.zeros, in_dim=256,
                                            group_size=128))
    with pytest.raises(ValueError, match="128-column"):
        qn = _w4(gen, 256, 192)
        planes_qmm_bigm(x, qn.packed, qn.scales, qn.zeros, in_dim=256, group_size=128)


@pytest.mark.parametrize("m", [8, 200])
@pytest.mark.parametrize("name,k,n,fusion", [("wqkv", 4096, 12288, "norm+rope_interleaved"),
                                             ("wqkv", 4096, 12288, "norm+rope_half"),
                                             ("wo", 4096, 4096, "res"),
                                             ("w13", 4096, 22016, "norm"),
                                             ("w2", 11008, 4096, "res")])
def test_w4_matmul_llama2_7b_shapes(gen, m, name, k, n, fusion):
    """The LLaMA2-7B projections: K 4096 with the norm prologue, K 11008
    padded to 11264, N 22016 = 172 x 128, RoPE at head_dim 128 in both styles."""
    from accessory_tpu_torch.quant.quantize import pad_to

    qw = _w4(gen, k, n, pad_in_to=pad_to(k, 128))
    assert qw.in_dim == (11264 if k == 11008 else k)
    kw = {}
    if "norm" in fusion:
        kw["norm_weight"] = 1 + 0.1 * randn(gen, k, dtype=torch.float32)
    if fusion == "res":
        kw["residual"] = randn(gen, m, n)
    if "rope" in fusion:
        style = fusion.split("_")[1]
        cos, sin = precompute_rope(128, 64, device="cuda")
        cr, sr = rope_rows(cos[13], sin[13], 64, 32, 128, style)
        kw.update(rope_cos=cr, rope_sin=sr, rope_style=style, rope_hd=128)
    args = (randn(gen, m, k), qw.packed, qw.scales, qw.zeros)
    got = planes_qmm(*args, in_dim=qw.in_dim, group_size=128, **kw)
    assert_close(got, planes_qmm_plain(*args, in_dim=qw.in_dim, group_size=128, **kw))


def test_wrappers_refuse_mixed_devices(gen):
    """A CPU operand beside CUDA ones would hand the kernel a host pointer."""
    qw = _w4(gen, 256, 256)
    with pytest.raises(ValueError, match="device"):
        planes_qmm(randn(gen, 8, 256), qw.packed.cpu(), qw.scales, qw.zeros, in_dim=256,
                   group_size=128)
    q, kn = randn(gen, 1, 1, 4, 64), randn(gen, 1, 1, 2, 64)
    ck = randn(gen, 1, 2, 16, 64)
    with pytest.raises(ValueError, match="device"):
        decode_attention_update(q, kn, kn, ck, ck.cpu(), 3)
    with pytest.raises(ValueError, match="device"):
        flash_attention(q, kn.cpu(), kn)
    with pytest.raises(ValueError, match="device"):
        write_kv_layer(ck, ck.cpu(), kn, kn, 0)


@pytest.mark.parametrize("hd,r", [(64, 1), (64, 2), (64, 8), (128, 1), (128, 4)])
@pytest.mark.parametrize("s_len,pos", [(64, 0), (64, 1), (64, 63), (200, 64), (200, 199)])
def test_decode_attention(gen, hd, r, s_len, pos):
    b, nkv = 3, 2
    nq = nkv * r
    qkv = randn(gen, b, 1, (nq + 2 * nkv) * hd)
    q = qkv[..., :nq * hd].view(b, 1, nq, hd)
    kn = qkv[..., nq * hd:(nq + nkv) * hd].view(b, 1, nkv, hd)
    vn = qkv[..., (nq + nkv) * hd:].view(b, 1, nkv, hd)
    ck, cv = randn(gen, b, nkv, s_len, hd), randn(gen, b, nkv, s_len, hd)
    ck2, cv2 = ck.clone(), cv.clone()
    name = "decode_attention_mha" if r == 1 else "decode_attention"   # the R == 1 dispatch
    before = kernels.launch_counts()
    got, gk, gv = decode_attention_update(q, kn, vn, ck, cv, pos)
    after = kernels.launch_counts()
    assert after[name] == before[name] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    want, wk, wv = decode_attention_update_plain(q, kn, vn, ck2, cv2, pos)
    assert_close(got, want)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


def _int8_pools(gen, b, nkv, s_len, hd):
    ck = torch.randint(-127, 128, (b, nkv, s_len, hd), generator=gen, device="cuda",
                       dtype=torch.int8)
    cv = torch.randint(-127, 128, (b, nkv, s_len, hd), generator=gen, device="cuda",
                       dtype=torch.int8)
    ks = 0.005 + 0.015 * torch.rand((b, nkv, s_len), generator=gen, device="cuda")
    vs = 0.005 + 0.015 * torch.rand((b, nkv, s_len), generator=gen, device="cuda")
    return ck, cv, ks, vs


def assert_pools8(got, want):
    """int8 pools equal; scale pools to f32 rounding (the kernel and the
    plain version divide the same amax by 127)."""
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        assert bool(((g - w).abs() <= 2e-7 * w.abs()).all())


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s_len,pos", [(64, 0), (64, 1), (64, 63), (200, 64), (200, 199),
                                       (1024, 700)])
def test_decode_attention_int8(gen, hd, s_len, pos):
    b, nkv = 3, 4
    qkv = randn(gen, b, 1, 3 * nkv * hd)
    q = qkv[..., :nkv * hd].view(b, 1, nkv, hd)
    kn = qkv[..., nkv * hd:2 * nkv * hd].view(b, 1, nkv, hd)
    vn = qkv[..., 2 * nkv * hd:].view(b, 1, nkv, hd)
    if pos == 1:
        kn[0, 0, 0] = 0   # an all-zero vector: scale 1e-6 / 127, zeros
    pools = _int8_pools(gen, b, nkv, s_len, hd)
    pools2 = tuple(p.clone() for p in pools)
    before = kernels.launch_counts()["decode_attention_mha8"]
    got = decode_attention_update8(q, kn, vn, *pools, pos)
    assert kernels.launch_counts()["decode_attention_mha8"] == before + 1
    want = decode_attention_update8_plain(q, kn, vn, *pools2, pos)
    assert_close(got[0], want[0])
    assert_pools8(got[1:], want[1:])
    if pos == 1:
        assert float(got[3][0, 0, 1]) == pytest.approx(1e-6 / 127, rel=1e-6)
        assert not got[1][0, 0, 1].any()


def test_decode_attention_int8_refuses_gqa(gen):
    """What the int8 wrapper still refuses: a scale pool on another device, a
    position as a tensor (int8 GQA itself is served, see
    test_decode_attention_int8_gqa)."""
    kn = randn(gen, 1, 1, 2, 64)
    pools = _int8_pools(gen, 1, 2, 16, 64)
    with pytest.raises(ValueError, match="device"):
        decode_attention_update8(kn, kn, kn, pools[0], pools[1], pools[2].cpu(), pools[3], 3)
    with pytest.raises(NotImplementedError, match="paged_cached_attention"):
        decode_attention_update8(kn, kn, kn, *pools, torch.tensor([3]))


def _qkv(gen, b, nq, nkv, hd):
    qkv = randn(gen, b, 1, (nq + 2 * nkv) * hd)
    return (qkv[..., :nq * hd].view(b, 1, nq, hd),
            qkv[..., nq * hd:(nq + nkv) * hd].view(b, 1, nkv, hd),
            qkv[..., (nq + nkv) * hd:].view(b, 1, nkv, hd))


def _one_more(name, fn):
    """Run fn; exactly one launch, of entry ``name``, must have been counted."""
    before = kernels.launch_counts()
    out = fn()
    after = kernels.launch_counts()
    assert after[name] == before[name] + 1, (name, before, after)
    assert sum(after.values()) == sum(before.values()) + 1
    return out


@pytest.mark.parametrize("hd,r", [(64, 2), (64, 8), (64, 32), (128, 4), (128, 16)])
@pytest.mark.parametrize("s_len,pos", [(64, 0), (64, 1), (64, 63), (200, 64), (200, 199),
                                       (1024, 700)])
def test_decode_attention_int8_gqa(gen, hd, r, s_len, pos):
    """The fused GQA int8 kernel (_kernel_bloop_w8) against its plain version:
    outputs inside the kernel tolerance, int8 pools equal, scales to f32
    rounding; an all-zero new vector keeps scale 1e-6 / 127."""
    b, nkv = 3, 2
    q, kn, vn = _qkv(gen, b, nkv * r, nkv, hd)
    if pos == 1:
        kn[0, 0, 0] = 0
    pools = _int8_pools(gen, b, nkv, s_len, hd)
    pools2 = tuple(p.clone() for p in pools)
    got = _one_more("decode_attention8", lambda: decode_attention_update8(q, kn, vn, *pools, pos))
    want = decode_attention_update8_plain(q, kn, vn, *pools2, pos)
    assert_close(got[0], want[0])
    assert_pools8(got[1:], want[1:])
    if pos == 1:
        assert float(got[3][0, 0, 1]) == pytest.approx(1e-6 / 127, rel=1e-6)
        assert not got[1][0, 0, 1].any()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hd,r", [(64, 1), (64, 4), (64, 8), (128, 1), (128, 4)])
@pytest.mark.parametrize("s_len,pos", [(64, 0), (64, 1), (200, 127), (200, 128), (200, 199),
                                       (200, 200)])
def test_read_only_decode_attention(gen, int8, hd, r, s_len, pos):
    """cached_attention_t / cached_attention_t8 at one token (_kernel_bloop,
    _kernel, _kernel_bloop8): the read-only kernel against its plain version,
    pools untouched, R == 1 on the one-query-head kernel; and (pos < S) the
    unfused route (read-only attention + one-token write) against the fused
    kernel: the same pools, outputs inside the kernel tolerance."""
    b, nkv = 3, 2
    q, kn, vn = _qkv(gen, b, nkv * r, nkv, hd)
    pools = _int8_pools(gen, b, nkv, s_len, hd) if int8 else (randn(gen, b, nkv, s_len, hd),
                                                              randn(gen, b, nkv, s_len, hd))
    keep = tuple(p.clone() for p in pools)
    name = ("decode_attention_mha" if r == 1 else "decode_attention") \
        + ("8" if int8 else "") + "_ro"
    attn, plain = (cached_attention_t8, cached_attention_decode8_plain) if int8 \
        else (cached_attention_t, cached_attention_decode_plain)
    got = _one_more(name, lambda: attn(q, kn, vn, *pools, pos))
    assert_close(got, plain(q, kn, vn, *keep, pos))
    assert all(torch.equal(a, b_) for a, b_ in zip(pools, keep))
    if pos == s_len:
        return
    update = decode_attention_update8 if int8 else decode_attention_update
    fused = update(q, kn, vn, *keep, pos)
    before = kernels.launch_counts()
    unfused = update(q, kn, vn, *pools, pos, fused_attn_write=False)
    after = kernels.launch_counts()
    col = "kv_write_col_q8" if int8 else "kv_write_col"
    assert after[name] == before[name] + 1 and after[col] == before[col] + 1
    assert sum(after.values()) == sum(before.values()) + 2
    assert_close(unfused[0], fused[0])
    if int8:
        assert_pools8(unfused[1:], fused[1:])
    else:
        assert all(torch.equal(a, b_) for a, b_ in zip(unfused[1:], fused[1:]))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("sq,pos", [(1, 0), (1, 77), (1, 159), (128, 0), (7, 150)])
def test_stacked_write(gen, int8, hd, sq, pos):
    """write_kv_t / write_kv_t8: all layers in one launch against the plain
    copy, from a torch.stack of per-layer chunks (strided views stacked)."""
    n_layers, b, nkv, s_len = 3, 2, 2, 160
    chunks = []
    for _ in range(n_layers):
        buf = randn(gen, b, sq, 3 * nkv * hd, scale=2.0)
        chunks.append((buf[..., :nkv * hd].view(b, sq, nkv, hd),
                       buf[..., 2 * nkv * hd:].view(b, sq, nkv, hd)))
    nk, nv = torch.stack([c[0] for c in chunks]), torch.stack([c[1] for c in chunks])
    if int8:
        pools = tuple(torch.stack(ps) for ps in zip(*(_int8_pools(gen, b, nkv, s_len, hd)
                                                      for _ in range(n_layers))))
        pools2 = tuple(p.clone() for p in pools)
        got = _one_more("kv_write_stacked_q8", lambda: write_kv_t8(*pools, nk, nv, pos))
        assert_pools8(got, write_kv_t8_plain(*pools2, nk, nv, pos))
        return
    pools = (randn(gen, n_layers, b, nkv, s_len, hd), randn(gen, n_layers, b, nkv, s_len, hd))
    pools2 = tuple(p.clone() for p in pools)
    name = "kv_write_stacked_col" if sq == 1 else "kv_write_stacked"
    got = _one_more(name, lambda: write_kv_t(*pools, nk, nv, pos))
    want = write_kv_t_plain(*pools2, nk, nv, pos)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="stacked evenly"):
        # layers not a whole number of batch strides apart: not one (L * B)-row problem
        write_kv_t(*pools, randn(gen, n_layers, 2, b, sq, nkv, hd)[:, 0], nv, pos)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("sq,pos", [(1, 0), (1, 9), (7, 5), (128, 0), (130, 30)])
def test_slab_write8(gen, hd, sq, pos):
    b, nkv, s_len = 2, 3, 160
    buf = randn(gen, b, sq, 3 * nkv * hd, scale=2.0)
    nk = buf[..., :nkv * hd].view(b, sq, nkv, hd)
    nv = buf[..., 2 * nkv * hd:].view(b, sq, nkv, hd)
    nk[0, 0, 0] = 0
    pools = _int8_pools(gen, b, nkv, s_len, hd)
    pools2 = tuple(p.clone() for p in pools)
    # one token goes to the column-write entry (_col_write_kernel4_q8)
    got = _one_more("kv_write_col_q8" if sq == 1 else "kv_write_q8",
                    lambda: write_kv_layer8(*pools, nk, nv, pos))
    want = write_kv_layer8_plain(*pools2, nk, nv, pos)
    assert_pools8(got, want)
    with pytest.raises(ValueError, match="device"):
        write_kv_layer8(pools[0], pools[1], pools[2], pools[3].cpu(), nk, nv, pos)


@pytest.mark.parametrize("s", [1, 17, 64, 65, 130])
@pytest.mark.parametrize("hd,nq,nkv", [(64, 4, 4), (64, 8, 2), (128, 4, 1)])
def test_flash_attention(gen, s, hd, nq, nkv):
    b = 2
    q, k = randn(gen, b, s, nq, hd), randn(gen, b, s, nkv, hd)
    v = randn(gen, b, s, 2 * nkv * hd)[..., nkv * hd:].view(b, s, nkv, hd)
    assert_close(flash_attention(q, k, v), grouped_attention(q, k, v, causal=True))


@pytest.mark.parametrize("sq,pos", [(1, 0), (1, 9), (7, 5), (128, 0)])
def test_slab_write(gen, sq, pos):
    b, nkv, hd, s_len = 2, 2, 64, 160
    buf = randn(gen, b, sq, 3 * nkv * hd)
    nk = buf[..., :nkv * hd].view(b, sq, nkv, hd)
    nv = buf[..., 2 * nkv * hd:].view(b, sq, nkv, hd)
    ck, cv = randn(gen, b, nkv, s_len, hd), randn(gen, b, nkv, s_len, hd)
    ck2, cv2 = ck.clone(), cv.clone()
    # one token goes to the column-write entry (_col_write_kernel4)
    _one_more("kv_write_col" if sq == 1 else "kv_write",
              lambda: write_kv_layer(ck, cv, nk, nv, pos))
    write_kv_layer_plain(ck2, cv2, nk, nv, pos)
    torch.cuda.synchronize()
    assert torch.equal(ck, ck2) and torch.equal(cv, cv2)


def test_small_model_cuda_matches_cpu(gen):
    """A 2-layer dim-256 W4 model: prefill and decode logits, card vs CPU."""
    args = LLaMAArgs(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512,
                     multiple_of=128, max_seq_len=128)
    params = fuse_for_decode(quantize_params(llama.init_params(args, seed=1)))
    cpu = _to(params, "cpu")
    toks = torch.randint(0, 512, (3, 40), generator=torch.Generator().manual_seed(0))
    cg, cc = llama.init_kv_cache(args, 3, 64), llama.init_kv_cache(args, 3, 64, device="cpu")
    lg, _ = llama.forward(params, args, toks[:, :32].cuda(), cache=cg, cur_pos=0)
    lc, _ = llama.forward(cpu, args, toks[:, :32], cache=cc, cur_pos=0)
    pairs = [(lg, lc)]
    for p in range(32, 40):
        lg, _ = llama.forward(params, args, toks[:, p:p + 1].cuda(), cache=cg, cur_pos=p)
        lc, _ = llama.forward(cpu, args, toks[:, p:p + 1], cache=cc, cur_pos=p)
        pairs.append((lg, lc))
    for g, c in pairs:
        g = g.cpu()
        assert float((g - c).norm() / c.norm()) < 2e-2
        assert float((g - c).abs().max()) < 2e-2 * float(c.abs().max()) + 2e-2


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_small_mha_model_cuda_matches_cpu(gen, kv_dtype):
    """A 2-layer dim-256 MHA W4 model with a 1024-row prefill (the many-row
    kernel) and decode over the bf16 or the int8 cache, card vs CPU; every
    kernel of that path is launched and no other."""
    args = LLaMAArgs(dim=256, n_layers=2, n_heads=4, vocab_size=512, multiple_of=128,
                     max_seq_len=256)
    params = fuse_for_decode(quantize_params(llama.init_params(args, seed=2)))
    cpu = _to(params, "cpu")
    toks = torch.randint(0, 512, (8, 134), generator=torch.Generator().manual_seed(0))
    cg = llama.init_kv_cache(args, 8, 160, kv_dtype=kv_dtype)
    cc = llama.init_kv_cache(args, 8, 160, kv_dtype=kv_dtype, device="cpu")
    kernels.reset_launch_counts()
    lg, _ = llama.forward(params, args, toks[:, :128].cuda(), cache=cg, cur_pos=0)
    lc, _ = llama.forward(cpu, args, toks[:, :128], cache=cc, cur_pos=0)
    pairs = [(lg, lc)]
    for p in range(128, 134):
        lg, _ = llama.forward(params, args, toks[:, p:p + 1].cuda(), cache=cg, cur_pos=p)
        lc, _ = llama.forward(cpu, args, toks[:, p:p + 1], cache=cc, cur_pos=p)
        pairs.append((lg, lc))
    int8 = kv_dtype == "int8"
    want = {name: 0 for name in kernels.KERNELS}
    want.update({"w4_matmul": 4 * 2 * 6, "w4_matmul_bigm": 4 * 2, "flash_attention": 2,
                 "decode_attention_mha8" if int8 else "decode_attention_mha": 2 * 6,
                 "kv_write_q8" if int8 else "kv_write": 2})
    assert kernels.launch_counts() == want
    for g, c in pairs:
        g = g.cpu()
        assert float((g - c).norm() / c.norm()) < 2e-2
        assert float((g - c).abs().max()) < 2e-2 * float(c.abs().max()) + 2e-2


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("path", ["fused", "unfused", "stacked"])
def test_small_gqa_model_paths_cuda_match_cpu(gen, kv_dtype, path):
    """A 3-layer dim-256 GQA W4 model over the bf16 or the int8 cache, card vs
    CPU, on the fused per-layer path, the unfused per-layer route
    (fused_attn_write=False) and the stacked-cache path (separate projections,
    read-only attention, one bulk write, plus a chunk after cached tokens);
    every kernel of the path is launched exactly as often as the path says
    and no other."""
    args = LLaMAArgs(dim=256, n_layers=3, n_heads=4, n_kv_heads=2, vocab_size=512,
                     multiple_of=128, max_seq_len=128)
    params = quantize_params(llama.init_params(args, seed=3))
    stacked = path == "stacked"
    if not stacked:
        params = fuse_for_decode(params)
    cpu = _to(params, "cpu")
    toks = torch.randint(0, 512, (3, 50), generator=torch.Generator().manual_seed(0))
    cg = llama.init_kv_cache(args, 3, 64, kv_dtype=kv_dtype, stacked=stacked)
    cc = llama.init_kv_cache(args, 3, 64, kv_dtype=kv_dtype, device="cpu", stacked=stacked)
    kw = dict(fused_attn_write=path != "unfused")
    kernels.reset_launch_counts()
    steps = [(0, 32)] + ([(32, 40)] if stacked else []) + [(p, p + 1) for p in
                                                           range(40 if stacked else 32, 46)]
    pairs = []
    for lo, hi in steps:
        lg, _ = llama.forward(params, args, toks[:, lo:hi].cuda(), cache=cg, cur_pos=lo, **kw)
        lc, _ = llama.forward(cpu, args, toks[:, lo:hi], cache=cc, cur_pos=lo, **kw)
        pairs.append((lg, lc))
    int8 = kv_dtype == "int8"
    n_dec = sum(hi - lo == 1 for lo, hi in steps)
    want = {name: 0 for name in kernels.KERNELS}
    sfx = "8" if int8 else ""
    if stacked:
        want.update({"w4_matmul": 7 * 3 * len(steps), "flash_attention": 3,
                     f"decode_attention{sfx}_ro": 3 * n_dec})
        if int8:
            want["kv_write_stacked_q8"] = len(steps)
        else:
            want.update(kv_write_stacked=2, kv_write_stacked_col=n_dec)
    else:
        want.update({"w4_matmul": 4 * 3 * len(steps), "flash_attention": 3,
                     "kv_write_q8" if int8 else "kv_write": 3})
        if path == "fused":
            want[f"decode_attention{sfx}"] = 3 * n_dec
        else:
            want[f"decode_attention{sfx}_ro"] = 3 * n_dec
            want["kv_write_col_q8" if int8 else "kv_write_col"] = 3 * n_dec
    assert kernels.launch_counts() == want
    for g, c in pairs:
        g = g.cpu()
        assert float((g - c).norm() / c.norm()) < 2e-2
        assert float((g - c).abs().max()) < 2e-2 * float(c.abs().max()) + 2e-2


def _to(node, device):
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, device) for v in node]
    return node.to(device)


# ---------------------------------------------------------------- paged KV cache


def _paged_case(gen, b, nkv, hd, ps, pps, n_pages, int8, lengths, layers=1):
    """Random pools (layers, nkv, n_pages, ps, hd), a shuffled page table whose
    rows share their first page and end in TRASH entries, and the lengths."""
    shape = (layers, nkv, n_pages, ps, hd)
    if int8:
        pools = (torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8),
                 torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8),
                 0.005 + 0.015 * torch.rand(shape[:-1], generator=gen, device="cuda"),
                 0.005 + 0.015 * torch.rand(shape[:-1], generator=gen, device="cuda"))
    else:
        pools = (randn(gen, *shape), randn(gen, *shape), None, None)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(b * pps)) + 1
    table = perm[:b * pps].reshape(b, pps).to(torch.int32)
    table[:, 0] = table[0, 0]                 # a page every slot shares (a prefix-cache hit)
    table[:, -1] = 0                          # TRASH past the allocation
    lens = torch.tensor(lengths, dtype=torch.int32)
    return pools, table.cuda(), lens.cuda()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hd,r", [(64, 8), (64, 1), (128, 1), (128, 4)])
@pytest.mark.parametrize("sq", [1, 5, 16])
@pytest.mark.parametrize("ps", [16, 64])
def test_paged_decode(gen, int8, hd, r, sq, ps):
    """paged_decode_attention (both entries) against its plain version:
    lengths 0, 1, ps - 1, ps, ps + 1 and the whole active range, a shared
    page, a shuffled table, sq new tokens causal among themselves, GQA and
    one query head per KV head; the pools are not written."""
    from accessory_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                                      paged_decode_attention_plain)

    nkv, pps, active = 2, 6, 5
    lengths = [0, 1, ps - 1, ps, ps + 1, active * ps]
    b = len(lengths)
    pools, table, lens = _paged_case(gen, b, nkv, hd, ps, pps, b * pps + 3, int8, lengths)
    keep = [p.clone() for p in pools if p is not None]
    q, kn, vn = randn(gen, b, sq, nkv * r, hd), randn(gen, b, sq, nkv, hd), randn(gen, b, sq, nkv, hd)
    name = "paged_decode8" if int8 else "paged_decode"
    before = kernels.launch_counts()[name]
    got = paged_decode_attention(q, kn, vn, pools[0], pools[1], lens, table, active,
                                 pools[2], pools[3], layer=0)
    assert kernels.launch_counts()[name] == before + 1
    want = paged_decode_attention_plain(q, kn, vn, pools[0], pools[1], lens, table, active,
                                        pools[2], pools[3], layer=0)
    assert_close(got, want)
    assert all(torch.equal(a, b_) for a, b_ in zip([p for p in pools if p is not None], keep))


@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_identity_table_is_the_static_kernel(gen, int8):
    """Over an identity page table the paged kernel computes what the static
    cache's read-only kernel computes on the same contents."""
    from accessory_tpu_torch.ops.paged_decode import paged_decode_attention

    b, nkv, r, hd, ps, pps, pos = 4, 4, 8, 64, 64, 4, 150
    s_len = ps * pps
    if int8:
        pools = _int8_pools_static(gen, b, nkv, s_len, hd)
    else:
        pools = (randn(gen, b, nkv, s_len, hd), randn(gen, b, nkv, s_len, hd))
    q, kn, vn = randn(gen, b, 1, nkv * r, hd), randn(gen, b, 1, nkv, hd), randn(gen, b, 1, nkv, hd)
    want = (cached_attention_t8 if int8 else cached_attention_t)(q, kn, vn, *pools, pos)
    # slot-major pages: page j of slot i is the i * pps + j'th physical page
    paged = [p.reshape(b, nkv, pps, ps, *p.shape[3:]).transpose(0, 1)
             .reshape(nkv, b * pps, ps, *p.shape[3:]).contiguous() for p in pools]
    table = torch.arange(b * pps, dtype=torch.int32, device="cuda").reshape(b, pps)
    lens = torch.full((b,), pos, dtype=torch.int32, device="cuda")
    got = paged_decode_attention(q, kn, vn, paged[0], paged[1], lens, table, None,
                                 *(paged[2:] if int8 else (None, None)))
    assert_close(got, want)


def _int8_pools_static(gen, b, nkv, s_len, hd):
    shape = (b, nkv, s_len, hd)
    return (torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8),
            torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8),
            0.005 + 0.015 * torch.rand(shape[:-1], generator=gen, device="cuda"),
            0.005 + 0.015 * torch.rand(shape[:-1], generator=gen, device="cuda"))


def test_paged_decode_refuses(gen):
    """A call the kernel cannot take raises: head_dim 32, f32 q, int64 lengths."""
    from accessory_tpu_torch.ops.paged_decode import paged_decode_attention

    pools, table, lens = _paged_case(gen, 2, 2, 64, 16, 4, 12, False, [3, 5])
    q, kn, vn = randn(gen, 2, 1, 4, 64), randn(gen, 2, 1, 2, 64), randn(gen, 2, 1, 2, 64)
    with pytest.raises(ValueError):
        paged_decode_attention(q.float(), kn, vn, pools[0], pools[1], lens, table, layer=0)
    with pytest.raises(ValueError):
        paged_decode_attention(q, kn, vn, pools[0], pools[1], lens.long(), table, layer=0)
    with pytest.raises(ValueError):
        paged_decode_attention(q[..., :32], kn[..., :32], vn[..., :32],
                               pools[0][..., :32].contiguous(), pools[1][..., :32].contiguous(),
                               lens, table, layer=0)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", [1, 5, 128])
def test_paged_write(gen, int8, hd, s):
    """paged_write_tokens (both entries) against its plain version across
    page boundaries, a slot whose positions run past its table (TRASH), and
    k/v as strided views of a wider buffer: the pools outside the TRASH page
    equal (int8 values equal, scales to f32 rounding)."""
    from accessory_tpu_torch.ops.paged_write import paged_write_tokens, paged_write_tokens_plain

    n_layers, b, nkv, ps, pps = 3, 4, 2, 64, 4
    pools, _, _ = _paged_case(gen, b, nkv, hd, ps, pps, b * pps + 2, int8, [0] * b,
                              layers=n_layers)
    # distinct pages (no two slots write one page), slot 3's last entry TRASH
    perm = torch.randperm(b * pps + 1, generator=torch.Generator().manual_seed(s)) + 1
    table = perm[:b * pps].reshape(b, pps).to(torch.int32)
    table[3, -1] = 0
    table = table.cuda()
    # slot 3's positions run past its table (into TRASH); the others stay inside
    start = [0, ps - 2, 2 * ps + 7]
    start = torch.tensor([min(x, pps * ps - s) for x in start] + [pps * ps - 3],
                         dtype=torch.int32, device="cuda")
    buf = randn(gen, n_layers, b, s, 3 * nkv * hd)
    kn = buf[..., :nkv * hd].view(n_layers, b, s, nkv, hd)
    vn = buf[..., 2 * nkv * hd:].view(n_layers, b, s, nkv, hd)
    pools = [p for p in pools if p is not None]
    plain = [p.clone() for p in pools]
    name = "paged_write_q8" if int8 else "paged_write"
    before = kernels.launch_counts()[name]
    paged_write_tokens(*pools[:2], kn, vn, table, start, *pools[2:])
    assert kernels.launch_counts()[name] == before + 1
    paged_write_tokens_plain(*plain[:2], kn, vn, table, start, *plain[2:])
    torch.cuda.synchronize()
    for got, want in zip(pools, plain):
        g, w = got[:, :, 1:], want[:, :, 1:]
        if got.dtype == torch.float32:
            assert not bool(((g - w).abs() > 2e-7 * w.abs()).any())
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_small_model_batcher_cuda_matches_cpu(gen, kv_dtype):
    """A 2-layer dim-256 W4 GQA model through the ContinuousBatcher on the
    card and on the CPU: the same greedy tokens wherever the CPU's logits are
    sure (printed margin), the allocator balanced, and the card run launched
    the paged kernels and no static-cache attention."""
    from accessory_tpu_torch.engine.scheduler import ContinuousBatcher

    class Tok:
        bos_id, eos_id, n_words = 510, 511, 512

        def encode(self, s, bos, eos):
            return [self.bos_id] * bos + list(s.encode())

        def decode(self, t):
            return ",".join(map(str, t))

        def encode_segment(self, s):
            return self.encode(s, False, False)

        encode_wo_prefix_space = encode_segment

    args = LLaMAArgs(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512,
                     multiple_of=128, max_seq_len=256)
    params = quantize_params(llama.init_params(args, seed=4))
    cpu = _to(params, "cpu")
    prompts = ["the quick brown fox", "hello", "a" * 70, "jumps over the lazy dog"]
    outs = {}
    for device, p in (("cuda", params), ("cpu", cpu)):
        kernels.reset_launch_counts()
        cb = ContinuousBatcher(llama, args, p, Tok(), slots=2, page_size=64, decode_steps=4,
                               kv_dtype=kv_dtype, device=device)
        outs[device] = cb.run(prompts, max_gen_len=12)
        assert cb.pool.free_pages == cb.total_pages - 1
        assert all(not v for v in cb.slot_pages.values())
        counts = kernels.launch_counts()
        if device == "cuda":
            sfx = "8" if kv_dtype else ""
            assert counts[f"paged_decode{sfx}"] > 0 and counts[f"paged_write{'_q8' if kv_dtype else ''}"] > 0
            assert counts["flash_attention"] > 0 and counts["decode_attention"] == 0
    assert all(len(o) > 0 for o in outs["cuda"])
    same = sum(a == b_ for a, b_ in zip(outs["cuda"], outs["cpu"]))
    print(f"batcher cuda vs cpu: {same} of {len(prompts)} texts equal")
