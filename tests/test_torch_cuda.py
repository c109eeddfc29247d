"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge shapes beyond chip_smoke.py's main-path shapes: every GEMV row-count
template and ragged tiles, both RoPE styles at head_dim 64 and 128,
padded in_dim, the LLaMA2-7B projection shapes, the many-row W4 kernel at
ragged row counts (around its 256-row tile, up to 4096), a narrow x and the
7B projections (bit-equal across launches and grids), decode attention at
R = 1..8 (R = 1 is the MHA kernel) and head_dim 128 over the bf16 and the
int8 cache, the split decode kernels (csrc/decode_split.cuh) at every rank
edge (empty ranks, each rank's first token, full caches, length-0 slots,
pages of 16 and 128 tokens, two calls bit-equal, the paged kernel over an
identity table against the static one at both plans), flash attention at
lengths 1..4096 (its lse, and every packing of a group's heads into a block
bit for bit), bf16 and int8 slab writes; the GQA int8 fused
kernel, the read-only decode kernels (fused result == read-only + one-token
write), the one-token and the stacked writes, the stacked-cache and unfused
model paths against the CPU, and the many-row W4 tiles (row 1 at 17-1023
rows with every fusion, std / magic from 9 rows, N = 136; every K split bit
for bit across launches and within tolerance of the unsplit plan), the W8
tile (9-1030 rows, every fusion, N % 16 == 8), the std / magic GEMV
(every row count 1-8, each cluster split twice bit for bit) and rows 1 and
22's fused GEMV (M 1-16 / 1-8, every fusion, each cluster split twice bit
for bit and within tolerance of split 1), and the fused W4 decode FFN
(every row count to 17, 64, 100 and 128, every fusion, plans with uneven K
splits, two calls bit for bit), the int8 quantizing write body
(csrc/kv_quant.cuh) through every write entry at head_dim 64 / 128 / 256
with ragged tilings, strided views, pos S - sq, the TRASH overflow, an
all-zero vector and quotients at .5, and the one-query-head int8 decode
kernels over caches holding every byte value; and the kernels at
Mixtral-8x7B's shapes (its separate projections and experts at K 4096 and
14336 on the GEMV and the many-row kernel, flash and the slab writes at 8
KV heads of 128) with a small Mixtral's routed forward, card against CPU;
and at Falcon-40B's and InternLM-7B's (the W4 products at K 32768 and N
32768 / 512 and InternLM's FFN on the GEMV and the many-row kernel, the GQA
decode at R 16, head_dim 64, the one-query-head decode and the slab writes
at 32 heads of 128 with v a view of the fused Wqkv output, flash at 128 /
8 heads) with small models of both families, card against CPU; and at
Falcon-7B's (the static decode entries at R 71 over one KV head, two tiles
of query rows, row 1's tile and row 5 at N 4544 with no weight copied,
flash at 71 / 1 heads, the slab writes of one KV head, one full-width
layer card against CPU); and SPHINX's f32 towers, flash at a SPHINX-7B prefill length (a ragged tail
tile) and small SPHINX models (ens, ens5p2: encode_image, the multimodal
prefill and decode steps at positions shifted by the image words), card
against CPU; and training: remat=True against "full" (the flash output
kept, the W4 products recomputed) and a small Mixtral step with the MoE
loss, card against CPU on the CPU's routing.
Each test carries the ``cuda`` marker, needs a CUDA device and skips without one
(decided inside the fixture). On the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX, which the card's machine
does not have; this file imports only the port.)

Tolerances: kernel and plain version compute the same f32 sums in another
order, so bf16 outputs differ by at most a rounding step or two: 2e-2
relative plus 2e-2 absolute on values of magnitude ~1-4.
"""

import dataclasses

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


@pytest.mark.parametrize("m", [1, 127, 128, 129, 255, 256, 257, 1000, 1024, 1100, 4096])
@pytest.mark.parametrize("k,kx,n,gs", [(256, 256, 128, 128), (2048, 1152, 384, 128),
                                       (512, 512, 256, 64)])
def test_w4_matmul_bigm(gen, m, k, kx, n, gs):
    """Ragged row tiles (around the 256-row tile), x narrower than a padded
    in_dim, group size 64, the QPEFT step's 4096 rows."""
    w = randn(gen, k, n, dtype=torch.float32, scale=k ** -0.5)
    qw = to_folded_layout(quantize_weight(w, 4, gs))
    x = randn(gen, m, kx)
    got = planes_qmm_bigm(x, qw.packed, qw.scales, qw.zeros, in_dim=k, group_size=gs)
    assert_close(got, planes_qmm_bigm_plain(x, qw.packed, qw.scales, qw.zeros, in_dim=k,
                                            group_size=gs))


@pytest.mark.parametrize("m", [1030, 1024, 4100])
def test_w4_matmul_bigm_strided_x(gen, m):
    """x as a column slice of a wider buffer (row stride > Kx); N 192 (a last
    column panel of 64) against the plain version, N 200 refused."""
    qw = _w4(gen, 256, 128)
    x = randn(gen, m, 512)[:, 128:384]
    got = planes_qmm_bigm(x, qw.packed, qw.scales, qw.zeros, in_dim=256, group_size=128)
    assert_close(got, planes_qmm_bigm_plain(x, qw.packed, qw.scales, qw.zeros, in_dim=256,
                                            group_size=128))
    # N a multiple of 64 (a last column panel of 64) is taken; one of 8 is not
    qn = _w4(gen, 256, 192)
    assert_close(planes_qmm_bigm(x, qn.packed, qn.scales, qn.zeros, in_dim=256, group_size=128),
                 planes_qmm_bigm_plain(x, qn.packed, qn.scales, qn.zeros, in_dim=256,
                                       group_size=128))
    with pytest.raises(ValueError, match="multiple of 64"):
        qn = _w4(gen, 256, 200)
        planes_qmm_bigm(x, qn.packed, qn.scales, qn.zeros, in_dim=256, group_size=128)


@pytest.mark.parametrize("m", [1000, 1024, 1100, 4096])
@pytest.mark.parametrize("name,k,kx,n", [("wqkv", 4096, 4096, 12288), ("wo", 4096, 4096, 4096),
                                         ("w13", 4096, 4096, 22016), ("w2", 11264, 11008, 4096)])
def test_w4_matmul_bigm_llama2_7b(gen, m, name, k, kx, n):
    """The 7B prefill's four projections (w2's in_dim 11008 in a weight padded
    to 11264, as quantize_params pads it) at the prefill's and the QPEFT
    step's rows: within a rounding step of the plain version, and the same
    bits from a second launch and from another persistent grid."""
    qw = _w4(gen, kx, n, pad_in_to=k)
    x = randn(gen, m, kx)
    got = planes_qmm_bigm(x, qw.packed, qw.scales, qw.zeros, in_dim=qw.in_dim, group_size=128)
    want = planes_qmm_bigm_plain(x, qw.packed, qw.scales, qw.zeros, in_dim=qw.in_dim,
                                 group_size=128)
    assert_close(got, want)
    for ctas in (None, 37):
        again = planes_qmm_bigm(x, qw.packed, qw.scales, qw.zeros, in_dim=qw.in_dim,
                                group_size=128, ctas=ctas)
        torch.cuda.synchronize()
        assert torch.equal(got, again), ctas


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


@pytest.mark.parametrize("s", [1, 17, 63, 64, 65, 127, 128, 129, 130, 2048, 4096])
@pytest.mark.parametrize("hd,nq,nkv", [(64, 4, 4), (64, 8, 4), (64, 8, 2), (128, 4, 1),
                                       (128, 8, 1), (128, 4, 4)])
def test_flash_attention(gen, s, hd, nq, nkv):
    """Lengths around the 128-row and 128-key tiles and the short ones the
    plan packs (R = 1, 2, 4, 8), v a strided view as the model passes it."""
    b = 2
    q, k = randn(gen, b, s, nq, hd), randn(gen, b, s, nkv, hd)
    v = randn(gen, b, s, 2 * nkv * hd)[..., nkv * hd:].view(b, s, nkv, hd)
    assert_close(flash_attention(q, k, v), grouped_attention(q, k, v, causal=True))


@pytest.mark.parametrize("s", [1, 16, 17, 63, 64, 65, 128, 129, 2048])
@pytest.mark.parametrize("hd,nq,nkv", [(64, 8, 8), (64, 16, 8), (64, 32, 4), (128, 32, 8),
                                       (128, 8, 1)])
def test_flash_attention_lse_and_packing(gen, s, hd, nq, nkv):
    """The forward's lse against the plain log-sum-exp (R = 1, 2, 8, 4, 8),
    from q / k / v as strided views of one projection output; and every
    packing of a group's heads into a block (1 .. R heads) gives fwd_plan's
    bits: a row's arithmetic does not depend on the block that computes it."""
    from accessory_tpu_torch.ops.flash_attention import _forward, attention_lse, fwd_plan

    b = 2
    q, k, v = _attn_inputs(gen, b, s, nq, nkv, hd, fused_qkv=True)
    out, lse = _forward(q, k, v, None, with_lse=True)
    assert_close(out, grouped_attention(q, k, v, causal=True))
    want = attention_lse(q, k)
    torch.cuda.synchronize()
    assert float((lse - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-5
    r = nq // nkv
    for ph in sorted({1, r, fwd_plan(b, s, s, 0, nq, nkv).heads_per_block} | {2, 4} & {
            d for d in range(1, r + 1) if r % d == 0}):
        o2, l2 = _forward(q, k, v, None, with_lse=True, heads_per_block=ph)
        torch.cuda.synchronize()
        assert torch.equal(o2, out) and torch.equal(l2, lse), ph


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
    if isinstance(node, (list, tuple)):
        return type(node)(_to(v, device) for v in node)
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


# ---------------------------------------------------------------- training kernels


def _folded(gen, k, n, gs, pad_scale_rows=0):
    """A folded W4 weight (K, N) with group gs; ``pad_scale_rows`` extra scale /
    zs rows of NaN that the dequant must not read."""
    qw = to_folded_layout(quantize_weight(randn(gen, k, n, dtype=torch.float32), 4, gs))
    if pad_scale_rows:
        nan = torch.full((pad_scale_rows, n), float("nan"), device="cuda")
        qw.scales = torch.cat([qw.scales, nan])
        qw.zeros = torch.cat([qw.zeros, nan])
    return qw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n,gs,pad", [(64, 8, 64, 0), (96, 24, 32, 0), (1088, 40, 64, 3),
                                        (1152, 1000, 128, 0), (4096, 4096, 128, 0),
                                        (11264, 4096, 128, 2)])
def test_w4_dequant_bit_equal(gen, dtype, k, n, gs, pad):
    """planes_dequant == dequantize_weight bit for bit: K not a multiple of the
    64-row tile (96, 1088), N an odd multiple of 8 (8, 24, 40, 1000), padded
    scale rows (NaN, not read), bf16 and f32 output."""
    from accessory_tpu_torch.ops.quant_matmul_bigm import planes_dequant
    from accessory_tpu_torch.quant.qtensor import dequantize_weight

    qw = _folded(gen, k, n, gs, pad)
    got = _one_more("w4_dequant", lambda: planes_dequant(
        qw.packed, qw.scales, qw.zeros, in_dim=k, group_size=gs, dtype=dtype))
    want = dequantize_weight(qw.to("cpu"), dtype)
    assert got.dtype == dtype and torch.equal(got.cpu(), want)


def test_w4_dequant_refuses(gen):
    from accessory_tpu_torch.ops.quant_matmul_bigm import planes_dequant

    qw = _folded(gen, 128, 16, 64)
    with pytest.raises(ValueError, match="multiple of 8"):
        planes_dequant(qw.packed[:, :12].contiguous(), qw.scales[:, :12].contiguous(),
                       qw.zeros[:, :12].contiguous(), in_dim=128, group_size=64)
    with pytest.raises(ValueError, match="dtype"):
        planes_dequant(qw.packed, qw.scales, qw.zeros, in_dim=128, group_size=64,
                       dtype=torch.float16)
    with pytest.raises(ValueError, match="device"):
        planes_dequant(qw.packed, qw.scales.cpu(), qw.zeros, in_dim=128, group_size=64)


def _attn_inputs(gen, b, s, nq, nkv, hd, fused_qkv):
    if fused_qkv:   # strided views of one projection output, as the model makes them
        qkv = randn(gen, b, s, (nq + 2 * nkv) * hd)
        return (qkv[..., :nq * hd].view(b, s, nq, hd),
                qkv[..., nq * hd:(nq + nkv) * hd].view(b, s, nkv, hd),
                qkv[..., (nq + nkv) * hd:].view(b, s, nkv, hd))
    return randn(gen, b, s, nq, hd), randn(gen, b, s, nkv, hd), randn(gen, b, s, nkv, hd)


def assert_grad_close(name, got, want, rel_l2=2e-2):
    """bf16 gradients against the plain f32 formula: elementwise within
    2e-2 of the largest |want| plus 2e-2 relative, and 2e-2 relative L2."""
    torch.cuda.synchronize()
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all(), name
    top = float(w.abs().max())
    bad = (g - w).abs() > 2e-2 * top + 2e-2 * w.abs()
    l2 = float((g - w).norm() / w.norm().clamp_min(1e-30))
    assert not bad.any() and l2 <= rel_l2, (name, int(bad.sum()), l2)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 2048])
@pytest.mark.parametrize("hd,nq,nkv", [(64, 4, 4), (64, 8, 4), (64, 16, 2), (128, 4, 4),
                                       (128, 8, 1)])
def test_flash_attention_bwd(gen, s, hd, nq, nkv):
    """dq, dk, dv of the two backward launches against the plain formula over
    the same forward output and lse (R = 1, 2, 8; a ragged end at 63 / 65;
    dk / dv summed over each group), and the forward's lse against the plain
    log-sum-exp."""
    from accessory_tpu_torch.ops.flash_attention import (_forward, attention_lse,
                                                         flash_attention_bwd,
                                                         flash_attention_bwd_plain)

    b = 2 if s < 2048 else 1
    q, k, v = _attn_inputs(gen, b, s, nq, nkv, hd, fused_qkv=False)
    out, lse = _forward(q, k, v, None, with_lse=True)
    lse_plain = attention_lse(q, k)
    torch.cuda.synchronize()
    assert float((lse - lse_plain).abs().max()) <= 1e-4 * float(lse_plain.abs().max()) + 1e-5
    dout = randn(gen, b, s, nq, hd)
    before = kernels.launch_counts()
    got = flash_attention_bwd(q, k, v, out, dout, lse)
    after = kernels.launch_counts()
    assert after["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 1
    assert after["flash_attention_bwd_dkdv"] == before["flash_attention_bwd_dkdv"] + 1
    want = flash_attention_bwd_plain(q, k, v, out, dout, lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        if s == 1 and name in ("dq", "dk"):
            # one key per query: P = 1 and dS = 0 in exact arithmetic, so dq
            # and dk are rounding noise here (dv = dO)
            assert float(g.abs().max()) <= 1e-2 and float(w.abs().max()) <= 1e-2
        else:
            assert_grad_close(name, g, w)


# R = 1, 2, 8 at head_dim 64 and 128, and R = 6 (a dk / dv cluster of 3 blocks
# at the shorter lengths, whose shares of the 128 key rows are uneven)
BWD_GROUPS = [(64, 8, 8), (64, 8, 4), (64, 32, 4), (128, 8, 8), (128, 16, 8), (128, 16, 2),
              (64, 12, 2)]


@pytest.mark.parametrize("s", [127, 128, 129, 255, 256, 4096])
@pytest.mark.parametrize("hd,nq,nkv", BWD_GROUPS)
def test_flash_attention_bwd_tile_edges(gen, s, hd, nq, nkv):
    """Both backward launches at the edges of their 128-row items and of the
    64 / 128-row stages (one short, exact, one past, two items) and at 4096
    rows, R = 1, 2, 8, against the plain formula over the same forward output
    and lse."""
    from accessory_tpu_torch.ops.flash_attention import (_forward, flash_attention_bwd,
                                                         flash_attention_bwd_plain)

    b = 1 if s == 4096 else 2
    q, k, v = _attn_inputs(gen, b, s, nq, nkv, hd, fused_qkv=False)
    out, lse = _forward(q, k, v, None, with_lse=True)
    dout = randn(gen, b, s, nq, hd)
    got = flash_attention_bwd(q, k, v, out, dout, lse)
    want = flash_attention_bwd_plain(q, k, v, out, dout, lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert_grad_close(name, g, w)


@pytest.mark.parametrize("s,hd,nq,nkv,q0,sk", [(256, 64, 32, 4, None, 256),
                                               (77, 64, 32, 4, None, 77),
                                               (512, 128, 16, 8, None, 512),
                                               (300, 128, 8, 8, None, 300),
                                               (256, 64, 32, 4, 256, 1024),
                                               (256, 128, 16, 8, 768, 1024),
                                               (256, 64, 12, 2, None, 256)])
def test_flash_attention_bwd_two_calls_same_bits(gen, s, hd, nq, nkv, q0, sk):
    """No atomics: two calls of each entry (flash, and cp at a shard) give
    the same bits, the GQA groups split over a cluster (TinyLlama's 32 / 4
    heads) and summed in one block alike."""
    from accessory_tpu_torch.ops.flash_attention import _forward, flash_attention_bwd

    q, dout = randn(gen, 2, s, nq, hd), randn(gen, 2, s, nq, hd)
    k, v = randn(gen, 2, sk, nkv, hd), randn(gen, 2, sk, nkv, hd)
    out, lse = _forward(q, k, v, None, with_lse=True, q_offset=q0)
    first = flash_attention_bwd(q, k, v, out, dout, lse, None, q0)
    second = flash_attention_bwd(q, k, v, out, dout, lse, None, q0)
    torch.cuda.synchronize()
    for g, w in zip(first, second):
        assert torch.equal(g, w)


@pytest.mark.parametrize("s,cp", [(1024, 2), (1024, 4), (512, 4)])
@pytest.mark.parametrize("hd,nq,nkv", [(64, 32, 4), (128, 16, 8), (128, 8, 8)])
def test_flash_attention_cp_bwd_every_shard_past_the_tiles(gen, s, cp, hd, nq, nkv):
    """Every shard of cp 2 / 4 with shards of several 128-row items: dq, dk,
    dv against the plain formula at the shard's offset, the keys past the
    shard's last row exactly zero, and at offset 0 over as many keys as rows
    the flash entries' bits."""
    from accessory_tpu_torch.ops.flash_attention import (_forward, flash_attention_bwd,
                                                         flash_attention_bwd_plain)

    b, s_l = 1, s // cp
    q, k, v, dout = _cp_case(gen, b, s, nq, nkv, hd)
    for r in range(cp):
        rows = slice(r * s_l, (r + 1) * s_l)
        qs, ds = q[:, rows], dout[:, rows].contiguous()
        out, lse = _forward(qs, k, v, None, with_lse=True, q_offset=r * s_l)
        got = flash_attention_bwd(qs, k, v, out, ds, lse, None, r * s_l)
        want = flash_attention_bwd_plain(qs, k, v, out, ds, lse, None, r * s_l)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert_grad_close(f"{name} shard {r}", g, w)
        for g in got[1:]:
            assert not g[:, (r + 1) * s_l:].any()
    qs, ks, vs, ds = q[:, :s_l], k[:, :s_l], v[:, :s_l], dout[:, :s_l].contiguous()
    out, lse = _forward(qs, ks, vs, None, with_lse=True)
    cp_bits = flash_attention_bwd(qs, ks, vs, out, ds, lse, None, 0)
    flash_bits = flash_attention_bwd(qs, ks, vs, out, ds, lse)
    torch.cuda.synchronize()
    for g, w in zip(cp_bits, flash_bits):
        assert torch.equal(g, w)


@pytest.mark.parametrize("s,hd,nq,nkv", [(77, 64, 32, 4), (130, 128, 8, 2)])
def test_flash_attention_bwd_strided_views(gen, s, hd, nq, nkv):
    """q / k / v as strided views of one fused-qkv buffer: the same
    gradients as from contiguous copies."""
    from accessory_tpu_torch.ops.flash_attention import _forward, flash_attention_bwd

    q, k, v = _attn_inputs(gen, 2, s, nq, nkv, hd, fused_qkv=True)
    out, lse = _forward(q, k, v, None, with_lse=True)
    dout = randn(gen, 2, s, nq, hd)
    got = flash_attention_bwd(q, k, v, out, dout, lse)
    want = flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), out, dout, lse)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("s,hd,nq,nkv", [(1, 64, 4, 2), (65, 64, 8, 2), (200, 128, 4, 4)])
def test_flash_attention_autograd_against_f32(gen, s, hd, nq, nkv):
    """The whole differentiable attention in bf16 on the kernels (forward
    with lse, then the backward launches) against autograd through the
    plain grouped attention in f32 on the same (bf16-representable) inputs:
    output and input gradients within 3e-2 relative L2 (bf16 P and dS in the
    kernels' products, bf16 outputs)."""
    q, k, v = _attn_inputs(gen, 2, s, nq, nkv, hd, fused_qkv=False)
    dout = randn(gen, 2, s, nq, hd)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves)
    out.backward(dout)
    ref = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = grouped_attention(*ref, causal=True)
    want.backward(dout.float())
    assert_grad_close("out", out.detach(), want.detach(), rel_l2=3e-2)
    for name, a, r in zip(("dq", "dk", "dv"), leaves, ref):
        if s == 1 and name in ("dq", "dk"):   # 0 in exact arithmetic (one key per query)
            assert float(a.grad.abs().max()) <= 1e-2 and float(r.grad.abs().max()) <= 1e-5
        else:
            assert_grad_close(name, a.grad, r.grad, rel_l2=3e-2)


def test_flash_attention_bwd_refuses(gen):
    from accessory_tpu_torch.ops.flash_attention import _forward, flash_attention_bwd

    q, k, v = _attn_inputs(gen, 1, 64, 4, 2, 64, fused_qkv=False)
    out, lse = _forward(q, k, v, None, with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, out, lse.to(torch.bfloat16))
    q32, k32, v32 = _attn_inputs(gen, 1, 64, 4, 2, 32, fused_qkv=False)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd(q32, k32, v32, q32, q32, lse)


@pytest.mark.parametrize("peft", ["qpeft", "full"])
def test_small_model_train_step_cuda_matches_cpu(gen, peft):
    """One training step of a 2-layer dim-256 model (QPEFT: W4 base with LoRA,
    bias and norm tuning; full: every leaf) on the card and on the CPU from
    the same weights and batch: loss to 1e-2 relative, every trainable
    gradient to 5e-2 relative L2, and the card step launched the dequant
    (QPEFT) and both flash-backward entries."""
    from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from accessory_tpu_torch.train.train_step import grads_of

    kw = dict(lora_rank=8, bias_tuning=True, norm_tuning=True) if peft == "qpeft" else {}
    args = LLaMAArgs(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512,
                     multiple_of=128, max_seq_len=128, dtype="bfloat16", **kw)
    params = llama.init_params(args, seed=5)
    for layer in params["layers"]:       # non-zero lora_b / bias: every gradient moves
        for part in ("attention", "feed_forward"):
            for mod in layer[part].values():
                for name in ("lora_b", "bias"):
                    if name in mod:
                        mod[name] = randn(gen, *mod[name].shape, scale=0.05)
    if peft == "qpeft":
        params = quantize_params(params)
    trainable = llama.get_trainable_params_filter(args)
    from accessory_tpu_torch.train.precision import promote_trainable_params_to_fp32

    params = promote_trainable_params_to_fp32(params, trainable)
    toks = torch.randint(1, 512, (2, 2, 96), generator=torch.Generator().manual_seed(0))
    batch = {"examples": toks[0], "labels": toks[1]}
    res = {}
    for device in ("cpu", "cuda"):     # the CPU copies first: the card run marks its leaves
        p = _to(params, device)
        tx = make_optimizer(p, 1e-3, clip_norm=1.0, trainable=trainable)
        kernels.reset_launch_counts()
        state, m = make_train_step(llama, args, tx, remat="full", device=device)(
            TrainState.create(p, tx), batch)
        res[device] = (float(m["c_loss"]), {k: g.float().cpu() for k, g in
                                            grads_of(state).items()}, kernels.launch_counts())
    (lg, gg, counts), (lc, gc, _) = res["cuda"], res["cpu"]
    assert abs(lg - lc) <= 1e-2 * abs(lc)
    for path in tx.labels:
        if tx.labels[path] != "frozen":
            err = float((gg[path] - gc[path]).norm() / gc[path].norm().clamp_min(1e-30))
            assert err <= 5e-2, (path, err)
    assert counts["flash_attention_bwd_dq"] == 2 and counts["flash_attention_bwd_dkdv"] == 2
    # remat: each layer's forward runs twice (the recompute in the backward)
    assert counts["flash_attention"] == 4
    if peft == "qpeft":
        assert counts["w4_dequant"] == 14 and counts["w4_matmul"] == 28


# ---------------------------------------------------------------- W8, std W4, magic W4


def _w8(gen, k, n, gs=128, pad_in_to=None):
    from accessory_tpu_torch.quant.qtensor import to_w8_layout

    w = randn(gen, k, n, dtype=torch.float32, scale=k ** -0.5)
    return to_w8_layout(quantize_weight(w, 8, gs, pad_in_to=pad_in_to))


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 9, 17, 100, 300, 1024])
@pytest.mark.parametrize("fusion", ["none", "norm+res", "rope_interleaved", "rope_half",
                                    "rope_half128"])
def test_w8_matmul(gen, m, fusion):
    """Every GEMV row template and ragged tiles, each fusion, RoPE at
    head_dim 64 and 128 in both styles; kernel vs plain version."""
    from accessory_tpu_torch.ops.quant_matmul_w8 import w8_qmm, w8_qmm_plain

    k, n = 512, 768
    qw = _w8(gen, k, n)
    kw = {}
    if fusion == "norm+res":
        kw.update(norm_weight=1 + 0.1 * randn(gen, k, dtype=torch.float32),
                  residual=randn(gen, m, n))
    if fusion.startswith("rope"):
        style = fusion.split("_")[1].rstrip("128")
        hd = 128 if fusion.endswith("128") else 64
        cos, sin = precompute_rope(hd, 64, device="cuda")
        cr, sr = rope_rows(cos[13], sin[13], n // hd - 2, 2, hd, style)
        kw.update(rope_cos=cr, rope_sin=sr, rope_style=style, rope_hd=hd)
    args = (randn(gen, m, k), qw.packed, qw.scales, qw.zeros)
    got = w8_qmm(*args, group_size=128, **kw)
    assert_close(got, w8_qmm_plain(*args, group_size=128, **kw))


@pytest.mark.parametrize("m", [1, 8, 64, 1024])
@pytest.mark.parametrize("k,kx,n,gs", [(1152, 1152, 64, 64), (2048, 1152, 264, 128),
                                       (11264, 11008, 256, 128)])
def test_w8_matmul_shapes(gen, m, k, kx, n, gs):
    """Group size 64, x narrower than a padded in_dim (11008 -> 11264), N
    neither a multiple of 64 nor of 128."""
    from accessory_tpu_torch.ops.quant_matmul_w8 import w8_qmm, w8_qmm_plain

    qw = _w8(gen, k, n, gs)
    args = (randn(gen, m, kx), qw.packed, qw.scales, qw.zeros)
    kw = dict(norm_weight=1 + 0.1 * randn(gen, kx, dtype=torch.float32),
              residual=randn(gen, m, n), group_size=gs)
    assert_close(w8_qmm(*args, **kw), w8_qmm_plain(*args, **kw))


def _std_gptq_like(gen, k, n, gs=128):
    """A std-layout W4 weight with GPTQ-style zeros z + 1 in [1, 16]."""
    q = torch.randint(0, 16, (k, n), generator=torch.Generator().manual_seed(k + n))
    z = torch.randint(1, 17, (k // gs, n), generator=torch.Generator().manual_seed(n))
    s = torch.rand((k // gs, n), generator=torch.Generator().manual_seed(k)) * 0.02 + 1e-3
    from accessory_tpu_torch.quant.qtensor import QuantizedWeight, pack_int

    return QuantizedWeight(packed=pack_int(q, 4).cuda(), scales=s.cuda(),
                           zeros=z.to(torch.float32).cuda(), bits=4, group_size=gs,
                           in_dim=k, out_dim=n)


@pytest.mark.parametrize("m", [1, 3, 8, 9, 100, 256, 1030])
@pytest.mark.parametrize("k,kx,n,gs", [(2048, 2048, 2560, 128), (512, 384, 136, 64),
                                       (5632, 5632, 256, 128)])
def test_w4_matmul_std(gen, m, k, kx, n, gs):
    """GPTQ zeros up to 16 (no nibble could hold them), x narrower than
    in_dim, N not a multiple of 128 on a direct call."""
    from accessory_tpu_torch.ops.quant_matmul_pallas import (quant_matmul_pallas,
                                                             quant_matmul_pallas_plain)

    qw = _std_gptq_like(gen, k, n, gs)
    assert float(qw.zeros.max()) == 16.0
    x = randn(gen, m, kx)
    assert_close(quant_matmul_pallas(x, qw), quant_matmul_pallas_plain(x, qw))


@pytest.mark.parametrize("m", [1, 4, 8, 9, 256, 1030])
@pytest.mark.parametrize("k,n,gs", [(2048, 2560, 128), (5632, 256, 128), (512, 128, 64),
                                    (4096, 512, 128)])
def test_w4_matmul_magic(gen, m, k, n, gs):
    """The magic words as stored (tiles of 2048, 512 and 256 rows), GPTQ
    zeros up to 16; the kernel's bf16 weight arithmetic against the plain
    version's."""
    from accessory_tpu_torch.ops.quant_matmul_magic import magic_qmm, magic_qmm_plain
    from accessory_tpu_torch.quant.qtensor import to_magic_layout

    qw = to_magic_layout(_std_gptq_like(gen, k, n, gs))
    x = randn(gen, m, k)
    kw = dict(group_size=gs, tk=qw.tile_k)
    assert_close(magic_qmm(x, qw.packed, qw.scales, qw.zeros, **kw),
                 magic_qmm_plain(x, qw.packed, qw.scales, qw.zeros, **kw))


def test_new_quant_wrappers_refuse(gen):
    """Each new wrapper raises on what its kernel does not take, and never
    falls back to its plain version on a CUDA tensor."""
    from accessory_tpu_torch.ops.quant_matmul_magic import magic_qmm
    from accessory_tpu_torch.ops.quant_matmul_pallas import quant_matmul_pallas
    from accessory_tpu_torch.ops.quant_matmul_w8 import w8_qmm
    from accessory_tpu_torch.quant.qtensor import to_magic_layout

    qw8 = _w8(gen, 256, 256)
    with pytest.raises(ValueError, match="bf16"):
        w8_qmm(randn(gen, 4, 256, dtype=torch.float32), qw8.packed, qw8.scales, qw8.zeros,
               group_size=128)
    with pytest.raises(ValueError, match="group_size"):
        w8_qmm(randn(gen, 4, 256), qw8.packed, qw8.scales, qw8.zeros, group_size=32)
    std = _std_gptq_like(gen, 512, 256)
    with pytest.raises(ValueError, match="in_dim"):
        quant_matmul_pallas(randn(gen, 4, 96), std)
    mq = to_magic_layout(std)
    with pytest.raises(ValueError, match="tile"):
        magic_qmm(randn(gen, 4, 512), mq.packed, mq.scales, mq.zeros, group_size=128, tk=256)
    before = kernels.launch_counts()
    magic_qmm(randn(gen, 4, 512), mq.packed, mq.scales, mq.zeros, group_size=128, tk=mq.tile_k)
    assert kernels.launch_counts()["w4_matmul_magic"] == before["w4_matmul_magic"] + 1


@pytest.mark.parametrize("route", ["w8", "gptq", "magic", "w3"])
def test_small_model_new_formats_cuda_match_cpu(gen, route):
    """A 2-layer dim-512 model in each new weight format: prefill (96 rows:
    the many-row tiles) and decode logits, card vs CPU, and the route's
    launches."""
    from accessory_tpu_torch.quant.qtensor import QuantizedWeight, to_magic_layout

    args = LLaMAArgs(dim=512, n_layers=2, n_heads=8, n_kv_heads=2, vocab_size=512,
                     multiple_of=256, max_seq_len=128)
    params = llama.init_params(args, seed=3)
    if route in ("w8", "w3"):
        params = quantize_params(params, bits=8 if route == "w8" else 3)
    else:
        for layer in params["layers"]:
            for part in ("attention", "feed_forward"):
                for mod in layer[part].values():
                    w = mod["weight"]
                    qw = _std_gptq_like(gen, w.shape[0], w.shape[1])
                    mod["weight"] = to_magic_layout(qw) if route == "magic" else qw
    params = fuse_for_decode(params)
    cpu = _to(params, "cpu")
    toks = torch.randint(0, 512, (3, 36), generator=torch.Generator().manual_seed(0))
    cg, cc = llama.init_kv_cache(args, 3, 64), llama.init_kv_cache(args, 3, 64, device="cpu")
    kernels.reset_launch_counts()
    lg, _ = llama.forward(params, args, toks[:, :32].cuda(), cache=cg, cur_pos=0)
    lc, _ = llama.forward(cpu, args, toks[:, :32], cache=cc, cur_pos=0)
    pairs = [(lg, lc)]
    for p in range(32, 36):
        lg, _ = llama.forward(params, args, toks[:, p:p + 1].cuda(), cache=cg, cur_pos=p)
        lc, _ = llama.forward(cpu, args, toks[:, p:p + 1], cache=cc, cur_pos=p)
        pairs.append((lg, lc))
    counts = kernels.launch_counts()
    entry = {"w8": "w8_matmul", "gptq": "w4_matmul_std", "magic": "w4_matmul_magic"}.get(route)
    assert counts["w4_matmul"] == 0 and counts["w4_matmul_bigm"] == 0
    if entry:
        assert counts[entry] == 4 * 2 * 5
    assert isinstance(params["layers"][0]["attention"]["wqkv"]["weight"], QuantizedWeight)
    for g, c in pairs:
        g = g.cpu()
        assert float((g - c).norm() / c.norm()) < 2e-2
        assert float((g - c).abs().max()) < 2e-2 * float(c.abs().max()) + 2e-2


# ---------------------------------------------------------------- fused W4 FFN


def _ffn_weights(gen, k, ffn, n2, gs=128):
    """[W1|W3] (k, 2 ffn) and W2 (ffn, n2), folded W4, w2's in_dim padded by
    the quantizer's rule (quant.quantize.pad_to), as quantize_params pads it."""
    from accessory_tpu_torch.quant.quantize import pad_to

    w1, w3 = _w4(gen, k, ffn, pad_in_to=pad_to(k, gs)), _w4(gen, k, ffn, pad_in_to=pad_to(k, gs))
    w13 = fuse_for_decode({"layers": [{"attention": {}, "feed_forward": {
        "w1": {"weight": w1}, "w3": {"weight": w3}}}]})["layers"][0]["feed_forward"]["w13"]
    return w13["weight"], _w4(gen, ffn, n2, pad_in_to=pad_to(ffn, gs))


@pytest.mark.parametrize("m", list(range(1, 18)) + [64, 100, 128])
@pytest.mark.parametrize("fusion", ["none", "norm", "res", "norm+res"])
@pytest.mark.parametrize("k,ffn,n2", [(512, 1408, 512), (2048, 5632, 2048)])
def test_ffn_fused(gen, m, fusion, k, ffn, n2):
    """ffn_qmm (one cooperative launch) against its plain version at every
    row count to 17 (each row template and ragged row passes) and 64, 100,
    128, a w2 padded by the quantizer (1408 -> 2048, 5632 -> 6144), with and
    without the norm and residual; a second call gives the same bits."""
    from accessory_tpu_torch.ops.ffn_fused import ffn_qmm, ffn_qmm_plain

    w13, w2 = _ffn_weights(gen, k, ffn, n2)
    x = randn(gen, m, k)
    kw = dict(norm_weight=(1 + 0.1 * randn(gen, k, dtype=torch.float32)) if "norm" in fusion
              else None, residual=randn(gen, m, n2) if "res" in fusion else None)
    before = kernels.launch_counts()["ffn_fused"]
    got = ffn_qmm(x, w13, w2, **kw)
    assert kernels.launch_counts()["ffn_fused"] == before + 1
    assert torch.equal(got, ffn_qmm(x, w13, w2, **kw))
    assert_close(got, ffn_qmm_plain(x, w13, w2, **kw))


@pytest.mark.parametrize("splits", [(1, 1), (3, 5), (7, 13), (8, 22)])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 128])
def test_ffn_fused_splits(gen, monkeypatch, m, splits):
    """Plans the default does not pick: K splits that divide neither phase's
    units evenly (8 units of w13, 22 of w2), no split and one unit a rank;
    each against the plain version with the norm and residual, two calls
    bit-equal."""
    from accessory_tpu_torch.ops import ffn_fused

    k, ffn, n2 = 512, 1408, 512
    plan = ffn_fused.ffn_plan
    monkeypatch.setattr(ffn_fused, "ffn_plan",
                        lambda *a: plan(*a, split_a=splits[0], split_b=splits[1]))
    w13, w2 = _ffn_weights(gen, k, ffn, n2)
    x = randn(gen, m, k)
    kw = dict(norm_weight=1 + 0.1 * randn(gen, k, dtype=torch.float32),
              residual=randn(gen, m, n2))
    got = ffn_fused.ffn_qmm(x, w13, w2, **kw)
    assert torch.equal(got, ffn_fused.ffn_qmm(x, w13, w2, **kw))
    assert_close(got, ffn_fused.ffn_qmm_plain(x, w13, w2, **kw))


def test_ffn_fused_refuses(gen):
    """No fallback: 129 rows, a std or a magic w2, a group-size mismatch and
    an f32 x raise on the card."""
    from accessory_tpu_torch.ops.ffn_fused import ffn_qmm
    from accessory_tpu_torch.quant.qtensor import to_magic_layout

    w13, w2 = _ffn_weights(gen, 512, 1024, 512)
    with pytest.raises(ValueError, match="128 rows"):
        ffn_qmm(randn(gen, 129, 512), w13, w2)
    std = quantize_weight(randn(gen, 1024, 512, dtype=torch.float32), 4, 128)
    for other in (std, to_magic_layout(std)):
        with pytest.raises(ValueError, match="folded"):
            ffn_qmm(randn(gen, 8, 512), w13, other)
    with pytest.raises(ValueError, match="group sizes"):
        ffn_qmm(randn(gen, 8, 512), w13,
                to_folded_layout(quantize_weight(randn(gen, 1024, 512, dtype=torch.float32), 4,
                                                 64)))
    with pytest.raises(ValueError, match="bf16"):
        ffn_qmm(randn(gen, 8, 512, dtype=torch.float32), w13, w2)


@pytest.mark.parametrize("b", [1, 8])
def test_small_model_decode_with_ffn_fuse(gen, b):
    """A 2-layer TinyLlama-width model: with ffn_fuse each decode step takes
    2 w4_matmul (wqkv, wo) and 1 ffn_fused a layer, the prefill none of the
    fused FFN; logits against the unfused route on the card (2% relative L2)
    and against the CPU's fused route (its plain version)."""
    args = LLaMAArgs(dim=2048, n_layers=2, n_heads=32, n_kv_heads=4, vocab_size=512,
                     multiple_of=256, max_seq_len=128)
    params = fuse_for_decode(quantize_params(llama.init_params(args, seed=5)))
    cpu = _to(params, "cpu")
    toks = torch.randint(0, 512, (b, 36), generator=torch.Generator().manual_seed(1))
    out = {}
    for fuse in (True, False):
        cache = llama.init_kv_cache(args, b, 64)
        llama.forward(params, args, toks[:, :32].cuda(), cache=cache, cur_pos=0, ffn_fuse=fuse)
        kernels.reset_launch_counts()
        out[fuse] = [llama.forward(params, args, toks[:, p:p + 1].cuda(), cache=cache,
                                   cur_pos=p, ffn_fuse=fuse)[0].cpu() for p in range(32, 36)]
        counts = kernels.launch_counts()
        assert counts["w4_matmul"] == (2 if fuse else 4) * 2 * 4
        assert counts["ffn_fused"] == (2 * 4 if fuse else 0)
    cc = llama.init_kv_cache(args, b, 64, device="cpu")
    llama.forward(cpu, args, toks[:, :32], cache=cc, cur_pos=0, ffn_fuse=True)
    for i, p in enumerate(range(32, 36)):
        lc, _ = llama.forward(cpu, args, toks[:, p:p + 1], cache=cc, cur_pos=p, ffn_fuse=True)
        for g, c in ((out[True][i], out[False][i]), (out[True][i], lc)):
            assert float((g - c).norm() / c.norm()) < 2e-2
            assert float((g - c).abs().max()) < 2e-2 * float(c.abs().max()) + 2e-2


# ---------------------------------------------------------------- read-only paged decode


@pytest.mark.parametrize("hd,r", [(64, 8), (64, 1), (128, 1), (128, 4)])
@pytest.mark.parametrize("ps", [16, 64])
def test_paged_decode_ro(gen, hd, r, ps):
    """paged_attention_decode (the read-only kernel) against the oracle:
    lengths 1, ps - 1, ps, ps + 1, a whole table and a zero-length slot
    (zeros); a shared page and a shuffled table; the pools are not written.
    Also the paged decode with the token as its new one over the old length
    after the token's paged write."""
    from accessory_tpu_torch.engine import kvcache
    from accessory_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                                      paged_decode_ro_plain)

    nkv, pps = 2, 6
    lengths = [1, ps - 1, ps, ps + 1, (pps - 1) * ps, 0]
    b = len(lengths)
    pools, table, lens = _paged_case(gen, b, nkv, hd, ps, pps, b * pps + 3, False, lengths)
    kp, vp = pools[0][0], pools[1][0]
    keep = (kp.clone(), vp.clone())
    q = randn(gen, b, nkv * r, hd)
    before = kernels.launch_counts()["paged_decode_ro"]
    got = kvcache.paged_attention_decode(q, kp, vp, lens, table)
    assert kernels.launch_counts()["paged_decode_ro"] == before + 1
    assert torch.equal(kp, keep[0]) and torch.equal(vp, keep[1])
    assert_close(got[:-1], paged_decode_ro_plain(q, kp, vp, lens, table)[:-1])
    assert float(got[-1].abs().max()) == 0.0
    # the same token through the write + the paged decode that takes it as
    # new (a table of pages of each slot's own: the writes must not collide)
    own = torch.arange(1, b * pps + 1, dtype=torch.int32, device="cuda").reshape(b, pps)
    old = (lens - 1).clamp_min(0)
    kn, vn = randn(gen, b, 1, nkv, hd), randn(gen, b, 1, nkv, hd)
    want = paged_decode_attention(q[:, None], kn, vn, kp, vp, old, own)[:, 0]
    kvcache.write_tokens(kp, vp, kn, vn, own, old)
    got = kvcache.paged_attention_decode(q, kp, vp, old + 1, own)
    assert_close(got, want)


def test_paged_decode_ro_refuses(gen):
    from accessory_tpu_torch.engine import kvcache

    pools, table, lens = _paged_case(gen, 2, 2, 64, 16, 4, 12, False, [3, 5])
    q = randn(gen, 2, 4, 64)
    with pytest.raises(ValueError):
        kvcache.paged_attention_decode(q.float(), pools[0][0], pools[1][0], lens, table)
    with pytest.raises(ValueError):
        kvcache.paged_attention_decode(q, pools[0][0], pools[1][0], lens.long(), table)
    with pytest.raises(ValueError):
        kvcache.paged_attention_decode(q, pools[0][0].float(), pools[1][0].float(), lens, table)


# ---------------------------------------------------------------- split decode (decode_split.cuh)


def _split_lengths(plan, n_max, k=8):
    """0, 1, then k - 2 lengths spread over each rank's first token (and the
    one after it) when n_max tokens are cached, and n_max itself."""
    firsts = [plan.rank_range(n_max, rk)[0] for rk in range(1, plan.split)]
    rest = sorted({n_max} | set(firsts) | {f + 1 for f in firsts})
    return [0, 1] + [rest[round(i * (len(rest) - 1) / (k - 3))] for i in range(k - 2)]


# (64, 71, 1): Falcon-7B's group, a tile of 64 query rows and one of 7; (64,
# 128, 1) two whole tiles; (128, 40, 2) tiles of 32 and 8 at head_dim 128
STATIC_SPLIT_CASES = [(hd, r, nkv, write, pos)
                      for hd, r, nkv in ((64, 8, 4), (128, 4, 8), (64, 32, 2), (64, 71, 1),
                                         (64, 128, 1), (128, 40, 2))
                      for write in (True, False)
                      for pos in (0, 1, 63, 64, 65, 255, 256, 257, 511, 512, 767, 768, 1023, 1024)
                      if not (write and pos == 1024)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hd,r,nkv,write,pos", STATIC_SPLIT_CASES)
def test_decode_split_rank_edges(gen, int8, hd, r, nkv, write, pos):
    """The split GQA kernel at B 8, S 1024 (decode_plan's split > 1): a pos
    that leaves ranks empty (0, 1), a chunk edge, each rank's first token at
    a full cache, a full cache (read-only); R past one tile of query rows
    (71, 128; 40 at head_dim 128); against the plain version, the fused
    write bit-equal to the plain write (int8: the scales to f32 rounding),
    and the same output bits on two calls."""
    from accessory_tpu_torch.ops.decode_attention import decode_plan

    b, s_len = 8, 1024
    assert decode_plan(b, nkv, s_len, r, hd).split > 1
    q, kn, vn = _qkv(gen, b, nkv * r, nkv, hd)
    pools = _int8_pools(gen, b, nkv, s_len, hd) if int8 else (randn(gen, b, nkv, s_len, hd),
                                                              randn(gen, b, nkv, s_len, hd))
    keep = tuple(p.clone() for p in pools)
    name = "decode_attention" + ("8" if int8 else "") + ("" if write else "_ro")
    if write:
        fn = decode_attention_update8 if int8 else decode_attention_update
        plain = decode_attention_update8_plain if int8 else decode_attention_update_plain
        got = _one_more(name, lambda: fn(q, kn, vn, *pools, pos))
        want = plain(q, kn, vn, *(p.clone() for p in keep), pos)
        assert_close(got[0], want[0])
        if int8:
            assert_pools8(got[1:], want[1:])
        else:
            assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        again = fn(q, kn, vn, *(p.clone() for p in keep), pos)[0]
        out = got[0]
    else:
        fn = cached_attention_t8 if int8 else cached_attention_t
        plain = cached_attention_decode8_plain if int8 else cached_attention_decode_plain
        out = _one_more(name, lambda: fn(q, kn, vn, *pools, pos))
        assert_close(out, plain(q, kn, vn, *keep, pos))
        assert all(torch.equal(a, b_) for a, b_ in zip(pools, keep))
        again = fn(q, kn, vn, *pools, pos)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("ps", [16, 64, 128])
@pytest.mark.parametrize("sq,r,hd", [(1, 8, 64), (5, 8, 64), (1, 1, 128), (5, 4, 128)])
def test_paged_split_rank_edges(gen, int8, ps, sq, r, hd):
    """The split paged kernel over 512 tokens of pages (paged_plan's split):
    lengths 0, 1, each rank's first token and J * PS, a TRASH page read by
    the full slot, pages of 16 (four to a chunk) and 128 (two chunks to a
    page), sq 5 new tokens causal among themselves; against the plain version,
    the pools untouched, the same bits on two calls."""
    from accessory_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                                      paged_decode_attention_plain, paged_plan)

    b, nkv, pps = 8, 4, 512 // ps
    plan = paged_plan(b, nkv, sq * r, hd, pps, ps)
    assert plan.split > 1
    lengths = _split_lengths(plan, pps * ps, b)
    pools, table, lens = _paged_case(gen, b, nkv, hd, ps, pps, b * pps + 3, int8, lengths)
    keep = [p.clone() for p in pools if p is not None]
    q = randn(gen, b, sq, nkv * r, hd)
    kn, vn = randn(gen, b, sq, nkv, hd), randn(gen, b, sq, nkv, hd)
    name = "paged_decode8" if int8 else "paged_decode"
    got = _one_more(name, lambda: paged_decode_attention(q, kn, vn, pools[0], pools[1], lens,
                                                         table, None, pools[2], pools[3],
                                                         layer=0))
    want = paged_decode_attention_plain(q, kn, vn, pools[0], pools[1], lens, table, None,
                                        pools[2], pools[3], layer=0)
    assert_close(got, want)
    assert all(torch.equal(a, b_) for a, b_ in zip([p for p in pools if p is not None], keep))
    again = paged_decode_attention(q, kn, vn, pools[0], pools[1], lens, table, None, pools[2],
                                   pools[3], layer=0)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.parametrize("ps", [16, 64, 128])
@pytest.mark.parametrize("hd,r", [(64, 8), (128, 1)])
def test_paged_ro_split_rank_edges(gen, ps, hd, r):
    """The read-only paged kernel over 1024 tokens of pages: a length-0 slot
    (zeros), 1, each rank's first token, J * PS; against the oracle, the same
    bits on two calls."""
    from accessory_tpu_torch.ops.paged_decode import (paged_decode_ro, paged_decode_ro_plain,
                                                      paged_plan)

    b, nkv, pps = 8, 4, 1024 // ps
    plan = paged_plan(b, nkv, r, hd, pps, ps)
    assert plan.split > 1
    lengths = _split_lengths(plan, pps * ps, b)
    assert lengths[0] == 0
    pools, table, lens = _paged_case(gen, b, nkv, hd, ps, pps, b * pps + 3, False, lengths)
    kp, vp = pools[0][0], pools[1][0]
    q = randn(gen, b, nkv * r, hd)
    got = _one_more("paged_decode_ro", lambda: paged_decode_ro(q, kp, vp, lens, table))
    assert_close(got[1:], paged_decode_ro_plain(q, kp, vp, lens, table)[1:])
    torch.cuda.synchronize()
    assert float(got[0].abs().max()) == 0.0
    assert torch.equal(got, paged_decode_ro(q, kp, vp, lens, table))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("pos", [1, 64, 300, 511, 1000, 1024])
def test_paged_identity_table_at_the_split_plans(gen, int8, pos):
    """Over an identity page table of 1024 tokens a slot the split paged
    kernel (8 ranks) computes what the split static read-only kernel (4
    ranks) computes on the same contents."""
    from accessory_tpu_torch.ops.decode_attention import decode_plan
    from accessory_tpu_torch.ops.paged_decode import paged_decode_attention, paged_plan

    b, nkv, r, hd, ps, pps = 8, 4, 8, 64, 64, 16
    s_len = ps * pps
    assert paged_plan(b, nkv, r, hd, pps, ps).split != decode_plan(b, nkv, s_len, r, hd).split
    pools = _int8_pools_static(gen, b, nkv, s_len, hd) if int8 else \
        (randn(gen, b, nkv, s_len, hd), randn(gen, b, nkv, s_len, hd))
    q, kn, vn = randn(gen, b, 1, nkv * r, hd), randn(gen, b, 1, nkv, hd), randn(gen, b, 1, nkv, hd)
    want = (cached_attention_t8 if int8 else cached_attention_t)(q, kn, vn, *pools, pos)
    paged = [p.reshape(b, nkv, pps, ps, *p.shape[3:]).transpose(0, 1)
             .reshape(nkv, b * pps, ps, *p.shape[3:]).contiguous() for p in pools]
    table = torch.arange(b * pps, dtype=torch.int32, device="cuda").reshape(b, pps)
    lens = torch.full((b,), pos, dtype=torch.int32, device="cuda")
    got = paged_decode_attention(q, kn, vn, paged[0], paged[1], lens, table, None,
                                 *(paged[2:] if int8 else (None, None)))
    assert_close(got, want)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("write", [False, True])
def test_decode_split_unaligned_rows(gen, int8, write):
    """q, k_new and v_new whose rows do not start on 16-byte boundaries (views
    one element into a buffer): the kernel reads them element by element."""
    b, nq, nkv, hd, s_len, pos = 4, 32, 4, 64, 512, 300
    buf = randn(gen, b, 1, (nq + 2 * nkv) * hd + 1)
    q = buf[..., 1:nq * hd + 1].view(b, 1, nq, hd)
    kn = buf[..., nq * hd + 1:(nq + nkv) * hd + 1].view(b, 1, nkv, hd)
    vn = buf[..., (nq + nkv) * hd + 1:].view(b, 1, nkv, hd)
    assert q.data_ptr() % 16 != 0
    pools = _int8_pools(gen, b, nkv, s_len, hd) if int8 else (randn(gen, b, nkv, s_len, hd),
                                                              randn(gen, b, nkv, s_len, hd))
    keep = tuple(p.clone() for p in pools)
    if write:
        got = (decode_attention_update8 if int8 else decode_attention_update)(q, kn, vn, *pools,
                                                                             pos)
        want = (decode_attention_update8_plain if int8 else decode_attention_update_plain)(
            q, kn, vn, *keep, pos)
        assert_close(got[0], want[0])
        if int8:
            assert_pools8(got[1:], want[1:])
        else:
            assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    else:
        got = (cached_attention_t8 if int8 else cached_attention_t)(q, kn, vn, *pools, pos)
        assert_close(got, (cached_attention_decode8_plain if int8 else
                           cached_attention_decode_plain)(q, kn, vn, *keep, pos))


@pytest.mark.parametrize("int8", [False, True])
def test_paged_split_past_the_shared_memory_caches(gen, int8):
    """Twenty new tokens a slot (the first 16 k / v in shared memory, the
    rest read from global memory), 300 one-token pages a slot (past the 256
    page ids held in shared memory: each read from the table), three tiles of
    query rows; unaligned q rows."""
    from accessory_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                                      paged_decode_attention_plain)

    b, nkv, r, hd, ps, pps, sq = 2, 2, 8, 64, 1, 300, 20
    lengths = [0, 290]
    pools, table, lens = _paged_case(gen, b, nkv, hd, ps, pps, b * pps + 3, int8, lengths)
    buf = randn(gen, b, sq, nkv * r * hd + 1)
    q = buf[..., 1:].view(b, sq, nkv * r, hd)
    kn, vn = randn(gen, b, sq, nkv, hd), randn(gen, b, sq, nkv, hd)
    got = paged_decode_attention(q, kn, vn, pools[0], pools[1], lens, table, None, pools[2],
                                 pools[3], layer=0)
    want = paged_decode_attention_plain(q, kn, vn, pools[0], pools[1], lens, table, None,
                                        pools[2], pools[3], layer=0)
    assert_close(got, want)


# ---------------------------------------------------------------- context parallel (row 26)


def _cp_case(gen, b, s, nq, nkv, hd):
    q, k, v = _attn_inputs(gen, b, s, nq, nkv, hd, fused_qkv=False)
    return q, k, v, randn(gen, b, s, nq, hd)


@pytest.mark.parametrize("s,cp", [(256, 4), (200, 2), (130, 5)])
@pytest.mark.parametrize("hd,nq,nkv", [(64, 4, 4), (64, 8, 4), (64, 16, 4), (128, 8, 1),
                                       (128, 4, 4)])
def test_flash_attention_cp_every_shard(gen, s, cp, hd, nq, nkv):
    """Each shard's forward (output, lse) and backward (dq, dk / dv over every
    gathered key) against the plain versions at its query offset (R = 1, 2,
    4, 8; shards of 64, 100 and 26 rows: aligned and ragged tiles); keys past
    the shard's last row get exact zeros."""
    from accessory_tpu_torch.ops.flash_attention import (_forward, attention_lse,
                                                         flash_attention_bwd,
                                                         flash_attention_bwd_plain)

    b, s_l = 2, s // cp
    q, k, v, dout = _cp_case(gen, b, s, nq, nkv, hd)
    for r in range(cp):
        rows = slice(r * s_l, (r + 1) * s_l)
        qs, ds = q[:, rows], dout[:, rows].contiguous()
        before = kernels.launch_counts()
        out, lse = _forward(qs, k, v, None, with_lse=True, q_offset=r * s_l)
        assert_close(out, grouped_attention(qs, k, v, causal=True, q_offset=r * s_l))
        lse_plain = attention_lse(qs, k, None, r * s_l)
        torch.cuda.synchronize()
        assert float((lse - lse_plain).abs().max()) <= 1e-4 * float(lse_plain.abs().max()) + 1e-5
        got = flash_attention_bwd(qs, k, v, out, ds, lse, None, r * s_l)
        after = kernels.launch_counts()
        for name in ("flash_attention_cp", "flash_attention_cp_bwd_dq",
                     "flash_attention_cp_bwd_dkdv"):
            assert after[name] == before[name] + 1, name
        want = flash_attention_bwd_plain(qs, k, v, out, ds, lse, None, r * s_l)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.shape == w.shape and g.dtype == torch.bfloat16
            assert_grad_close(f"{name} shard {r}", g, w)
        for g in got[1:]:
            assert not g[:, (r + 1) * s_l:].any()


@pytest.mark.parametrize("s,hd,nq,nkv", [(1, 64, 4, 2), (77, 64, 32, 4), (130, 128, 8, 8),
                                         (512, 128, 32, 32), (63, 64, 8, 1), (64, 64, 8, 4),
                                         (65, 128, 16, 2), (127, 64, 32, 4), (128, 64, 8, 4),
                                         (129, 128, 8, 1), (2048, 128, 8, 8), (4096, 64, 8, 2)])
def test_flash_attention_cp_at_offset_zero_is_the_flash_kernel(gen, s, hd, nq, nkv):
    """q0 = 0 and SK = SQ: the cp entries give the flash entries' bits (one
    body), forward with the lse and both backward launches."""
    from accessory_tpu_torch.ops.flash_attention import _forward, flash_attention_bwd

    q, k, v, dout = _cp_case(gen, 2, s, nq, nkv, hd)
    want = _forward(q, k, v, None, with_lse=True)
    got = _forward(q, k, v, None, with_lse=True, q_offset=0)
    gb = flash_attention_bwd(q, k, v, got[0], dout, got[1], None, 0)
    wb = flash_attention_bwd(q, k, v, want[0], dout, want[1])
    torch.cuda.synchronize()
    for g, w in zip(got + gb, want + wb):
        assert torch.equal(g, w)


@pytest.mark.parametrize("b", [1, 3])
def test_flash_attention_cp_token_major_gathered_kv(gen, b):
    """k / v as the strided (b, S, nkv, hd) view of a token-major gather
    buffer (S, b, nkv, hd), as parallel.cp_attention hands them over: the
    same bits as from contiguous copies."""
    from accessory_tpu_torch.ops.flash_attention import _forward, flash_attention_bwd

    s, nq, nkv, hd, cp = 256, 8, 2, 128, 4
    kt, vt = randn(gen, s, b, nkv, hd), randn(gen, s, b, nkv, hd)
    k, v = kt.transpose(0, 1), vt.transpose(0, 1)
    q, dout = randn(gen, b, s // cp, nq, hd), randn(gen, b, s // cp, nq, hd)
    for off in (0, 64, 192):
        runs = []
        for kk, vv in ((k, v), (k.contiguous(), v.contiguous())):
            out, lse = _forward(q, kk, vv, None, with_lse=True, q_offset=off)
            runs.append((out, lse) + flash_attention_bwd(q, kk, vv, out, dout, lse, None, off))
        torch.cuda.synchronize()
        for g, w in zip(*runs):
            assert torch.equal(g, w)


def test_cp_shards_sum_to_the_unsharded_kernel(gen):
    """Four shards through parallel.cp_shard_attention (the gather a cat, the
    reduce-scatter a sum over shards): outputs and dq the unsharded kernel's
    bits (the shards' tiles are the unsharded kernel's), dk / dv within a
    rounding step of it (a sum of four bf16 parts)."""
    from accessory_tpu_torch.ops.flash_attention import _forward, flash_attention_bwd
    from accessory_tpu_torch.parallel.context import cp_shard_attention

    b, s, nq, nkv, hd, cp = 1, 512, 8, 2, 64, 4
    q, k, v, dout = _cp_case(gen, b, s, nq, nkv, hd)
    out, lse = _forward(q, k, v, None, with_lse=True)
    want = flash_attention_bwd(q, k, v, out, dout, lse)
    s_l = s // cp
    outs, dqs = [], []
    dk = torch.zeros(k.shape, dtype=torch.float32, device="cuda")
    dv = torch.zeros_like(dk)
    for r in range(cp):
        leaves = [q[:, r * s_l:(r + 1) * s_l].detach().clone().requires_grad_(True),
                  k.detach().clone().requires_grad_(True), v.detach().clone().requires_grad_(True)]
        o = cp_shard_attention(*leaves, r)
        o.backward(dout[:, r * s_l:(r + 1) * s_l])
        outs.append(o.detach())
        dqs.append(leaves[0].grad)
        dk += leaves[1].grad.float()
        dv += leaves[2].grad.float()
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, 1), out)
    assert torch.equal(torch.cat(dqs, 1), want[0])
    assert_grad_close("dk", dk, want[1].float())
    assert_grad_close("dv", dv, want[2].float())


@pytest.mark.parametrize("s,cp,hd,nq,nkv", [(130, 2, 64, 8, 2), (256, 4, 128, 4, 4)])
def test_flash_attention_cp_autograd_against_f32(gen, s, cp, hd, nq, nkv):
    """flash_attention_cp differentiated on the kernels (bf16) at each shard
    against autograd through the plain grouped attention in f32 with the same
    offset: output and input gradients within 3e-2 relative L2."""
    from accessory_tpu_torch.ops.flash_attention import flash_attention_cp

    q, k, v, dout = _cp_case(gen, 2, s, nq, nkv, hd)
    s_l = s // cp
    for r in range(cp):
        rows = slice(r * s_l, (r + 1) * s_l)
        leaves = [q[:, rows].detach().clone().requires_grad_(True),
                  k.detach().clone().requires_grad_(True), v.detach().clone().requires_grad_(True)]
        out = flash_attention_cp(*leaves, r * s_l)
        out.backward(dout[:, rows])
        ref = [t.detach().float().requires_grad_(True) for t in (q[:, rows], k, v)]
        want = grouped_attention(*ref, causal=True, q_offset=r * s_l)
        want.backward(dout[:, rows].float())
        assert_grad_close("out", out.detach(), want.detach(), rel_l2=3e-2)
        for name, a, w in zip(("dq", "dk", "dv"), leaves, ref):
            assert_grad_close(f"{name} shard {r}", a.grad[:, :(r + 1) * s_l],
                              w.grad[:, :(r + 1) * s_l], rel_l2=3e-2)


def test_flash_attention_cp_refuses(gen):
    from accessory_tpu_torch.ops.flash_attention import (_forward, flash_attention_bwd,
                                                         flash_attention_cp)

    q, k, v, _ = _cp_case(gen, 1, 128, 4, 2, 64)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_cp(q[:, :64], k, v, 96)
    out, lse = _forward(q[:, :64], k, v, None, with_lse=True, q_offset=64)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q[:, :64], k, v, out, out, lse.to(torch.bfloat16), None, 64)
    q32, k32, v32, _ = _cp_case(gen, 1, 128, 4, 2, 32)
    with pytest.raises(ValueError, match="head_dim 32"):
        flash_attention_cp(q32[:, :64], k32, v32, 64)


# -- the many-row W4 tile (csrc/w4_tile.cuh): row 1's fused tile and the std /
#    magic tile, at ragged row counts around the 64- and 128-row tiles, the
#    TinyLlama widths, a padded in_dim, strided x, every fusion, and the K
#    split of ops/w4_tile.py (bit-equal across launches, and within the rows'
#    tolerance of the unsplit plan)

_TILE_MS = [17, 63, 64, 65, 127, 129, 511, 1000, 1023]
_TILE_KN = [(2048, 256), (2048, 2048), (2048, 2560), (5632, 256), (5632, 2048), (5632, 2560)]


def _tile_case(gen, m, k, n, fusion="none", strided=False, hd=64):
    """planes_qmm's arguments: W4 g128 with in_dim padded as quantize_params
    pads it (5632 -> 6144), x optionally a strided view of a wider tensor."""
    from accessory_tpu_torch.quant.quantize import pad_to

    qw = _w4(gen, k, n, pad_in_to=pad_to(k, 128))
    x = randn(gen, m, k + 64)[:, :k] if strided else randn(gen, m, k)
    kw = dict(in_dim=qw.in_dim, group_size=128)
    if "norm" in fusion:
        kw["norm_weight"] = 1 + 0.1 * randn(gen, k, dtype=torch.float32)
    if "res" in fusion:
        kw["residual"] = randn(gen, m, n)
    if fusion.startswith("rope"):
        style = fusion.split("_")[1]
        cos, sin = precompute_rope(hd, 2048, device="cuda")
        cr, sr = rope_rows(cos[1500], sin[1500], n // hd - 4, 4, hd, style)
        kw.update(rope_cos=cr, rope_sin=sr, rope_style=style, rope_hd=hd)
    return (x, qw.packed, qw.scales, qw.zeros), kw


@pytest.mark.parametrize("m", _TILE_MS)
@pytest.mark.parametrize("k,n", _TILE_KN)
def test_w4_tile(gen, m, k, n):
    """Row 1's many-row path with the norm and the residual, strided x rows,
    w2's padded in_dim."""
    args, kw = _tile_case(gen, m, k, n, "norm+res", strided=True)
    assert args[0].stride(0) == k + 64 and kw["in_dim"] >= k
    assert_close(planes_qmm(*args, **kw), planes_qmm_plain(*args, **kw))


@pytest.mark.parametrize("m", [17, 129, 511, 1023])
@pytest.mark.parametrize("style", ["interleaved", "half"])
@pytest.mark.parametrize("hd", [64, 128])
def test_w4_tile_rope(gen, m, style, hd):
    """The RoPE epilogue with its column partner in the 128-column tile."""
    args, kw = _tile_case(gen, m, 2048, 2560, f"rope_{style}", hd=hd)
    assert_close(planes_qmm(*args, **kw), planes_qmm_plain(*args, **kw))


@pytest.mark.parametrize("m,k,n,fusion", [(128, 2048, 2048, "res"), (512, 2048, 2048, "res"),
                                          (128, 5632, 2048, "res"), (512, 5632, 2048, "res"),
                                          (128, 2048, 2560, "norm"), (512, 2048, 256, "none"),
                                          (1023, 2048, 256, "norm+res"),
                                          (129, 2048, 2560, "rope_half")])
def test_w4_tile_split_k(gen, m, k, n, fusion):
    """Each shape whose plan splits K: two launches bit-equal (partials summed
    in split order), the unsplit plan within tolerance, no float atomics."""
    from accessory_tpu_torch.ops import w4_tile

    args, kw = _tile_case(gen, m, k, n, fusion)
    p = w4_tile.folded_plan(m, n, k, 128)
    assert p.split > 1
    one, two = planes_qmm(*args, **kw), planes_qmm(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    assert_close(one, planes_qmm(*args, split=1, **kw))
    assert_close(one, planes_qmm_plain(*args, **kw))


def test_w4_tile_refuses(gen):
    """The many-row path takes N 192 (a last 128-column tile of 64) and raises
    on what its tile does not take: N not a multiple of 64, half RoPE heads
    wider than the tile, a split past the groups; one counted launch a call."""
    qw = _w4(gen, 256, 192)
    x = randn(gen, 40, 256)
    assert_close(planes_qmm(x, qw.packed, qw.scales, qw.zeros, in_dim=256, group_size=128),
                 planes_qmm_plain(x, qw.packed, qw.scales, qw.zeros, in_dim=256, group_size=128))
    qw = _w4(gen, 256, 200)
    with pytest.raises(ValueError, match="multiple of 64"):
        planes_qmm(x, qw.packed, qw.scales, qw.zeros, in_dim=256, group_size=128)
    qw = _w4(gen, 256, 512)
    cos, sin = precompute_rope(256, 64, device="cuda")
    cr, sr = rope_rows(cos[3], sin[3], 1, 1, 256, "half")
    with pytest.raises(ValueError, match="whole heads"):
        planes_qmm(x, qw.packed, qw.scales, qw.zeros, None, None, cr, sr, in_dim=256,
                   group_size=128, rope_style="half", rope_hd=256)
    with pytest.raises(ValueError, match="split"):
        planes_qmm(x, qw.packed, qw.scales, qw.zeros, in_dim=256, group_size=128, split=3)
    before = kernels.launch_counts()["w4_matmul"]
    planes_qmm(x, qw.packed, qw.scales, qw.zeros, in_dim=256, group_size=128, split=2)
    assert kernels.launch_counts()["w4_matmul"] == before + 1


def _elem_call(kind, x, qw, split=None):
    from accessory_tpu_torch.ops.quant_matmul_magic import magic_qmm, magic_qmm_plain
    from accessory_tpu_torch.ops.quant_matmul_pallas import (quant_matmul_pallas,
                                                             quant_matmul_pallas_plain)

    if kind == "std":
        return quant_matmul_pallas(x, qw, split=split), quant_matmul_pallas_plain(x, qw)
    kw = dict(group_size=qw.group_size, tk=qw.tile_k)
    return (magic_qmm(x, qw.packed, qw.scales, qw.zeros, split=split, **kw),
            magic_qmm_plain(x, qw.packed, qw.scales, qw.zeros, **kw))


@pytest.mark.parametrize("kind", ["std", "magic"])
@pytest.mark.parametrize("m", [9, 65, 129, 513, 1030])
@pytest.mark.parametrize("n", [136, 2560])
def test_w4_elem_tile(gen, kind, m, n):
    """The std / magic tile at K 5632 (magic tiles of 512 rows), N a multiple
    of 8 only (136) and TinyLlama's 2560, ragged row counts; where the plan
    splits K, two launches bit-equal and the unsplit plan within tolerance."""
    from accessory_tpu_torch.ops import w4_tile
    from accessory_tpu_torch.quant.qtensor import to_magic_layout

    qw = _std_gptq_like(gen, 5632, n)
    tk = None
    if kind == "magic":
        qw = to_magic_layout(qw)
        tk = qw.tile_k
    x = randn(gen, m, 5632)
    got, want = _elem_call(kind, x, qw)
    assert_close(got, want)
    if w4_tile.elem_plan(m, n, 5632, tk).split > 1:
        again = _elem_call(kind, x, qw)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert_close(got, _elem_call(kind, x, qw, split=1)[0])


def test_w4_elem_tile_refuses(gen):
    from accessory_tpu_torch.ops.quant_matmul_pallas import quant_matmul_pallas

    std = _std_gptq_like(gen, 512, 256)
    with pytest.raises(ValueError, match="split"):
        quant_matmul_pallas(randn(gen, 40, 512), std, split=9)
    with pytest.raises(ValueError, match="N % 8"):
        quant_matmul_pallas(randn(gen, 40, 512), _std_gptq_like(gen, 512, 132))


# -- row 22's W8 tile (csrc/w8_matmul.cu, M > 8: wgmma, the row-prep pass and
#    the K split of ops/w4_tile.py w8_plan) and rows 24 / 25's tensor-core
#    GEMV (csrc/w4_elem.cuh, M <= 8, K split over a cluster)

_W8_FUSIONS = ["none", "norm+rope_interleaved", "norm+rope_half", "res", "norm+rope_half+res"]


def _w8_case(gen, m, k, kx, n, fusion, gs=128, hd=128, strided=False):
    """w8_qmm's arguments: a W8 weight of in_dim k (x narrower where kx < k)
    and the fusion's operands (RoPE rows of heads of ``hd``)."""
    qw = _w8(gen, k, n, gs)
    x = randn(gen, m, kx + 64)[:, :kx] if strided else randn(gen, m, kx)
    kw = dict(group_size=gs)
    if "norm" in fusion:
        kw["norm_weight"] = 1 + 0.1 * randn(gen, kx, dtype=torch.float32)
    if "res" in fusion:
        kw["residual"] = randn(gen, m, n)
    if "rope" in fusion:
        style = "half" if "half" in fusion else "interleaved"
        cos, sin = precompute_rope(hd, 2048, device="cuda")
        cr, sr = rope_rows(cos[1500], sin[1500], n // hd - 1, 1, hd, style)
        kw.update(rope_cos=cr, rope_sin=sr, rope_style=style, rope_hd=hd)
    return (x, qw.packed, qw.scales, qw.zeros), kw


@pytest.mark.parametrize("m", [9, 17, 128, 1024, 1030])
@pytest.mark.parametrize("fusion", _W8_FUSIONS)
def test_w8_tile(gen, m, fusion):
    """The W8 tile at ragged row counts around its 256-row tile, N 640 (5
    tiles of 128 columns), RoPE at head_dim 128 in both styles, the norm and
    the residual, and all three; one counted launch a call."""
    from accessory_tpu_torch.ops.quant_matmul_w8 import w8_qmm, w8_qmm_plain

    args, kw = _w8_case(gen, m, 1024, 1024, 640, fusion)
    before = kernels.launch_counts()["w8_matmul"]
    got = w8_qmm(*args, **kw)
    assert kernels.launch_counts()["w8_matmul"] == before + 1
    assert_close(got, w8_qmm_plain(*args, **kw))


@pytest.mark.parametrize("m", [9, 130, 1030])
@pytest.mark.parametrize("k,kx,n,gs", [(2048, 1152, 768, 128), (11264, 11008, 512, 128),
                                       (1152, 1152, 264, 64), (2048, 2048, 2056, 128),
                                       (512, 512, 4104, 64)])
def test_w8_tile_shapes(gen, m, k, kx, n, gs):
    """x narrower than a padded in_dim (11008 -> 11264), group size 64, strided
    x rows, and N not a multiple of the 128-column tile, also N % 16 == 8
    (264, 2056, 4104: the int8 rows then arrive by 8-byte cp.async pieces,
    not 16-byte ones)."""
    from accessory_tpu_torch.ops.quant_matmul_w8 import w8_qmm, w8_qmm_plain

    args, kw = _w8_case(gen, m, k, kx, n, "norm+res", gs=gs, strided=True)
    assert_close(w8_qmm(*args, **kw), w8_qmm_plain(*args, **kw))


@pytest.mark.parametrize("m,k,n,fusion", [(9, 4096, 4096, "res"), (128, 4096, 4096, "res"),
                                          (128, 4096, 12288, "norm+rope_interleaved"),
                                          (128, 11008, 4096, "res"), (512, 2048, 2560, "norm"),
                                          (1030, 2048, 2048, "norm+rope_half+res")])
def test_w8_tile_split_k(gen, m, k, n, fusion):
    """The plan's split and every other split the tile takes (1 .. 16 whole
    groups): each launched twice bit-equal (partials summed in split order,
    no atomics), each within tolerance of the plain version."""
    from accessory_tpu_torch.ops import w4_tile
    from accessory_tpu_torch.ops.quant_matmul_w8 import w8_qmm, w8_qmm_plain

    args, kw = _w8_case(gen, m, k, k, n, fusion)
    want = w8_qmm_plain(*args, **kw)
    chosen = w4_tile.w8_plan(m, n, k, 128).split
    for split in sorted({None, 1, 2, 3, 5, 8, 16, chosen}, key=lambda s: s or 0):
        one, two = w8_qmm(*args, split=split, **kw), w8_qmm(*args, split=split, **kw)
        torch.cuda.synchronize()
        assert torch.equal(one, two), f"split {split}: two launches differ"
        assert_close(one, want)


def _gemv_weight(gen, kind, k, n, gs=128):
    from accessory_tpu_torch.quant.qtensor import to_magic_layout

    qw = _std_gptq_like(gen, k, n, gs)
    return to_magic_layout(qw) if kind == "magic" else qw


@pytest.mark.parametrize("kind", ["std", "magic"])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("k,kx,n", [(2048, 2048, 2560), (5632, 5632, 2048), (2048, 1152, 2056),
                                    (11264, 11008, 512), (4096, 4096, 136)])
def test_w4_gemv(gen, kind, m, k, kx, n):
    """The std / magic GEMV at every row count it takes, TinyLlama's widths
    (magic tiles of 2048 and 512 rows), x narrower than in_dim (magic: a
    padded 7B in_dim, tile 1024), N = 2056 and 136 (not multiples of the
    128-column block); strided x rows; one counted launch a call."""
    qw = _gemv_weight(gen, kind, k, n)
    x = randn(gen, m, kx + 64)[:, :kx]
    entry = "w4_matmul_std" if kind == "std" else "w4_matmul_magic"
    before = kernels.launch_counts()[entry]
    got, want = _elem_call(kind, x, qw)
    assert kernels.launch_counts()[entry] == before + 1
    assert_close(got, want)


@pytest.mark.parametrize("kind", ["std", "magic"])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k,n", [(2048, 11264), (5632, 2048), (4096, 22016)])
def test_w4_gemv_splits(gen, kind, m, k, n):
    """Every cluster split (1 .. 8 blocks over K): each launched twice
    bit-equal (each rank sums its share of the columns over the blocks'
    partial tiles in rank order), each within tolerance of the plain
    version; the plan's own split among them."""
    from accessory_tpu_torch.ops import w4_tile

    qw = _gemv_weight(gen, kind, k, n)
    x = randn(gen, m, k)
    want = _elem_call(kind, x, qw)[1]
    units = w4_tile.elem_units(k, None if kind == "std" else qw.tile_k)
    assert 1 <= w4_tile.gemv_split(n, units) <= 8
    for split in range(1, 9):
        one, two = _elem_call(kind, x, qw, split)[0], _elem_call(kind, x, qw, split)[0]
        torch.cuda.synchronize()
        assert torch.equal(one, two), f"split {split}: two launches differ"
        assert_close(one, want)


def test_w4_gemv_refuses(gen):
    """The GEMV's split lies in 1 .. 8 and within the units; its operands
    must be 16-byte aligned at every row count."""
    from accessory_tpu_torch.ops.quant_matmul_pallas import quant_matmul_pallas

    std = _std_gptq_like(gen, 512, 256)
    with pytest.raises(ValueError, match="split"):
        quant_matmul_pallas(randn(gen, 4, 512), std, split=9)
    words = torch.zeros(512 // 8 * 256 + 2, dtype=torch.int32, device="cuda")[2:]
    bad = dataclasses.replace(std, packed=words.view(512 // 8, 256))
    with pytest.raises(ValueError, match="16-byte aligned"):
        quant_matmul_pallas(randn(gen, 4, 512), bad)


# ---------------------------------------------------------------- rows 1 and 22's fused GEMV
#    (csrc/qgemv.cuh: w4_matmul at M <= 16, w8_matmul at M <= 8, K split
#    over a cluster by ops/w4_tile.py folded_gemv_split / w8_gemv_split)

_GEMV_FUSIONS = ["none", "norm", "res", "norm+res", "norm+rope_interleaved", "norm+rope_half",
                 "rope_half+res"]


def _fusion_kw(gen, m, kx, n, fusion, hd=64):
    kw = {}
    if "norm" in fusion:
        kw["norm_weight"] = 1 + 0.1 * randn(gen, kx, dtype=torch.float32)
    if "res" in fusion:
        kw["residual"] = randn(gen, m, n)
    if "rope" in fusion:
        style = "half" if "half" in fusion else "interleaved"
        cos, sin = precompute_rope(hd, 1024, device="cuda")
        cr, sr = rope_rows(cos[700], sin[700], n // hd - 1, 1, hd, style)
        kw.update(rope_cos=cr, rope_sin=sr, rope_style=style, rope_hd=hd)
    return kw


def _every_split(call, units, want):
    """Every cluster split the GEMV takes (1 .. min(8, units)): two launches
    bit-equal, each within tolerance of the plain version and of split 1."""
    first = None
    for split in range(1, min(8, units) + 1):
        one, two = call(split), call(split)
        torch.cuda.synchronize()
        assert torch.equal(one, two), f"split {split}: two launches differ"
        assert_close(one, want)
        if first is None:
            first = one
        assert_close(one, first)


@pytest.mark.parametrize("m", [1, 4, 8, 9, 16])
@pytest.mark.parametrize("fusion", _GEMV_FUSIONS)
def test_w4_fused_gemv(gen, m, fusion):
    """Row 1's GEMV at every fusion: x narrower than a padded in_dim (1152 of
    2048: 18 units, so a split cuts a group of 128 rows), N 448 (a half-empty
    last 128-column block), strided x rows; one counted launch, every split
    against the plain version."""
    k, kx, n = 2048, 1152, 448
    qw = _w4(gen, kx, n, pad_in_to=1024)
    assert qw.in_dim == k
    x = randn(gen, m, kx + 64)[:, :kx]
    kw = dict(in_dim=k, group_size=128, **_fusion_kw(gen, m, kx, n, fusion))
    args = (x, qw.packed, qw.scales, qw.zeros)
    want = planes_qmm_plain(*args, **kw)
    before = kernels.launch_counts()["w4_matmul"]
    got = planes_qmm(*args, **kw)
    assert kernels.launch_counts()["w4_matmul"] == before + 1
    assert_close(got, want)
    _every_split(lambda sp: planes_qmm(*args, split=sp, **kw), kx // 64, want)


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("style", ["interleaved", "half"])
def test_w4_fused_gemv_shapes(gen, m, style):
    """RoPE at head_dim 128, group size 64, the 7B w2 width (K 11008 of
    11264: passes of staged x), operands that are not 16-byte aligned (the
    GEMV copies them in 4-byte pieces)."""
    from accessory_tpu_torch.quant.quantize import pad_to

    qw = _w4(gen, 1024, 768)
    kw = dict(in_dim=1024, group_size=128, **_fusion_kw(gen, m, 1024, 768, f"norm+rope_{style}",
                                                         hd=128))
    args = (randn(gen, m, 1024), qw.packed, qw.scales, qw.zeros)
    assert_close(planes_qmm(*args, **kw), planes_qmm_plain(*args, **kw))
    w = randn(gen, 512, 256, dtype=torch.float32, scale=512 ** -0.5)
    q64 = to_folded_layout(quantize_weight(w, 4, 64))
    args = (randn(gen, m, 512), q64.packed, q64.scales, q64.zeros)
    kw = dict(in_dim=512, group_size=64, residual=randn(gen, m, 256))
    assert_close(planes_qmm(*args, **kw), planes_qmm_plain(*args, **kw))
    words = torch.zeros(q64.packed.numel() + 1, dtype=torch.int32, device="cuda")
    off = words[1:].view_as(q64.packed)
    off.copy_(q64.packed)
    sc = torch.zeros(q64.scales.numel() + 1, device="cuda")[1:].view_as(q64.scales)
    sc.copy_(q64.scales)
    args = (args[0], off, sc, q64.zeros)
    assert off.data_ptr() % 16 != 0
    assert_close(planes_qmm(*args, **kw), planes_qmm_plain(*args, **kw))
    big = _w4(gen, 11008, 256, pad_in_to=pad_to(11008, 128))
    args = (randn(gen, m, 11008), big.packed, big.scales, big.zeros)
    kw = dict(in_dim=big.in_dim, group_size=128, norm_weight=1 + 0.1 * randn(
        gen, 11008, dtype=torch.float32), residual=randn(gen, m, 256))
    want = planes_qmm_plain(*args, **kw)
    _every_split(lambda sp: planes_qmm(*args, split=sp, **kw), 172, want)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("fusion", _GEMV_FUSIONS)
def test_w8_fused_gemv(gen, m, fusion):
    """Row 22's GEMV at every row count and fusion: x narrower than a padded
    in_dim, N 384 with RoPE (heads of 64) and N 264 (N % 16 == 8: the int8
    rows come in 8-byte pieces) without; one counted launch, every split
    against the plain version."""
    from accessory_tpu_torch.ops.quant_matmul_w8 import w8_qmm, w8_qmm_plain

    k, kx = 2048, 1152
    n = 384 if "rope" in fusion else 264
    qw = _w8(gen, k, n)
    x = randn(gen, m, kx + 64)[:, :kx]
    kw = dict(group_size=128, **_fusion_kw(gen, m, kx, n, fusion))
    args = (x, qw.packed, qw.scales, qw.zeros)
    want = w8_qmm_plain(*args, **kw)
    before = kernels.launch_counts()["w8_matmul"]
    got = w8_qmm(*args, **kw)
    assert kernels.launch_counts()["w8_matmul"] == before + 1
    assert_close(got, want)
    _every_split(lambda sp: w8_qmm(*args, split=sp, **kw), kx // 64, want)


def test_fused_gemv_refuses(gen):
    """A split outside 1 .. min(8, units) raises in the wrapper; half-style
    heads must divide the 128-column tile."""
    from accessory_tpu_torch.ops.quant_matmul_w8 import w8_qmm

    qw = _w4(gen, 256, 512)
    x = randn(gen, 4, 256)
    for split in (0, 5):
        with pytest.raises(ValueError, match="split"):
            planes_qmm(x, qw.packed, qw.scales, qw.zeros, in_dim=256, group_size=128,
                       split=split)
    cos, sin = precompute_rope(192, 64, device="cuda")
    cr, sr = rope_rows(cos[3], sin[3], 2, 1, 192, "half")
    q6 = _w4(gen, 256, 576)
    with pytest.raises(ValueError, match="whole heads"):
        planes_qmm(x, q6.packed, q6.scales, q6.zeros, None, None, cr, sr, in_dim=256,
                   group_size=128, rope_style="half", rope_hd=192)
    q8 = _w8(gen, 256, 512)
    with pytest.raises(ValueError, match="split"):
        w8_qmm(x, q8.packed, q8.scales, q8.zeros, group_size=128, split=9)


# ---------------------------------------------------------------- the int8 write body


def _special_vectors(nk, nv, hd):
    """Write an all-zero k vector (scale 1e-6 / 127, zeros) and a v vector of
    quotients at .5 (amax 127: scale 1.0, x / scale = k + 0.5, rounded half
    to even) into every layer of (..., B, sq, NKV, HD) chunks; returns the
    halves."""
    halves = torch.arange(hd, device="cuda", dtype=torch.float32) % 120 - 60 + 0.5
    halves[0], halves[1] = 127, -127
    nk[..., 0, 0, 0, :] = 0
    nv[..., -1, -1, -1, :] = halves.to(nv.dtype)
    return halves


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("sq", [1, 77])
@pytest.mark.parametrize("at_end", [False, True])
def test_int8_write_body_static(gen, hd, sq, at_end):
    """The quantizing body of csrc/kv_quant.cuh through write_kv_layer8
    (kv_write_slab_q8, kv_write_col_q8 at one token) and write_kv_t8
    (kv_write_stacked_q8): B 3, NKV 5 and sq 77 leave a ragged tail in every
    tiling, k / v are strided views of a qkv-like buffer, pos 0 and S - sq,
    an all-zero vector and one of quotients at .5: int8 pools equal to the
    plain version's, scales to f32 rounding."""
    n_layers, b, nkv, s_len = 2, 3, 5, 160
    pos = s_len - sq if at_end else 0
    buf = randn(gen, n_layers, b, sq, 3 * nkv * hd, scale=2.0)
    nk = buf[..., nkv * hd:2 * nkv * hd].view(n_layers, b, sq, nkv, hd)
    nv = buf[..., 2 * nkv * hd:].view(n_layers, b, sq, nkv, hd)
    halves = _special_vectors(nk, nv, hd)
    pools = _int8_pools(gen, b, nkv, s_len, hd)
    pools2 = tuple(p.clone() for p in pools)
    got = _one_more("kv_write_col_q8" if sq == 1 else "kv_write_q8",
                    lambda: write_kv_layer8(*pools, nk[0], nv[0], pos))
    assert_pools8(got, write_kv_layer8_plain(*pools2, nk[0], nv[0], pos))
    stacked = tuple(torch.stack(ps) for ps in zip(*(_int8_pools(gen, b, nkv, s_len, hd)
                                                    for _ in range(n_layers))))
    stacked2 = tuple(p.clone() for p in stacked)
    got = _one_more("kv_write_stacked_q8", lambda: write_kv_t8(*stacked, nk, nv, pos))
    assert_pools8(got, write_kv_t8_plain(*stacked2, nk, nv, pos))
    last = pos + sq - 1
    for layer in range(n_layers):
        assert float(got[2][layer, 0, 0, pos]) == pytest.approx(1e-6 / 127, rel=1e-6)
        assert not got[0][layer, 0, 0, pos].any()
        assert float(got[3][layer, -1, -1, last]) == 1.0
        assert torch.equal(got[1][layer, -1, -1, last], torch.round(halves).to(torch.int8))


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("s", [1, 77])
def test_int8_write_body_paged(gen, hd, s):
    """The same body through paged_write_q8: 3 slots, NKV 5, s 1 and 77
    (ragged tilings), 16-token pages so a slot's tokens cross pages, the last
    slot's positions running past its table into TRASH, strided views, the
    special vectors: the pools outside the TRASH page equal (int8 values
    equal, scales to f32 rounding)."""
    from accessory_tpu_torch.ops.paged_write import paged_write_tokens, paged_write_tokens_plain

    n_layers, b, nkv, ps, pps = 2, 3, 5, 16, 8
    n_pages = b * pps + 1
    pools, _, _ = _paged_case(gen, b, nkv, hd, ps, pps, n_pages, True, [0] * b, layers=n_layers)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(s)) + 1
    table = perm[:b * pps].reshape(b, pps).to(torch.int32).cuda()
    cap = pps * ps
    start = torch.tensor([0, min(ps - 3, cap - s), cap - s // 2], dtype=torch.int32,
                         device="cuda")
    buf = randn(gen, n_layers, b, s, 3 * nkv * hd, scale=2.0)
    kn = buf[..., :nkv * hd].view(n_layers, b, s, nkv, hd)
    vn = buf[..., 2 * nkv * hd:].view(n_layers, b, s, nkv, hd)
    _special_vectors(kn[:, :2], vn[:, :2], hd)   # slots 0 and 1 stay inside their tables
    plain = [p.clone() for p in pools]
    _one_more("paged_write_q8", lambda: paged_write_tokens(*pools[:2], kn, vn, table, start,
                                                           *pools[2:]))
    paged_write_tokens_plain(*plain[:2], kn, vn, table, start, *plain[2:])
    assert_pools8([p[:, :, 1:] for p in pools], [p[:, :, 1:] for p in plain])


def _every_byte_pools(gen, b, nkv, s_len, hd):
    """int8 pools of random bytes over the whole range -128..127 (-128 too,
    which the quantizer never writes), the first 2 * HD bytes of every head
    (cached tokens 0 and 1) counting up from -128."""
    ck, cv, ks, vs = _int8_pools(gen, b, nkv, s_len, hd)
    for c in (ck, cv):
        c.copy_(torch.randint(-128, 128, c.shape, generator=gen, device="cuda",
                              dtype=torch.int8))
        c[:, :, :2] = (torch.arange(2 * hd, device="cuda") - 128).to(torch.int8).view(2, hd)
    return ck, cv, ks, vs


@pytest.mark.parametrize("write", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s_len,pos", [(1024, 0), (1024, 1), (1024, 2), (1024, 511),
                                       (1024, 1023), (192, 150)])
def test_mha8_every_byte_value(gen, write, hd, s_len, pos):
    """decode_attention_mha8 (row 14) and decode_attention_mha8_ro (row 15 at
    R 1), whose widening of the cache takes no conversion instruction, over
    caches holding every byte value: within the kernel tolerance of the
    plain version's cast, the fused write's pools equal."""
    b, nkv = 2, 4
    q, kn, vn = _qkv(gen, b, nkv, nkv, hd)
    pools = _every_byte_pools(gen, b, nkv, s_len, hd)
    pools2 = tuple(p.clone() for p in pools)
    if write:
        got = _one_more("decode_attention_mha8",
                        lambda: decode_attention_update8(q, kn, vn, *pools, pos))
        want = decode_attention_update8_plain(q, kn, vn, *pools2, pos)
        assert_close(got[0], want[0])
        assert_pools8(got[1:], want[1:])
    else:
        got = _one_more("decode_attention_mha8_ro",
                        lambda: cached_attention_t8(q, kn, vn, *pools, pos))
        assert_close(got, cached_attention_decode8_plain(q, kn, vn, *pools2, pos))


def test_remat_selective_keeps_the_flash_output(gen):
    """The QPEFT step of test_small_model_train_step_cuda_matches_cpu under
    remat=True and "full" on the card: the selective policy keeps each
    layer's flash output (2 forward launches a step, not 4) and recomputes
    the W4 products (28 under both); the same loss and gradients."""
    from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from accessory_tpu_torch.train.precision import promote_trainable_params_to_fp32
    from accessory_tpu_torch.train.train_step import grads_of

    args = LLaMAArgs(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512,
                     multiple_of=128, max_seq_len=128, dtype="bfloat16", lora_rank=8,
                     bias_tuning=True, norm_tuning=True)
    trainable = llama.get_trainable_params_filter(args)
    toks = torch.randint(1, 512, (2, 2, 96), generator=torch.Generator().manual_seed(0))
    batch = {"examples": toks[0], "labels": toks[1]}
    res = {}
    for remat in ("full", True):
        params = promote_trainable_params_to_fp32(
            quantize_params(llama.init_params(args, seed=5)), trainable)
        tx = make_optimizer(params, 1e-3, clip_norm=1.0, trainable=trainable)
        kernels.reset_launch_counts()
        state, m = make_train_step(llama, args, tx, remat=remat)(TrainState.create(params, tx),
                                                                 batch)
        res[remat] = (float(m["c_loss"]), {k: g.float().cpu() for k, g in
                                           grads_of(state).items()}, kernels.launch_counts())
    (lf, gf, cf), (ls, gs, cs) = res["full"], res[True]
    assert cf["flash_attention"] == 4 and cs["flash_attention"] == 2
    assert cf["w4_matmul"] == cs["w4_matmul"] == 28
    assert cf["w4_dequant"] == cs["w4_dequant"] == 14
    assert abs(ls - lf) <= 1e-6 * abs(lf)
    for path, g in gf.items():
        err = float((gs[path] - g).norm() / g.norm().clamp_min(1e-30))
        assert err <= 1e-3, (path, err)


def test_small_mixtral_moe_aux_step_cuda_matches_cpu(gen):
    """One Mixtral training step with the MoE loss (2 layers, dim 256, 4
    experts of 256, W4 g128 experts and attention, every dense leaf
    trained) on the card and on the CPU from the same weights and batch, the
    card routing as the CPU did (its step runs inside the CPU's recorded
    routing, ops.moe.routing_replay, so a bf16 tie cannot flip an expert):
    loss, c_loss and aux_loss to 1e-2 relative, every trainable gradient to
    5e-2 relative L2 (test_small_model_train_step_cuda_matches_cpu's), and
    the card's W4 launches exact to the routing: per microbatch-layer 4 + 3 x
    touched on row 1's tile (192 rows) and as many dequants in the
    backward."""
    from accessory_tpu_torch.config import MixtralArgs
    from accessory_tpu_torch.models import mixtral
    from accessory_tpu_torch.ops import moe
    from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from accessory_tpu_torch.train.precision import promote_trainable_params_to_fp32
    from accessory_tpu_torch.train.train_step import grads_of

    args = MixtralArgs(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=256,
                       num_experts=4, vocab_size=512, max_seq_len=128, dtype="bfloat16")
    trainable = mixtral.get_trainable_params_filter(args)
    params = promote_trainable_params_to_fp32(
        quantize_params(mixtral.init_params(args, seed=2), blocklist=["gate", "norm",
                                                                      "tok_embeddings",
                                                                      "output"]), trainable)
    toks = torch.randint(1, 512, (2, 2, 96), generator=torch.Generator().manual_seed(0))
    batch = {"examples": toks[0], "labels": toks[1]}
    memo, res = [], {}
    for device in ("cpu", "cuda"):
        p = _to(params, device)
        tx = make_optimizer(p, 1e-3, clip_norm=1.0, trainable=trainable)
        step = make_train_step(mixtral, args, tx, remat=False, moe_aux=True, device=device)
        kernels.reset_launch_counts()
        with moe.record_routing() as log, moe.routing_replay([m.to(device) for m in memo]
                                                              if memo else memo):
            state, m = step(TrainState.create(p, tx), batch)
        res[device] = ({k: float(v) for k, v in m.items()},
                       {k: g.float().cpu() for k, g in grads_of(state).items()},
                       kernels.launch_counts(), log)
    (mg, gg, counts, glog), (mc, gc, _, clog) = res["cuda"], res["cpu"]
    assert [e["touched"] for e in glog] == [e["touched"] for e in clog]
    for key in ("loss", "c_loss", "aux_loss"):
        assert abs(mg[key] - mc[key]) <= 1e-2 * abs(mc[key]), key
    for path in tx.labels:
        if tx.labels[path] != "frozen":
            err = float((gg[path] - gc[path]).norm() / gc[path].norm().clamp_min(1e-30))
            assert err <= 5e-2, (path, err)
    w4 = sum(4 + 3 * sum(e["touched"]) for e in glog)
    assert counts["w4_matmul"] == counts["w4_dequant"] == w4
    assert counts["flash_attention"] == counts["flash_attention_bwd_dq"] == 2


# ---------------------------------------------------------------- Mixtral-8x7B shapes


MIXTRAL_PROJ = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k,n", MIXTRAL_PROJ)
def test_w4_matmul_mixtral_shapes(gen, m, k, n):
    """Row 1's GEMV at Mixtral's decode products (wq / wo, wk / wv, an
    expert's w1 / w3 and w2), no fusion: one launch, within a rounding step
    of the plain version."""
    qw = _w4(gen, k, n)
    args = (randn(gen, m, k), qw.packed, qw.scales, qw.zeros)
    got = _one_more("w4_matmul", lambda: planes_qmm(*args, in_dim=k, group_size=128))
    assert_close(got, planes_qmm_plain(*args, in_dim=k, group_size=128))


@pytest.mark.parametrize("k,n", MIXTRAL_PROJ[1:])
def test_w4_matmul_bigm_mixtral(gen, k, n):
    """Row 5 at Mixtral's 8 x 128 = 1024-row prefill (wk / wv and an expert's
    products): within a rounding step of the plain version, a second launch
    bit-equal."""
    qw = _w4(gen, k, n)
    x = randn(gen, 1024, k)
    got = _one_more("w4_matmul_bigm", lambda: planes_qmm_bigm(
        x, qw.packed, qw.scales, qw.zeros, in_dim=k, group_size=128))
    assert_close(got, planes_qmm_bigm_plain(x, qw.packed, qw.scales, qw.zeros, in_dim=k,
                                            group_size=128))
    again = planes_qmm_bigm(x, qw.packed, qw.scales, qw.zeros, in_dim=k, group_size=128)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_flash_attention_mixtral(gen):
    """Row 3 at Mixtral's prefill: B 8, S 128, 32 query / 8 KV heads of 128."""
    q, k, v = randn(gen, 8, 128, 32, 128), randn(gen, 8, 128, 8, 128), randn(gen, 8, 128, 8, 128)
    got = _one_more("flash_attention", lambda: flash_attention(q, k, v))
    assert_close(got, grouped_attention(q, k, v, causal=True))


@pytest.mark.parametrize("int8", [False, True])
def test_slab_write_mixtral(gen, int8):
    """Rows 4 and 17 at Mixtral's prefill: B 8, sq 128, 8 KV heads of 128,
    k / v strided views of one projection-like buffer; the bf16 cache equal
    to the plain copy, the int8 pools as assert_pools8 holds them."""
    b, sq, nkv, hd, s_len = 8, 128, 8, 128, 192
    buf = randn(gen, b, sq, 3 * nkv * hd)
    nk = buf[..., :nkv * hd].view(b, sq, nkv, hd)
    nv = buf[..., 2 * nkv * hd:].view(b, sq, nkv, hd)
    if int8:
        pools = (torch.zeros((b, nkv, s_len, hd), dtype=torch.int8, device="cuda"),
                 torch.zeros((b, nkv, s_len, hd), dtype=torch.int8, device="cuda"),
                 torch.zeros((b, nkv, s_len), device="cuda"),
                 torch.zeros((b, nkv, s_len), device="cuda"))
        pools2 = tuple(p.clone() for p in pools)
        got = _one_more("kv_write_q8", lambda: write_kv_layer8(*pools, nk, nv, 0))
        assert_pools8(got, write_kv_layer8_plain(*pools2, nk, nv, 0))
    else:
        ck, cv = randn(gen, b, nkv, s_len, hd), randn(gen, b, nkv, s_len, hd)
        ck2, cv2 = ck.clone(), cv.clone()
        _one_more("kv_write", lambda: write_kv_layer(ck, cv, nk, nv, 0))
        write_kv_layer_plain(ck2, cv2, nk, nv, 0)
        torch.cuda.synchronize()
        assert torch.equal(ck, ck2) and torch.equal(cv, cv2)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_small_mixtral_cuda_matches_cpu(gen, kv_dtype):
    """A 2-layer W4 Mixtral (dim 256, 4 experts of 256, top 2): a prefill and
    decode steps on the card and on the CPU. A token whose routing differs
    in some layer moves the next layers' k / v, so every later token of its
    row (the decode steps too, through the cache) is set aside; before a
    row's first such token the logits agree to 4% relative L2 and 5% of the
    largest |logit|: at this width bf16 rounding alone moves this model's
    decode logits by 1.0-1.3% relative L2 (its CPU bf16 run against the
    same weights in f32), and the two sides round at different points. At
    least 90% of the (token, layer) routings agree and half the logits are
    compared; each decode step launched row 1 exactly 4 + 3 x 4 times a
    layer (every expert's three GEMVs go out gated by the touched mask on the
    card, an untouched one writing zeros), whatever the routing."""
    from accessory_tpu_torch.config import MixtralArgs
    from accessory_tpu_torch.models import mixtral
    from accessory_tpu_torch.ops import moe

    args = MixtralArgs(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=256,
                       num_experts=4, vocab_size=512, max_seq_len=128)
    params = quantize_params(mixtral.init_params(args, seed=2))
    cpu = _to(params, "cpu")
    toks = torch.randint(0, 512, (3, 40), generator=torch.Generator().manual_seed(1))
    cg = mixtral.init_kv_cache(args, 3, 64, kv_dtype=kv_dtype)
    cc = mixtral.init_kv_cache(args, 3, 64, kv_dtype=kv_dtype, device="cpu")
    agree_all, clean, compared = [], torch.ones(3, dtype=torch.bool), 0
    for lo, hi in [(0, 32)] + [(p, p + 1) for p in range(32, 40)]:
        kernels.reset_launch_counts()
        with moe.record_routing(detail=True) as glog:
            lg, _ = mixtral.forward(params, args, toks[:, lo:hi].cuda(), cache=cg, cur_pos=lo)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        with moe.record_routing(detail=True) as clog:
            lc, _ = mixtral.forward(cpu, args, toks[:, lo:hi], cache=cc, cur_pos=lo)
        if hi - lo == 1:
            assert counts["w4_matmul"] == len(glog) * (4 + 3 * args.num_experts)
        same = torch.stack([(g["idx"].sort(-1).values == c["idx"].sort(-1).values).all(-1)
                            for g, c in zip(glog, clog)], dim=-1)
        agree_all.append(same.reshape(-1))
        tok_ok = same.all(-1).reshape(3, hi - lo)
        ok = clean[:, None] & (tok_ok.cumprod(dim=1) > 0)   # before the row's first flip
        clean &= tok_ok.all(dim=1)
        compared += int(ok.sum())
        if ok.any():
            g, c = lg.cpu()[ok], lc[ok]
            assert float((g - c).norm() / c.norm()) < 4e-2, (lo, hi)
            assert float((g - c).abs().max()) < 5e-2 * float(c.abs().max()), (lo, hi)
    assert float(torch.cat(agree_all).float().mean()) >= 0.9 and compared >= 3 * 40 // 2


# ---------------------------------------------------------------- Falcon-40B and InternLM-7B


# their W4 products beyond the LLaMA2-7B and Mixtral shapes: Falcon-40B's wk /
# wv, dense_h_to_4h and dense_4h_to_h (K 32768), InternLM-7B's w1 / w2 and its
# w3 (K 11008, padded to 11264 in the weight)
ZOO_PROJ = [(8192, 512, None), (8192, 32768, None), (32768, 8192, None), (4096, 11008, None),
            (11008, 4096, 1024)]


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k,n,pad", ZOO_PROJ)
def test_w4_matmul_zoo_shapes(gen, m, k, n, pad):
    """Row 1's GEMV at Falcon-40B's and InternLM-7B's decode products, no
    fusion (their biases are added after it): one launch, within a rounding
    step of the plain version."""
    qw = _w4(gen, k, n, pad_in_to=pad)
    args = (randn(gen, m, k), qw.packed, qw.scales, qw.zeros)
    got = _one_more("w4_matmul", lambda: planes_qmm(*args, in_dim=qw.in_dim, group_size=128))
    assert_close(got, planes_qmm_plain(*args, in_dim=qw.in_dim, group_size=128))


@pytest.mark.parametrize("k,n,pad", ZOO_PROJ)
def test_w4_matmul_bigm_zoo(gen, k, n, pad):
    """Row 5 at their 8 x 128 = 1024-row prefill: within a rounding step of
    the plain version, a second launch bit-equal."""
    qw = _w4(gen, k, n, pad_in_to=pad)
    x = randn(gen, 1024, k)
    kw = dict(in_dim=qw.in_dim, group_size=128)
    got = _one_more("w4_matmul_bigm",
                    lambda: planes_qmm_bigm(x, qw.packed, qw.scales, qw.zeros, **kw))
    assert_close(got, planes_qmm_bigm_plain(x, qw.packed, qw.scales, qw.zeros, **kw))
    again = planes_qmm_bigm(x, qw.packed, qw.scales, qw.zeros, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s_len,pos", [(1024, 0), (1024, 511), (1024, 1023), (192, 150)])
def test_decode_attention_falcon40b(gen, int8, s_len, pos):
    """Rows 2 and 13 at Falcon-40B's decode (batch 8, 128 query heads over 8
    KV heads: R 16, head_dim 64; q, k and v separate tensors, as its separate
    projections give them): the fused kernel against its plain version; the
    read-only form (rows 9 / 15) against its plain version."""
    b, nq, nkv, hd = 8, 128, 8, 64
    q, kn, vn = randn(gen, b, 1, nq, hd), randn(gen, b, 1, nkv, hd), randn(gen, b, 1, nkv, hd)
    pools = _int8_pools(gen, b, nkv, s_len, hd) if int8 else (randn(gen, b, nkv, s_len, hd),
                                                              randn(gen, b, nkv, s_len, hd))
    keep = tuple(p.clone() for p in pools)
    attn, plain = (cached_attention_t8, cached_attention_decode8_plain) if int8 \
        else (cached_attention_t, cached_attention_decode_plain)
    name = "decode_attention8" if int8 else "decode_attention"
    got = _one_more(name + "_ro", lambda: attn(q, kn, vn, *pools, pos))
    assert_close(got, plain(q, kn, vn, *keep, pos))
    update, update_plain = (decode_attention_update8, decode_attention_update8_plain) if int8 \
        else (decode_attention_update, decode_attention_update_plain)
    got = _one_more(name, lambda: update(q, kn, vn, *pools, pos))
    want = update_plain(q, kn, vn, *keep, pos)
    assert_close(got[0], want[0])
    if int8:
        assert_pools8(got[1:], want[1:])
    else:
        assert all(torch.equal(a, b_) for a, b_ in zip(got[1:], want[1:]))


def _internlm_qkv(gen, b, sq, nh, hd):
    """q, k (RoPE outputs: tensors of their own) and v (a view of the fused
    Wqkv output, split (b, sq, 3, heads, hd)) as InternLM's block gives them."""
    qkv = randn(gen, b, sq, 3 * nh * hd).view(b, sq, 3, nh, hd)
    return qkv[:, :, 0].contiguous(), qkv[:, :, 1].contiguous(), qkv[:, :, 2]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s_len,pos", [(1024, 511), (192, 150)])
def test_decode_attention_internlm7b(gen, int8, s_len, pos):
    """Rows 7 and 14 at InternLM-7B's decode (batch 8, 32 heads of 128, v a
    view of the Wqkv output): the fused one-query-head kernel against its
    plain version, pools equal."""
    b, nh, hd = 8, 32, 128
    q, kn, vn = _internlm_qkv(gen, b, 1, nh, hd)
    pools = _int8_pools(gen, b, nh, s_len, hd) if int8 else (randn(gen, b, nh, s_len, hd),
                                                             randn(gen, b, nh, s_len, hd))
    keep = tuple(p.clone() for p in pools)
    update, update_plain = (decode_attention_update8, decode_attention_update8_plain) if int8 \
        else (decode_attention_update, decode_attention_update_plain)
    got = _one_more("decode_attention_mha8" if int8 else "decode_attention_mha",
                    lambda: update(q, kn, vn, *pools, pos))
    want = update_plain(q, kn, vn, *keep, pos)
    assert_close(got[0], want[0])
    if int8:
        assert_pools8(got[1:], want[1:])
    else:
        assert all(torch.equal(a, b_) for a, b_ in zip(got[1:], want[1:]))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("family", ["falcon40b", "internlm7b"])
def test_slab_write_zoo(gen, family, int8):
    """Rows 4 and 17 at the prefill (B 8, sq 128): Falcon-40B's 8 KV heads of
    64 (separate tensors), InternLM-7B's 32 of 128 (v a view of the Wqkv
    output); the bf16 cache equal to the plain copy, the int8 pools as
    assert_pools8 holds them."""
    b, sq, s_len = 8, 128, 192
    if family == "falcon40b":
        nkv, hd = 8, 64
        nk, nv = randn(gen, b, sq, nkv, hd), randn(gen, b, sq, nkv, hd)
    else:
        nkv, hd = 32, 128
        _, nk, nv = _internlm_qkv(gen, b, sq, nkv, hd)
    if int8:
        pools = (torch.zeros((b, nkv, s_len, hd), dtype=torch.int8, device="cuda"),
                 torch.zeros((b, nkv, s_len, hd), dtype=torch.int8, device="cuda"),
                 torch.zeros((b, nkv, s_len), device="cuda"),
                 torch.zeros((b, nkv, s_len), device="cuda"))
        pools2 = tuple(p.clone() for p in pools)
        got = _one_more("kv_write_q8", lambda: write_kv_layer8(*pools, nk, nv, 0))
        assert_pools8(got, write_kv_layer8_plain(*pools2, nk, nv, 0))
    else:
        ck, cv = randn(gen, b, nkv, s_len, hd), randn(gen, b, nkv, s_len, hd)
        ck2, cv2 = ck.clone(), cv.clone()
        _one_more("kv_write", lambda: write_kv_layer(ck, cv, nk, nv, 0))
        write_kv_layer_plain(ck2, cv2, nk, nv, 0)
        torch.cuda.synchronize()
        assert torch.equal(ck, ck2) and torch.equal(cv, cv2)


def test_flash_attention_falcon40b(gen):
    """Row 3 at Falcon-40B's prefill: B 8, S 128, 128 query / 8 KV heads of 64."""
    q, k, v = randn(gen, 8, 128, 128, 64), randn(gen, 8, 128, 8, 64), randn(gen, 8, 128, 8, 64)
    got = _one_more("flash_attention", lambda: flash_attention(q, k, v))
    assert_close(got, grouped_attention(q, k, v, causal=True))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("family", ["internlm", "falcon"])
def test_small_zoo_model_cuda_matches_cpu(gen, family, kv_dtype):
    """A 2-layer W4 InternLM (MHA, biased Wqkv / out_proj) and Falcon (new
    decoder architecture, 8 query / 2 KV heads) at hidden 512, head_dim 64:
    a 32-token prefill and 8 decode steps, card against CPU within 2%
    relative L2 and 2% of the largest |logit| (test_small_model_cuda_
    matches_cpu's limits); each decode step launches row 1 once a
    projection (5 / 6 a layer) and the decode attention once a layer."""
    from accessory_tpu_torch.config import FalconArgs, InternLMArgs
    from accessory_tpu_torch.models import falcon, internlm

    if family == "internlm":
        module, n_proj = internlm, 5
        args = InternLMArgs(num_layers=2, hidden_size=512, num_attention_heads=8,
                            vocab_size=512, multiple_of=256, max_seq_len=128)
    else:
        module, n_proj = falcon, 6
        args = FalconArgs(num_layers=2, hidden_size=512, num_attention_heads=8, num_kv_heads=2,
                          vocab_size=512, max_seq_len=128)
    params = quantize_params(module.init_params(args, seed=3))
    if family == "internlm":   # non-zero biases, so the bias add is held too
        for layer in params["layers"]:
            for mod in layer["mixer"].values():
                mod["bias"] = randn(gen, mod["bias"].shape[0], scale=0.1)
    cpu = _to(params, "cpu")
    toks = torch.randint(0, 512, (3, 40), generator=torch.Generator().manual_seed(0))
    cg = module.init_kv_cache(args, 3, 64, kv_dtype=kv_dtype)
    cc = module.init_kv_cache(args, 3, 64, kv_dtype=kv_dtype, device="cpu")
    attn = ("decode_attention_mha" if family == "internlm" else "decode_attention") \
        + ("8" if kv_dtype else "")
    for lo, hi in [(0, 32)] + [(p, p + 1) for p in range(32, 40)]:
        kernels.reset_launch_counts()
        lg, _ = module.forward(params, args, toks[:, lo:hi].cuda(), cache=cg, cur_pos=lo)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        lc, _ = module.forward(cpu, args, toks[:, lo:hi], cache=cc, cur_pos=lo)
        if hi - lo == 1:
            assert counts["w4_matmul"] == n_proj * 2 and counts[attn] == 2
            assert sum(counts.values()) == n_proj * 2 + 2
        g = lg.cpu()
        assert torch.isfinite(g).all()
        assert float((g - lc).norm() / lc.norm()) < 2e-2, (lo, hi)
        assert float((g - lc).abs().max()) < 2e-2 * float(lc.abs().max()) + 2e-2, (lo, hi)


# ---------------------------------------------------------------- Falcon-7B


# its one W4 product: dense_4h_to_h, x 18176 wide, the weight padded to 18432,
# N 4544 (35 whole 128-column tiles and one of 64)
F7_K, F7_IN, F7_N = 18176, 18432, 4544


@pytest.mark.parametrize("m", [17, 128, 512, 1000])
def test_w4_tile_falcon7b(gen, m):
    """Row 1's many-row tile at Falcon-7B's dense_4h_to_h (N 4544: the last
    128-column tile half empty): one launch within a rounding step of the
    plain version, a second launch bit-equal, the unsplit plan within
    tolerance; the call allocates its output and the plan's scratch and
    nothing more (no padded copy of the 42 MB of words)."""
    from accessory_tpu_torch.ops import w4_tile

    qw = _w4(gen, F7_K, F7_N, pad_in_to=1024)
    assert qw.in_dim == F7_IN
    args = (randn(gen, m, F7_K), qw.packed, qw.scales, qw.zeros)
    kw = dict(in_dim=F7_IN, group_size=128)
    planes_qmm(*args, **kw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = _one_more("w4_matmul", lambda: planes_qmm(*args, **kw))
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    scratch = w4_tile.scratch_layout(w4_tile.folded_plan(m, F7_N, F7_K, 128), xsum=True)[1]
    assert grown <= m * F7_N * 2 + scratch + 2 ** 20, grown
    assert_close(got, planes_qmm_plain(*args, **kw))
    assert torch.equal(got, planes_qmm(*args, **kw))
    assert_close(planes_qmm(*args, split=1, **kw), got)


@pytest.mark.parametrize("m", [1024, 1030, 4096])
def test_w4_matmul_bigm_falcon7b(gen, m):
    """Row 5 at Falcon-7B's dense_4h_to_h (N 4544: a last column panel of 64)
    from its 1024-row prefill on: within a rounding step of the plain
    version, the same bits from a second launch and from another persistent
    grid; the call allocates its output alone (no weight copied)."""
    qw = _w4(gen, F7_K, F7_N, pad_in_to=1024)
    x = randn(gen, m, F7_K)
    kw = dict(in_dim=F7_IN, group_size=128)
    planes_qmm_bigm(x, qw.packed, qw.scales, qw.zeros, **kw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = _one_more("w4_matmul_bigm",
                    lambda: planes_qmm_bigm(x, qw.packed, qw.scales, qw.zeros, **kw))
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= m * F7_N * 2 + 2 ** 20
    assert_close(got, planes_qmm_bigm_plain(x, qw.packed, qw.scales, qw.zeros, **kw))
    again = planes_qmm_bigm(x, qw.packed, qw.scales, qw.zeros, **kw)
    regrid = planes_qmm_bigm(x, qw.packed, qw.scales, qw.zeros, ctas=61, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, regrid)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s_len,pos", [(1024, 0), (1024, 511), (1024, 1023), (192, 150)])
def test_decode_attention_falcon7b(gen, int8, s_len, pos):
    """Rows 2 / 13 and the read-only rows 8 / 15 at Falcon-7B's decode (batch
    8, 71 query heads over one KV head of 64: a tile of 64 query rows and
    one of 7; q, k and v separate tensors): each against its plain version,
    the fused write's pools equal to the plain write's (int8 bit for bit,
    scales to f32 rounding), the read-only form leaving them untouched."""
    b, nq, nkv, hd = 8, 71, 1, 64
    q, kn, vn = randn(gen, b, 1, nq, hd), randn(gen, b, 1, nkv, hd), randn(gen, b, 1, nkv, hd)
    pools = _int8_pools(gen, b, nkv, s_len, hd) if int8 else (randn(gen, b, nkv, s_len, hd),
                                                              randn(gen, b, nkv, s_len, hd))
    keep = tuple(p.clone() for p in pools)
    attn, plain = (cached_attention_t8, cached_attention_decode8_plain) if int8 \
        else (cached_attention_t, cached_attention_decode_plain)
    name = "decode_attention8" if int8 else "decode_attention"
    got = _one_more(name + "_ro", lambda: attn(q, kn, vn, *pools, pos))
    assert_close(got, plain(q, kn, vn, *keep, pos))
    assert all(torch.equal(a, b_) for a, b_ in zip(pools, keep))
    update, update_plain = (decode_attention_update8, decode_attention_update8_plain) if int8 \
        else (decode_attention_update, decode_attention_update_plain)
    got = _one_more(name, lambda: update(q, kn, vn, *pools, pos))
    want = update_plain(q, kn, vn, *keep, pos)
    assert_close(got[0], want[0])
    if int8:
        assert_pools8(got[1:], want[1:])
    else:
        assert all(torch.equal(a, b_) for a, b_ in zip(got[1:], want[1:]))


@pytest.mark.parametrize("int8", [False, True])
def test_prefill_kernels_falcon7b(gen, int8):
    """Row 3 at Falcon-7B's prefill (B 8, S 128, 71 query heads over one of
    64: one head a block, 71 being odd) against grouped attention, and the
    slab write (rows 4 / 17) of its one KV head against the plain write."""
    b, sq, s_len, hd = 8, 128, 192, 64
    q, k, v = randn(gen, b, sq, 71, hd), randn(gen, b, sq, 1, hd), randn(gen, b, sq, 1, hd)
    got = _one_more("flash_attention", lambda: flash_attention(q, k, v))
    assert_close(got, grouped_attention(q, k, v, causal=True))
    if int8:
        pools = (torch.zeros((b, 1, s_len, hd), dtype=torch.int8, device="cuda"),
                 torch.zeros((b, 1, s_len, hd), dtype=torch.int8, device="cuda"),
                 torch.zeros((b, 1, s_len), device="cuda"),
                 torch.zeros((b, 1, s_len), device="cuda"))
        pools2 = tuple(p.clone() for p in pools)
        got = _one_more("kv_write_q8", lambda: write_kv_layer8(*pools, k, v, 0))
        assert_pools8(got, write_kv_layer8_plain(*pools2, k, v, 0))
    else:
        ck, cv = randn(gen, b, 1, s_len, hd), randn(gen, b, 1, s_len, hd)
        ck2, cv2 = ck.clone(), cv.clone()
        _one_more("kv_write", lambda: write_kv_layer(ck, cv, k, v, 0))
        write_kv_layer_plain(ck2, cv2, k, v, 0)
        torch.cuda.synchronize()
        assert torch.equal(ck, ck2) and torch.equal(cv, cv2)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_falcon7b_layer_cuda_matches_cpu(gen, kv_dtype):
    """One Falcon-7B layer at full width (vocab cut to 512), W4 by
    quantize_params (dense_4h_to_h alone): a 2 x 16 prefill and 4 decode
    steps, card against CPU within 2% relative L2 and 2% of the largest
    |logit| (test_small_zoo_model_cuda_matches_cpu's limits); each decode
    step launches row 1 and the decode attention once."""
    from accessory_tpu_torch.config import FalconArgs
    from accessory_tpu_torch.models import falcon

    args = FalconArgs(num_layers=1, hidden_size=4544, num_attention_heads=71, multi_query=True,
                      new_decoder_architecture=False, parallel_attn=True, bias=False,
                      vocab_size=512, max_seq_len=64)
    params = quantize_params(falcon.init_params(args, seed=3))
    assert sum(hasattr(w["weight"], "packed") for mod in params["layers"][0].values()
               for w in mod.values() if isinstance(w, dict) and "weight" in w) == 1
    cpu = _to(params, "cpu")
    toks = torch.randint(0, 512, (2, 20), generator=torch.Generator().manual_seed(0))
    cg = falcon.init_kv_cache(args, 2, 64, kv_dtype=kv_dtype)
    cc = falcon.init_kv_cache(args, 2, 64, kv_dtype=kv_dtype, device="cpu")
    attn = "decode_attention" + ("8" if kv_dtype else "")
    for lo, hi in [(0, 16)] + [(p, p + 1) for p in range(16, 20)]:
        kernels.reset_launch_counts()
        lg, _ = falcon.forward(params, args, toks[:, lo:hi].cuda(), cache=cg, cur_pos=lo)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        lc, _ = falcon.forward(cpu, args, toks[:, lo:hi], cache=cc, cur_pos=lo)
        if hi - lo == 1:
            assert counts["w4_matmul"] == 1 and counts[attn] == 1
            assert sum(counts.values()) == 2
        g = lg.cpu()
        assert torch.isfinite(g).all()
        assert float((g - lc).norm() / lc.norm()) < 2e-2, (lo, hi)
        assert float((g - lc).abs().max()) < 2e-2 * float(lc.abs().max()), (lo, hi)


# ---------------------------------------------------------------- SPHINX

SPHINX_TINY = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=4, vocab_size=512, multiple_of=128,
                   vit_patch=56, clip_width=64, clip_layers=2, clip_heads=4, dino_width=96,
                   dino_layers=2, dino_heads=4, convnext_depths=(1, 1, 1, 1),
                   convnext_dims=(16, 32, 64, 128), qformer_width=64, qformer_layers=2,
                   qformer_heads=4, max_seq_len=1024)


def _rel_l2(got, want):
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all()
    return float((g - w).norm() / w.norm())


@pytest.mark.parametrize("tower", ["clip", "dinov2", "convnext", "qformer"])
def test_visual_tower_cuda_matches_cpu(gen, tower):
    """Each f32 tower (models/visual.py) on the card against the CPU, with
    TF32 off for matmuls as chip_smoke runs them: 1e-4 relative L2 (the
    same f32 sums in another order; the ConvNeXt depthwise convolution is
    elementwise on both)."""
    from accessory_tpu_torch.models import visual

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = torch.randn((3, 3, 224, 224), generator=torch.Generator().manual_seed(1))
        if tower in ("clip", "dinov2"):
            dino = tower == "dinov2"
            cfg = visual.ViTConfig(patch_size=14, width=96, layers=2, heads=4,
                                   **(dict(act="gelu", ln_pre=False, layerscale=True, ffn="swiglu",
                                           norm_eps=1e-6, patch_bias=True) if dino else {}))
            params, fn = visual.init_vit(cfg, seed=2, device="cpu"), visual.vit_forward
        elif tower == "convnext":
            cfg = visual.ConvNeXtConfig(depths=(1, 2, 1, 1), dims=(16, 32, 64, 128))
            params, fn = visual.init_convnext(cfg, seed=2, device="cpu"), visual.convnext_forward
            for stage in params["stages"]:
                stage["blocks"]["gamma"].fill_(0.5)
        else:
            cfg = visual.QFormerConfig(width=64, layers=2, heads=4, kv_dim=96)
            params, fn = visual.init_qformer(cfg, seed=2, device="cpu"), visual.qformer_forward
            x = torch.randn((3, 257, 96), generator=torch.Generator().manual_seed(1))
        want = fn(params, cfg, x)
        got = fn(_to(params, "cuda"), cfg, x.cuda())
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _rel_l2(got, want) < 1e-4
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_flash_attention_sphinx_tail(gen):
    """Row 3 at a SPHINX-7B prefill length (1711 positions: 26 full 64-row
    tiles and a ragged tail of 47), B 2, 32 heads of 128."""
    q, k, v = (randn(gen, 2, 1711, 32, 128) for _ in range(3))
    got = _one_more("flash_attention", lambda: flash_attention(q, k, v))
    assert_close(got, grouped_attention(q, k, v, causal=True))


@pytest.mark.parametrize("visual_kind", ["ens", "ens5p2"])
def test_small_sphinx_cuda_matches_cpu(gen, visual_kind):
    """A SPHINX with tiny towers over a 2-layer W4 decoder (dim 256, MHA of
    64): encode_image on the card against the CPU (bf16 tokens within 1%
    relative L2), the multimodal prefill over [BOS, image words, 15 text
    tokens] and 6 decode steps at positions shifted by the image words, logits
    within 2% relative L2 and 2% of the largest |logit|; each decode step
    launches row 1 four times a layer and the one-query-head decode
    attention once a layer."""
    from accessory_tpu_torch.config import SphinxArgs
    from accessory_tpu_torch.models import sphinx

    size = 224 if visual_kind == "ens" else 448
    args = SphinxArgs(**SPHINX_TINY, visual=visual_kind, image_size=size)
    params = fuse_for_decode(quantize_params(sphinx.init_params(args, seed=3)))
    cpu = _to(params, "cpu")
    g = torch.Generator().manual_seed(4)
    img = torch.randn((2, 3, size, size), generator=g)
    toks = torch.randint(0, 512, (2, 22), generator=g)
    n_img = sphinx.image_words(args)
    tg, tc = sphinx.encode_image(params, args, img.cuda()), sphinx.encode_image(cpu, args, img)
    assert tg.shape == tc.shape == (2, n_img, 256) and _rel_l2(tg, tc) < 1e-2
    s_len = n_img + 24
    cg = sphinx.init_kv_cache(args, 2, s_len)
    cc = sphinx.init_kv_cache(args, 2, s_len, device="cpu")
    lg, _ = sphinx.forward(params, args, toks[:, :16].cuda(), cache=cg, cur_pos=0,
                           embeds=sphinx.splice(params, toks[:, :16].cuda(), tg))
    lc, _ = sphinx.forward(cpu, args, toks[:, :16], cache=cc, cur_pos=0,
                           embeds=sphinx.splice(cpu, toks[:, :16], tc))
    assert lg.shape == (2, 16 + n_img, 512)
    pairs = [(lg, lc)]
    for p in range(16, 22):
        kernels.reset_launch_counts()
        lg, _ = sphinx.forward(params, args, toks[:, p:p + 1].cuda(), cache=cg, cur_pos=p + n_img)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["w4_matmul"] == 8 and counts["decode_attention_mha"] == 2
        assert sum(counts.values()) == 10
        lc, _ = sphinx.forward(cpu, args, toks[:, p:p + 1], cache=cc, cur_pos=p + n_img)
        pairs.append((lg, lc))
    for lg, lc in pairs:
        g_ = lg.cpu()
        assert _rel_l2(g_, lc) < 2e-2
        assert float((g_ - lc).abs().max()) < 2e-2 * float(lc.abs().max()) + 2e-2


# ---------------------------------------------------------------- compiled decode loops


class _ByteTok:
    bos_id, eos_id, n_words = 256, 257, 258

    def encode(self, s, bos, eos):
        return ([self.bos_id] if bos else []) + list(s.encode()) + ([self.eos_id] if eos else [])

    def decode(self, t):
        return bytes(x if x < 256 else 63 for x in t).decode("utf-8", errors="replace")

    def encode_segment(self, s):
        return self.encode(s.lstrip(" "), False, False)

    def encode_wo_prefix_space(self, s):
        return self.encode(s, False, False)


_GRAPH_PROMPTS = ["The quick brown fox jumps over the lazy dog", "Once upon a time",
                  "In the beginning", "Hello there, card"]


def _graph_family(family):
    """(module, args, W4 params) of a small model of each captured family."""
    from accessory_tpu_torch.config import FalconArgs, InternLMArgs, MixtralArgs
    from accessory_tpu_torch.models import falcon, internlm, mixtral

    if family in ("llama", "llama_stacked"):
        args = LLaMAArgs(dim=512, n_layers=2, n_heads=8, n_kv_heads=2, vocab_size=258,
                         multiple_of=256, max_seq_len=256)
        return llama, args, quantize_params(llama.init_params(args, seed=4))
    if family == "mixtral":
        args = MixtralArgs(dim=512, n_layers=2, n_heads=8, n_kv_heads=2, hidden_dim=512,
                           num_experts=8, vocab_size=258, max_seq_len=256)
        return mixtral, args, quantize_params(mixtral.init_params(args, seed=4))
    if family == "internlm":
        args = InternLMArgs(num_layers=2, hidden_size=512, num_attention_heads=8,
                            vocab_size=258, multiple_of=256, max_seq_len=256)
        return internlm, args, quantize_params(internlm.init_params(args, seed=4))
    args = FalconArgs(num_layers=2, hidden_size=512, num_attention_heads=8, num_kv_heads=2,
                      vocab_size=258, max_seq_len=256)
    return falcon, args, quantize_params(falcon.init_params(args, seed=4))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("family", ["llama", "llama_stacked", "mixtral", "internlm", "falcon"])
def test_decode_graph_matches_eager(gen, family, kv_dtype):
    """Generator.generate and stream_generate on the graph route (each
    decode step one CUDA graph replayed) against the eager route
    (compiled=False): greedy and seeded-sampled tokens identical, the launch
    counts equal, the graph route captured; twice, so the second run
    replays what the first captured."""
    import numpy as np

    from accessory_tpu_torch.engine.generate import Generator

    module, args, params = _graph_family(family)
    kw = dict(kv_dtype=kv_dtype, unroll_decode=family != "llama_stacked")
    runs = {}
    for compiled in (False, True):
        g = Generator(module, args, params, _ByteTok(), compiled=compiled, **kw)
        got = []
        for _ in range(2):
            kernels.reset_launch_counts()
            g.generate(_GRAPH_PROMPTS, max_gen_len=24, additional_stop_symbols=["e "])
            got.append((g.last_tokens, kernels.launch_counts()))
            g.generate(_GRAPH_PROMPTS, max_gen_len=24, temperature=0.9, seed=5)
            got.append((g.last_tokens, None))
        stream = [e["text"] for e in g.stream_generate(_GRAPH_PROMPTS[0], max_gen_len=16,
                                                       temperature=0.7, seed=2)]
        runs[compiled] = (got, stream, g.graphs)
    (eager, e_stream, _), (graph, g_stream, graphs) = runs[False], runs[True]
    assert graphs
    for (te, ce), (tg, cg) in zip(eager, graph):
        assert np.array_equal(te, tg)
        assert ce == cg
    assert e_stream == g_stream


def test_batcher_graph_matches_eager(gen):
    """ContinuousBatcher's decode dispatch replayed per (active_pages,
    n_steps) key against the eager route: greedy and sampled requests'
    tokens identical, launch counts equal."""
    from accessory_tpu_torch.engine.scheduler import ContinuousBatcher

    module, args, params = _graph_family("llama")
    out = {}
    for compiled in (False, True):
        cb = ContinuousBatcher(module, args, params, _ByteTok(), slots=4, page_size=16,
                               decode_steps=4, compiled=compiled, seed=9)
        kernels.reset_launch_counts()
        ids = [cb.add_request(p * 3, max_gen_len=40, temperature=0.8 * (i % 2))
               for i, p in enumerate(_GRAPH_PROMPTS * 2)]
        while cb.pending or any(r is not None for r in cb.active.values()):
            cb.step()
        by = {r.uid: r.output_tokens for r in cb.finished}
        out[compiled] = ([by[i] for i in ids], kernels.launch_counts(), cb.graphs,
                         len(cb._decode_graphs))
    assert out[True][2] and out[True][3] >= 1
    assert out[False][0] == out[True][0] and out[False][1] == out[True][1]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("r", [1, 4, 71])
def test_device_position_bits_equal_int(gen, int8, r):
    """Every static decode entry (fused and read-only) and every one-token
    write at a position on the card (0-d int32 and int64) gives the bits of
    the int position, at the first, a middle and the last position."""
    b, nkv, hd, s_len = 3, 2 if r < 71 else 1, 64 if r != 1 else 128, 200
    nq = nkv * r
    q, kn, vn = randn(gen, b, 1, nq, hd), randn(gen, b, 1, nkv, hd), randn(gen, b, 1, nkv, hd)
    if int8:
        pools = (torch.randint(-127, 128, (b, nkv, s_len, hd), generator=gen, device="cuda",
                               dtype=torch.int8),) * 2 + \
            (torch.rand(b, nkv, s_len, generator=gen, device="cuda") * 0.02,) * 2
        upd, ro, wr = decode_attention_update8, cached_attention_t8, write_kv_layer8
    else:
        pools = (randn(gen, b, nkv, s_len, hd), randn(gen, b, nkv, s_len, hd))
        upd, ro, wr = decode_attention_update, cached_attention_t, write_kv_layer
    for pos in (0, 77, s_len - 1):
        for dt in (torch.int32, torch.int64):
            pt = torch.tensor(pos, dtype=dt, device="cuda")
            a, c = [p.clone() for p in pools], [p.clone() for p in pools]
            assert torch.equal(upd(q, kn, vn, *a, pos)[0], upd(q, kn, vn, *c, pt)[0])
            assert all(torch.equal(x, y) for x, y in zip(a, c))
            assert torch.equal(ro(q, kn, vn, *pools, pos), ro(q, kn, vn, *pools, pt))
            a, c = [p.clone() for p in pools], [p.clone() for p in pools]
            wr(*a, kn, vn, pos)
            wr(*c, kn, vn, pt)
            assert all(torch.equal(x, y) for x, y in zip(a, c))
    lead = (3, b)
    kn5, vn5 = randn(gen, *lead, 1, nkv, hd), randn(gen, *lead, 1, nkv, hd)
    for fn, dt in ((write_kv_t, torch.bfloat16), (write_kv_t8, torch.int8)):
        if (dt == torch.int8) != int8:
            continue
        st = (torch.zeros(*lead, nkv, s_len, hd, dtype=dt, device="cuda"),) * 2 + \
            ((torch.zeros(*lead, nkv, s_len, device="cuda"),) * 2 if int8 else ())
        a, c = [p.clone() for p in st], [p.clone() for p in st]
        fn(*a, kn5, vn5, 150)
        fn(*c, kn5, vn5, torch.tensor(150, device="cuda"))
        assert all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("m", [1, 8, 16])
def test_gemv_gate(gen, m):
    """Row 1's GEMV with the gate set gives the ungated bits; cleared, zeros
    (also over a residual) whatever the output held, and the weight is not
    touched."""
    qw = _w4(gen, 1024, 768)
    x = randn(gen, m, 1024)
    args = (x, qw.packed, qw.scales, qw.zeros)
    on = torch.tensor(1, dtype=torch.int32, device="cuda")
    off = torch.tensor(0, dtype=torch.int32, device="cuda")
    before = qw.packed.clone()
    y = planes_qmm(*args, in_dim=1024, group_size=128)
    assert torch.equal(planes_qmm(*args, in_dim=1024, group_size=128, gate=on), y)
    z = planes_qmm(*args, in_dim=1024, group_size=128, gate=off,
                   residual=randn(gen, m, 768))
    torch.cuda.synchronize()
    assert not z.any() and torch.equal(qw.packed, before)


def test_capture_under_sync_debug_error(gen):
    """A captured step that reads a value on the host raises at capture (it
    runs under set_sync_debug_mode("error")) and leaves the card usable; a
    clean step captures and replays, its launches counted at each replay."""
    from accessory_tpu_torch.engine.graphs import GraphPool, StepGraph

    x = torch.ones(64, device="cuda")
    with pytest.raises(RuntimeError):
        StepGraph(lambda: float(x.sum()), GraphPool())
    assert float((x * 3).sum()) == 192.0
    qw = _w4(gen, 256, 256)
    a = randn(gen, 4, 256)
    planes_qmm(a, qw.packed, qw.scales, qw.zeros, in_dim=256, group_size=128)
    g = StepGraph(lambda: planes_qmm(a, qw.packed, qw.scales, qw.zeros, in_dim=256,
                                     group_size=128), GraphPool())
    assert g.launches == {"w4_matmul": 1}
    kernels.reset_launch_counts()
    for _ in range(3):
        out = g.replay()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["w4_matmul"] == 3
    assert torch.equal(out, planes_qmm(a, qw.packed, qw.scales, qw.zeros, in_dim=256,
                                       group_size=128))
