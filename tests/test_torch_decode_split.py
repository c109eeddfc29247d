"""The split decode kernels (csrc/decode_split.cuh: the static GQA decode
attention and the paged decode attention) on the CPU: their launch plans
(``ops.decode_attention.decode_plan``, ``ops.paged_decode.paged_plan``), the C
calls the wrappers make (one argument per ctypes type, as many as the C entry
in ``csrc/`` declares, the plan's split among them), and a torch model of the
kernels' split-and-merge arithmetic held against the JAX package.

The model, kept here and never on a path, does what a cluster of ``split``
ranks does: rank r folds the 64-token chunks [nc * r // split, nc * (r + 1) //
split) of the nc = ceil(n / 64) chunks into its own online softmax (f32
scores, int8: times the token's k scale and the softmax scale; P rounded to
bf16 against the rank's running max, int8: p times the v scale first), the
ranks merge in rank order, each rescaled by exp(m_rank - m) in f32, then the
new tokens' exact f32 term joins (row t sees new tokens t' <= t); a (batch
row, kv head) whose query rows pass a tile (64 at head_dim 64, 32 at 128)
is cut into tiles, each folded over every token on its own (Falcon-7B's 71
query heads over one kv head: 64 + 7). It is held
against the JAX kernels as the JAX package's own tests run them on the CPU:
``_decode_attn_bloop_w`` / ``_decode_attn_bloop_w8`` and ``_paged_decode`` /
``_paged_decode8`` in interpret mode, and the bundled paged kernel's XLA
oracle ``paged_attention_xla``; numpy inputs from a seed, bf16 and int8 caches,
R 71, 8, 4 and 1, SQ 1 and 5, at the plan's split and at 8 ranks (ranks with no
chunk at all).

Tolerance: the one the card holds the kernels to (chip_smoke.py's decode
rows): 4 bf16 ulps of the largest output plus 1% elementwise, and a relative
L2 error of at most 1e-2. The kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.engine import kvcache as jkv
from accessory_tpu.ops import decode_attention as jda
from accessory_tpu.ops.paged_decode import paged_decode_attention as jpaged_decode

from accessory_tpu_torch import kernels
from accessory_tpu_torch.ops import decode_attention as tda
from accessory_tpu_torch.ops import paged_decode as tpd

from test_torch_bigm_flash import c_signature
from test_torch_paged import _chunk, _pool

CHUNK = 64


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def assert_card_close(got, want):
    """chip_smoke.py's check_close at the decode rows' tolerance."""
    g = torch.as_tensor(np.array(got, np.float32))
    w = torch.as_tensor(np.array(want, np.float32))
    atol = 4 * bf16_ulp(float(w.abs().max()))
    bad = (g - w).abs() > atol + 1e-2 * w.abs()
    l2 = float((g - w).norm() / w.norm().clamp_min(1e-30))
    assert torch.isfinite(g).all()
    assert not bool(bad.any()), f"{int(bad.sum())} elements beyond atol {atol} + 1%"
    assert l2 <= 1e-2, f"relative L2 {l2}"


# ---------------------------------------------------------------- the plans


def assert_covers(plan, n):
    """Every cached token < n in exactly one rank's range, in rank order."""
    ranges = [plan.rank_range(n, r) for r in range(plan.split)]
    nxt = 0
    for lo, hi in ranges:
        assert lo <= hi
        if hi > lo:
            assert lo == nxt and lo % CHUNK == 0
            nxt = hi
    assert nxt == n
    # every rank but one holding the sequence's ragged end takes whole chunks
    assert sum(hi - lo for lo, hi in ranges) == n


def _edges(split, total):
    """0, 1, the chunk edges and each rank's first token at the longest
    sequence, and the longest itself."""
    nc = -(-total // CHUNK)
    firsts = {CHUNK * (nc * r // split) for r in range(split)}
    out = {0, 1, CHUNK - 1, CHUNK, CHUNK + 1, total - 1, total}
    out |= {f for f in firsts} | {f + 1 for f in firsts} | {max(0, f - 1) for f in firsts}
    return sorted(x for x in out if 0 <= x <= total)


def assert_tiles_cover(r, hd):
    """The kernel's row tiles (csrc/decode_attention.cu: tiles of
    min(r, TILE_ROWS[hd]) rows, rows row0 .. row0 + nrows of tile t) give
    every query row of a group exactly one tile."""
    ntiles, rows = tda.row_tiles(r, hd), min(r, tda.TILE_ROWS[hd])
    seen = [m for t in range(ntiles) for m in range(t * rows, min(r, (t + 1) * rows))]
    assert seen == list(range(r))
    assert ntiles == -(-r // tda.TILE_ROWS[hd])


@pytest.mark.parametrize("b,nkv,s_len,r,hd", [
    (8, 4, 1024, 8, 64), (4, 4, 192, 8, 64), (1, 4, 192, 8, 64), (8, 8, 1024, 4, 128),
    (8, 4, 1000, 8, 64), (2, 2, 64, 8, 64), (1, 1, 4096, 8, 64), (64, 8, 2048, 16, 64),
    (8, 1, 1024, 71, 64), (8, 1, 192, 71, 64), (8, 1, 1024, 128, 64), (8, 2, 1024, 40, 128)])
def test_decode_plan_covers_every_token_once(b, nkv, s_len, r, hd):
    """At every pos 0..S the tested edges give each cached token one rank, and
    the row tiles each query row one tile: every (row, token) once; the split
    is 1-8 and never more than the cache's chunks; a cluster a (batch row,
    kv head, tile)."""
    plan = tda.decode_plan(b, nkv, s_len, r, hd)
    assert 1 <= plan.split <= 8 and plan.split <= -(-s_len // CHUNK)
    assert plan.blocks == plan.split * b * nkv * tda.row_tiles(r, hd)
    assert_tiles_cover(r, hd)
    for pos in _edges(plan.split, s_len):
        assert_covers(plan, pos)


@pytest.mark.parametrize("rows,hd", [(8, 64), (40, 64), (128, 64), (1, 128), (4, 128),
                                     (48, 128)])
@pytest.mark.parametrize("j,ps", [(8, 64), (16, 64), (4, 128), (6, 16), (3, 48), (1, 1)])
def test_paged_plan_covers_every_token_once(rows, hd, j, ps):
    """At lengths 0, 1, a chunk edge, a rank's first token and J * PS (a length
    past it reads J * PS tokens) each token of the active pages has one rank."""
    plan = tpd.paged_plan(8, 4, rows, hd, j, ps)
    assert 1 <= plan.split <= 8 and plan.split <= -(-j * ps // CHUNK)
    assert plan.blocks == plan.split * 8 * 4 * -(-rows // tda.TILE_ROWS[hd])
    for n in _edges(plan.split, j * ps) + [j * ps + 100]:
        assert_covers(plan, min(n, j * ps))


def test_paged_plan_reads_j_times_ps_alone():
    """The plan takes no length: the same J * PS gives the same launch."""
    assert "length" not in " ".join(inspect.signature(tpd.paged_plan).parameters)
    for rows, hd in ((8, 64), (40, 64), (1, 128)):
        plans = {tpd.paged_plan(8, 4, rows, hd, j, ps)
                 for j, ps in ((16, 64), (8, 128), (64, 16))}
        assert len(plans) == 1
    assert "pos" not in inspect.signature(tda.decode_plan).parameters


def test_plans_at_the_paths_shapes():
    """The launches of the decode paths' shapes: 128-264 blocks for
    TinyLlama's 8 x 4 (kv head, row) pairs, static and paged, and at least
    132 for 7B's one query head a kv head (256 pairs, split 1). Falcon-7B's
    B 8 x one kv head x two row tiles: 16 clusters, so the split over the
    tokens fills the card at S 1024 (8 ranks, 128 blocks); at S 192 the
    cache has 3 chunks, one a rank (48 blocks)."""
    for plan in (tda.decode_plan(8, 4, 1024, 8, 64), tpd.paged_plan(8, 4, 8, 64, 8, 64),
                 tpd.paged_plan(8, 4, 40, 64, 8, 64), tpd.paged_plan(8, 4, 8, 64, 16, 64),
                 tda.decode_plan(8, 8, 1024, 4, 128), tda.decode_plan(8, 1, 1024, 71, 64)):
        assert 128 <= plan.blocks <= 264 and plan.split > 1
    assert tda.decode_plan(8, 1, 1024, 71, 64) == tda.SplitPlan(8, 128)
    assert tda.decode_plan(8, 1, 192, 71, 64) == tda.SplitPlan(3, 48)
    seven = tpd.paged_plan(8, 32, 1, 128, 8, 64)
    assert seven.split == 1 and seven.blocks >= 132
    assert tpd.paged_plan(8, 32, 1, 128, 16, 64).blocks >= 132


# ---------------------------------------------------------------- the C calls


def _capture(monkeypatch):
    seen = {}

    def function(lib, sym, argtypes):
        def fake(*args):
            seen.update(lib=lib, sym=sym, args=args, argtypes=list(argtypes))
            return 0
        return fake

    monkeypatch.setattr(kernels, "function", function)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 0)
    return seen


@pytest.mark.parametrize("nq,nkv,split", [(32, 4, 4), (71, 1, 8)])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("write", [False, True])
def test_decode_kernel_call_abi(monkeypatch, int8, write, nq, nkv, split):
    """The GQA entries' C calls: the parameter list csrc/decode_attention.cu
    declares, the dims (R, from which the entry cuts its row tiles as
    decode_plan counts them), the position (an int, with no position on the
    card: pos_dev null) and decode_plan's split."""
    seen = _capture(monkeypatch)
    b, hd, s_len, pos = 8, 64, 1024, 511
    q = torch.zeros(b, 1, nq, hd, dtype=torch.bfloat16)
    kn = torch.zeros(b, 1, nkv, hd, dtype=torch.bfloat16)
    if int8:
        pools = (torch.zeros(b, nkv, s_len, hd, dtype=torch.int8),) * 2 \
            + (torch.zeros(b, nkv, s_len),) * 2
    else:
        pools = (torch.zeros(b, nkv, s_len, hd, dtype=torch.bfloat16),) * 2
    tda._decode_kernel("t", q, kn, kn, pools, pos, write=write)
    sym = "decode_attention" + ("8" if int8 else "") + ("" if write else "_ro")
    assert seen["lib"] == "decode_attention" and seen["sym"] == sym
    assert seen["argtypes"] == c_signature("decode_attention", sym)
    assert len(seen["args"]) == len(seen["argtypes"])
    dims = seen["args"][-11:-3]
    assert dims == (b, nkv, s_len, nq // nkv, hd, pos, None,
                    tda.decode_plan(b, nkv, s_len, nq // nkv, hd).split)
    assert dims[-1] == split


def test_decode_kernel_refuses_past_the_grid(monkeypatch):
    """Any R the launch's z (batch rows x row tiles) holds is taken; past it
    the wrapper raises, as the C entry would, and never falls back."""
    seen = _capture(monkeypatch)
    b, nq, hd, s_len = 8, 71, 64, 256
    q = torch.zeros(b, 1, nq, hd, dtype=torch.bfloat16)
    kn = torch.zeros(b, 1, 1, hd, dtype=torch.bfloat16)
    pools = (torch.zeros(b, 1, s_len, hd, dtype=torch.bfloat16),) * 2
    assert tda.MAX_GRID_Z == 65535
    monkeypatch.setattr(tda, "MAX_GRID_Z", b * 2)
    tda._decode_kernel("t", q, kn, kn, pools, 5, write=True)
    assert seen["args"][-11:-3] == (b, 1, s_len, nq, hd, 5, None, 4)
    monkeypatch.setattr(tda, "MAX_GRID_Z", b * 2 - 1)
    seen.clear()
    with pytest.raises(ValueError, match="ceil"):
        tda._decode_kernel("t", q, kn, kn, pools, 5, write=True)
    assert not seen


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("sq,r,hd", [(1, 8, 64), (5, 8, 64), (1, 1, 128)])
def test_paged_kernel_call_abi(monkeypatch, int8, sq, r, hd):
    """paged_decode / paged_decode8: the declared parameters and paged_plan's
    split from J * PS (the lengths are a device tensor, never read here)."""
    seen = _capture(monkeypatch)
    b, nkv, n_pages, ps, pps, j = 8, 4, 65, 64, 8, 6
    q = torch.zeros(b, sq, nkv * r, hd, dtype=torch.bfloat16)
    kn = torch.zeros(b, sq, nkv, hd, dtype=torch.bfloat16)
    dt = torch.int8 if int8 else torch.bfloat16
    pools = (torch.zeros(nkv, n_pages, ps, hd, dtype=dt),) * 2 \
        + ((torch.zeros(nkv, n_pages, ps),) * 2 if int8 else ())
    lens = torch.zeros(b, dtype=torch.int32)
    table = torch.zeros(b, pps, dtype=torch.int32)
    name = "paged_decode8" if int8 else "paged_decode"
    out = torch.empty_like(q)
    assert tpd._paged_call(name, q, kn, kn, pools, lens, table, j, out) == 0
    assert seen["sym"] == name and seen["argtypes"] == c_signature("paged_decode", name)
    assert len(seen["args"]) == len(seen["argtypes"])
    assert seen["args"][-13:-3] == (pps, j, b, nkv, n_pages, ps, sq, r, hd,
                                    tpd.paged_plan(b, nkv, sq * r, hd, j, ps).split)


def test_paged_ro_kernel_call_abi(monkeypatch):
    seen = _capture(monkeypatch)
    b, nkv, r, hd, n_pages, ps, pps = 8, 4, 8, 64, 129, 64, 16
    q = torch.zeros(b, nkv * r, hd, dtype=torch.bfloat16)
    pool = torch.zeros(nkv, n_pages, ps, hd, dtype=torch.bfloat16)
    lens = torch.zeros(b, dtype=torch.int32)
    table = torch.zeros(b, pps, dtype=torch.int32)
    assert tpd._paged_ro_call(q, pool, pool, lens, table, torch.empty_like(q)) == 0
    assert seen["argtypes"] == c_signature("paged_decode", "paged_decode_ro")
    assert len(seen["args"]) == len(seen["argtypes"])
    assert seen["args"][-12:-3] == (pps, pps, b, nkv, n_pages, ps, r, hd,
                                    tpd.paged_plan(b, nkv, r, hd, pps, ps).split)
    assert seen["args"][-4] == 8


# ---------------------------------------------------------------- the split-and-merge model


def split_model(q, K, V, n, split, scale, ks=None, vs=None, kn=None, vn=None, row_t=None):
    """One (batch row, kv head): q (rows, hd), K / V (>= n, hd), ks / vs (>= n,)
    int8 scales or None, kn / vn (sq, hd) the new tokens or None, row_t the
    new token of each row; all f32 holding bf16 (or int8) values. Returns the
    (rows, hd) f32 output before its bf16 rounding; rows with nothing to
    attend to get zeros."""
    rows, hd = q.shape
    nc = -(-n // CHUNK)
    ms, ls, accs = [], [], []
    for rank in range(split):
        m = torch.full((rows,), -1e30)
        l = torch.zeros(rows)
        acc = torch.zeros(rows, hd)
        for c in range(nc * rank // split, nc * (rank + 1) // split):
            t0, t1 = CHUNK * c, min(n, CHUNK * c + CHUNK)
            s = q @ K[t0:t1].T
            s = s * (ks[t0:t1] * scale if ks is not None else scale)
            m_new = torch.maximum(m, s.amax(1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[:, None])
            l = l * corr + p.sum(1)
            pv = p * vs[t0:t1] if vs is not None else p
            acc = acc * corr[:, None] + pv.to(torch.bfloat16).float() @ V[t0:t1]
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    mx = torch.stack(ms).amax(0)
    if kn is not None:
        s_new = (q @ kn.T) * scale
        seen = torch.arange(kn.shape[0])[None, :] <= row_t[:, None]
        s_new = torch.where(seen, s_new, torch.full_like(s_new, -1e30))
        mx = torch.maximum(mx, s_new.amax(1))
    out = torch.zeros(rows, hd)
    L = torch.zeros(rows)
    for m, l, acc in zip(ms, ls, accs):   # rank order
        w = torch.exp(m - mx)
        L = L + w * l
        out = out + w[:, None] * acc
    if kn is not None:
        pn = torch.where(seen, torch.exp(s_new - mx[:, None]), torch.zeros_like(s_new))
        L = L + pn.sum(1)
        out = out + pn @ vn
    return torch.where(L[:, None] > 0, out / L.clamp_min(1e-30)[:, None], torch.zeros_like(out))


def _bf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float()


def tiled_model(q, K, V, n, split, scale, ks, vs, kn, vn, row_t, hd):
    """``split_model`` over a group's query rows as the static entries cut
    them: tiles of min(rows, TILE_ROWS[hd]) rows, each folded over every
    token on its own (the same ranks and merge), concatenated in row order."""
    rows = min(q.shape[0], tda.TILE_ROWS[hd])
    tiles = [slice(t * rows, (t + 1) * rows) for t in range(tda.row_tiles(q.shape[0], hd))]
    return torch.cat([split_model(q[t], K, V, n, split, scale, ks, vs, kn, vn, row_t[t])
                      for t in tiles])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("r,hd,pos", [(8, 64, 200), (4, 128, 255), (8, 64, 65), (71, 64, 200)])
def test_static_split_model_vs_jax_kernel(int8, r, hd, pos):
    """The model at decode_plan's split and at 8 ranks against the JAX fused
    kernel (_kernel_bloop_w / _kernel_bloop_w8, interpret mode) on the same
    cache: pos over several chunks and ranks, some ranks with no chunk; R 71
    (Falcon-7B's group: a tile of 64 rows and one of 7)."""
    b, nkv, s_len = 2, 2, 256
    rng = np.random.RandomState(pos + r + int8)
    q = _bf(rng.standard_normal((b, nkv, r, hd)))
    kn, vn = _bf(rng.standard_normal((b, nkv, 1, hd))), _bf(rng.standard_normal((b, nkv, 1, hd)))
    lens = jnp.full((b,), pos, jnp.int32)
    jq, jkn, jvn = (jnp.asarray(t.numpy(), jnp.bfloat16) for t in (q, kn, vn))
    if int8:   # the JAX cache is lane-major (b, nkv, hd, S)
        ck = rng.randint(-127, 128, (b, nkv, hd, s_len)).astype(np.int8)
        cv = rng.randint(-127, 128, (b, nkv, hd, s_len)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (b, nkv, s_len)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (b, nkv, s_len)).astype(np.float32)
        want = jda._decode_attn_bloop_w8(jq, jkn, jvn, jnp.asarray(ck), jnp.asarray(cv),
                                         jnp.asarray(ks), jnp.asarray(vs), lens, pos, b_blk=2,
                                         interpret=True)[0]
        K = torch.from_numpy(ck.transpose(0, 1, 3, 2).astype(np.float32))
        V = torch.from_numpy(cv.transpose(0, 1, 3, 2).astype(np.float32))
        KS, VS = torch.from_numpy(ks), torch.from_numpy(vs)
    else:
        ck = _bf(rng.standard_normal((b, nkv, hd, s_len)))
        cv = _bf(rng.standard_normal((b, nkv, hd, s_len)))
        want = jda._decode_attn_bloop_w(jq, jkn, jvn, jnp.asarray(ck.numpy(), jnp.bfloat16),
                                        jnp.asarray(cv.numpy(), jnp.bfloat16), lens, pos,
                                        b_blk=2, interpret=True)[0]
        K, V = ck.transpose(2, 3), cv.transpose(2, 3)
        KS = VS = None
    want = np.asarray(want.astype(jnp.float32))        # (b, nkv, r, hd)
    plan = tda.decode_plan(b, nkv, s_len, r, hd)
    assert plan.split == 4
    for split in (plan.split, 8):
        got = torch.stack([torch.stack([
            tiled_model(q[i, h], K[i, h], V[i, h], pos, split, hd ** -0.5,
                        *((KS[i, h], VS[i, h]) if int8 else (None, None)),
                        kn[i, h], vn[i, h], torch.zeros(r, dtype=torch.int64), hd)
            for h in range(nkv)]) for i in range(b)])
        assert_card_close(got.to(torch.bfloat16).float(), want)


def _slot_tokens(pages, table, n, ps):
    """Slot's first n tokens (n, ...) of one kv head's pool (P, ps, ...)."""
    idx = torch.arange(n)
    return pages[table[idx // ps].long(), idx % ps]


@pytest.mark.parametrize("name,hd,r,sq,int8", [
    ("gqa-decode", 64, 8, 1, False),
    ("gqa-verify-int8", 64, 8, 5, True),
    ("mha-decode", 128, 1, 1, False),
    ("mha-verify-int8", 128, 1, 5, True),
])
def test_paged_split_model_vs_jax_kernel(name, hd, r, sq, int8):
    """The model at paged_plan's split and at 8 ranks against the JAX paged
    kernel (_paged_kernel / _paged_kernel8, interpret mode, stacked pools and
    a layer index): lengths 0, a page edge, several chunks and ranks, a
    shuffled table whose free entries are TRASH."""
    nkv, ps, pps, layer = 2, 16, 12, 1
    lengths = [0, 16, 77, 150, 192]
    b = len(lengths)
    jc, tc = _pool(b, nkv, hd, ps, pps, lengths, "bfloat16", int8, n_layers=2, seed=hd + sq)
    rng = np.random.RandomState(hd * sq + r)
    (jq, tq), (jk, tk), (jv, tv) = _chunk(rng, b, sq, nkv, r, hd, "bfloat16")
    want = jpaged_decode(jq, jk, jv, jc.k_pages, jc.v_pages, jc.lengths, jc.page_indices, None,
                         jc.ks_pages, jc.vs_pages, layer=layer, interpret=True)
    want = np.asarray(want.astype(jnp.float32))        # (b, sq, nq, hd)
    kp, vp = tc.k_pages[layer].float(), tc.v_pages[layer].float()
    ksp, vsp = (tc.ks_pages[layer], tc.vs_pages[layer]) if int8 else (None, None)
    plan = tpd.paged_plan(b, nkv, sq * r, hd, pps, ps)
    assert plan.split > 1
    row_t = torch.arange(sq * r) // r
    for split in (plan.split, 8):
        got = torch.zeros(b, sq, nkv * r, hd)
        for i, n in enumerate(lengths):
            table = tc.page_indices[i]
            for h in range(nkv):
                K, V = _slot_tokens(kp[h], table, n, ps), _slot_tokens(vp[h], table, n, ps)
                sc = (_slot_tokens(ksp[h], table, n, ps), _slot_tokens(vsp[h], table, n, ps)) \
                    if int8 else (None, None)
                qr = tq[i, :, h * r:(h + 1) * r].float().reshape(sq * r, hd)
                o = split_model(qr, K, V, n, split, hd ** -0.5, *sc, tk[i, :, h].float(),
                                tv[i, :, h].float(), row_t)
                got[i, :, h * r:(h + 1) * r] = o.reshape(sq, r, hd)
        assert_card_close(got.to(torch.bfloat16).float(), want)


def test_bundled_split_model_vs_jax_oracle():
    """The read-only form (no new tokens; the k / v of the query token already
    in the pools, its length counting it) against the bundled kernel's XLA
    oracle paged_attention_xla on the port's token-major pools; a zero-length
    slot gets zeros."""
    nkv, r, hd, ps, pps = 2, 8, 64, 16, 16
    lengths = [1, 63, 64, 65, 130, 256]
    b = len(lengths)
    jc, tc = _pool(b, nkv, hd, ps, pps, lengths, "bfloat16", False, seed=5)
    rng = np.random.RandomState(11)
    q = _bf(rng.standard_normal((b, nkv * r, hd)))
    want = np.asarray(jkv.paged_attention_xla(
        jnp.asarray(q.numpy(), jnp.bfloat16), jnp.asarray(tc.k_pages[0].float().numpy(),
                                                           jnp.bfloat16),
        jnp.asarray(tc.v_pages[0].float().numpy(), jnp.bfloat16), jc.lengths,
        jc.page_indices).astype(jnp.float32))
    plan = tpd.paged_plan(b, nkv, r, hd, pps, ps)
    assert plan.split == 4
    for split in (plan.split, 8):
        got = torch.zeros(b, nkv * r, hd)
        for i, n in enumerate(lengths):
            for h in range(nkv):
                K = _slot_tokens(tc.k_pages[0, h].float(), tc.page_indices[i], n, ps)
                V = _slot_tokens(tc.v_pages[0, h].float(), tc.page_indices[i], n, ps)
                got[i, h * r:(h + 1) * r] = split_model(q[i, h * r:(h + 1) * r], K, V, n, split,
                                                        hd ** -0.5)
        assert_card_close(got.to(torch.bfloat16).float(), want)
    empty = split_model(q[0, :r], torch.zeros(0, hd), torch.zeros(0, hd), 0, 4, hd ** -0.5)
    assert float(empty.abs().max()) == 0.0
