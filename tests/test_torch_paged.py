"""Port parity, the paged KV cache's ops: paged decode attention (bf16 / f32
and int8 pools), the paged writes, the pool conversion, ``cached_attention``,
``sample_token_batched`` and the page allocator. Each plain PyTorch version
(the path a CPU tensor takes through the kernel wrapper) runs against the JAX
entry on the same numpy inputs, the JAX Pallas kernels in interpret mode as
the JAX package's own tests run them, and against its XLA oracle
(``gather_pages`` + ``cached_attention``). The JAX pools are fold-stored and
cross over through ``convert.paged_cache_from_jax``. CPU only.

Tolerances: f32 outputs 2e-5 (sums in another order); bf16 outputs 1.6e-2,
the bound tests/test_torch_static_cache.py holds the static kernels to (p is
rounded to bf16 relative to another running max); int8 pools against the JAX
int8 kernel 2e-3 (f32) / 4e-3 (bf16) as there, and against the oracle, which
dequantizes k and v to bf16 before the product, 2e-2 (the bound of the JAX
package's own test_paged_decode_kernel.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.engine import kvcache as jkv
from accessory_tpu.ops.attention import cached_attention as jcached_attention
from accessory_tpu.ops import sampling as jsampling
from accessory_tpu.ops.paged_decode import paged_decode_attention as jpaged_decode
from accessory_tpu.ops.paged_write import paged_write_tokens as jpaged_write

from accessory_tpu_torch.convert import paged_cache_from_jax
from accessory_tpu_torch.engine import kvcache as tkv
from accessory_tpu_torch.ops import attention as tatt
from accessory_tpu_torch.ops import sampling as tsampling
from accessory_tpu_torch.ops.paged_decode import paged_decode_attention_plain

from test_torch_ops import both, f32

ATOL = {"float32": 2e-5, "bfloat16": 1.6e-2}
INT8_ATOL = {"float32": 2e-3, "bfloat16": 4e-3}
ORACLE_INT8_ATOL = 2e-2


def _np_cache(pc) -> dict:
    """A JAX PagedKVCache's fields as numpy (what paged_cache_from_jax reads)."""
    out = {f: None if getattr(pc, f) is None else np.asarray(getattr(pc, f))
           for f in ("k_pages", "v_pages", "page_indices", "lengths", "ks_pages", "vs_pages")}
    out["head_dim"] = pc.head_dim
    return out


def _pool(b, nkv, hd, ps, pps, lengths, dtype, int8, shuffle=True, share=False, seed=0,
          n_layers=1):
    """A JAX pool written with random tokens through its own XLA write, a
    (shuffled, optionally prefix-sharing) page table and the lengths; and the
    port's copy of it. Slot rows past the written pages point at TRASH."""
    rng = np.random.RandomState(seed)
    total = b * pps + 3
    jc = jkv.init_paged_cache(n_layers, nkv, hd, total, ps, b, pps,
                              dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16,
                              kv_dtype="int8" if int8 else None)
    if shuffle:
        pt = rng.permutation(np.arange(1, total))[:b * pps].reshape(b, pps).astype(np.int32)
    else:
        pt = np.asarray(jc.page_indices)
    smax = max(1, int(max(lengths)))
    if share:
        pt[:, 0] = pt[0, 0]          # every slot's first page is the same physical page
    kn, vn = (both(rng.standard_normal((n_layers, b, smax, nkv, hd)), dtype)[0]
              for _ in range(2))
    res = jkv.write_tokens_all_layers(jc.k_pages, jc.v_pages, kn, vn, jnp.asarray(pt),
                                      jnp.zeros((b,), jnp.int32), jc.ks_pages, jc.vs_pages)
    used = -(-np.asarray(lengths) // ps)
    for i in range(b):
        pt[i, max(int(used[i]), 1 if share else 0):] = 0     # TRASH past the allocation
    fields = dict(k_pages=res[0], v_pages=res[1], page_indices=jnp.asarray(pt),
                  lengths=jnp.asarray(lengths, jnp.int32))
    if int8:
        fields.update(ks_pages=res[2], vs_pages=res[3])
    jc = jkv.PagedKVCache(**fields, head_dim=hd)
    return jc, paged_cache_from_jax(_np_cache(jc), device="cpu")


def _chunk(rng, b, sq, nkv, r, hd, dtype):
    return [both(rng.standard_normal(shape), dtype)
            for shape in ((b, sq, nkv * r, hd), (b, sq, nkv, hd), (b, sq, nkv, hd))]


CASES = [  # (hd, r, ps, lengths): GQA at head_dim 64 (fold 2 on the JAX side), MHA at 128
    (64, 8, 16, [0, 1, 15, 16, 17, 64]),
    (128, 1, 16, [33, 0, 16, 63]),
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 5, 16])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_paged_decode_plain_vs_oracle(case, sq, dtype, int8):
    """paged_decode_attention_plain against the JAX XLA oracle (gather_pages +
    cached_attention) on the same pool: sq 1 / 5 / 16, page-edge and zero
    lengths, a shuffled table, all four pages and an active_pages slice."""
    hd, r, ps, lengths = CASES[case]
    nkv, pps = 2, 4
    b = len(lengths)
    jc, tc = _pool(b, nkv, hd, ps, pps, lengths, dtype, int8, seed=case)
    rng = np.random.RandomState(sq + 10 * case)
    (jq, tq), (jk, tk), (jv, tv) = _chunk(rng, b, sq, nkv, r, hd, dtype)
    lay = (lambda p: None if p is None else p[0])
    for active in (None, pps):
        kd, vd = jkv.gather_pages(lay(jc.k_pages), lay(jc.v_pages), jc.page_indices, active,
                                  lay(jc.ks_pages), lay(jc.vs_pages), head_dim=hd)
        want = jcached_attention(jq, jk, jv, kd, vd, jc.lengths)
        got = paged_decode_attention_plain(tq, tk, tv, tc.k_pages, tc.v_pages, tc.lengths,
                                           tc.page_indices, active, tc.ks_pages, tc.vs_pages,
                                           layer=0)
        assert got.shape == (b, sq, nkv * r, hd) and got.dtype == tq.dtype
        atol = ORACLE_INT8_ATOL if int8 else ATOL[dtype]
        np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=atol)


@pytest.mark.parametrize("name,hd,r,sq,dtype,int8,share", [
    ("gqa-decode", 64, 8, 1, "bfloat16", False, False),
    ("gqa-verify-int8", 64, 8, 5, "bfloat16", True, False),
    ("mha-f32-shared", 128, 1, 1, "float32", False, True),
    ("mha-chunk16-int8", 128, 1, 16, "float32", True, False),
])
def test_paged_decode_plain_vs_pallas_interpret(name, hd, r, sq, dtype, int8, share):
    """paged_decode_attention_plain against the JAX Pallas kernel itself
    (_paged_kernel / _paged_kernel8 in interpret mode), stacked pools with the
    layer index, a zero-length slot, page edges and (mha-f32-shared) slots
    reading one shared physical page."""
    nkv, ps, pps, n_layers, layer = 2, 16, 4, 2, 1
    lengths = [10, 10, 10] if share else [0, 16, 17, 40]
    b = len(lengths)
    jc, tc = _pool(b, nkv, hd, ps, pps, lengths, dtype, int8, share=share, n_layers=n_layers)
    rng = np.random.RandomState(hd + sq)
    (jq, tq), (jk, tk), (jv, tv) = _chunk(rng, b, sq, nkv, r, hd, dtype)
    want = jpaged_decode(jq, jk, jv, jc.k_pages, jc.v_pages, jc.lengths, jc.page_indices, 3,
                         jc.ks_pages, jc.vs_pages, layer=layer, interpret=True)
    got = paged_decode_attention_plain(tq, tk, tv, tc.k_pages, tc.v_pages, tc.lengths,
                                       tc.page_indices, 3, tc.ks_pages, tc.vs_pages, layer=layer)
    if int8:   # and two bf16 rounding steps of an output above 1 (2^-7 relative)
        np.testing.assert_allclose(f32(got), f32(want), rtol=2 ** -7 if dtype == "bfloat16"
                                   else 0, atol=INT8_ATOL[dtype])
    else:
        np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=ATOL[dtype])


def test_paged_decode_empty_slot_is_its_new_token():
    """A slot with nothing cached attends only to its new token: the output
    is v_new on every query head of the group (the finite -1e30 mask makes
    the TRASH page's junk vanish, never NaN)."""
    jc, tc = _pool(2, 2, 64, 16, 4, [0, 20], "float32", False)
    rng = np.random.RandomState(3)
    (_, tq), (_, tk), (_, tv) = _chunk(rng, 2, 1, 2, 4, 64, "float32")
    tc.k_pages[:, :, 0] = 1e4      # loud junk in the TRASH page
    out = paged_decode_attention_plain(tq, tk, tv, tc.k_pages, tc.v_pages, tc.lengths,
                                       tc.page_indices, layer=0)
    want = tv[0, 0].repeat_interleave(4, dim=0)
    np.testing.assert_allclose(out[0, 0].numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert torch.isfinite(out).all()


def test_paged_cache_from_jax_gathers_the_same_tokens():
    """The converted pools hold every slot's tokens where the JAX pools do:
    gather_pages of both packages agree exactly, bf16 and int8 (scales
    included, through the dequantizing gather)."""
    for int8 in (False, True):
        jc, tc = _pool(3, 2, 64, 16, 4, [5, 33, 64], "bfloat16", int8)
        assert tc.k_pages.shape == (1, 2, 15, 16, 64) and tc.page_size == 16
        assert tc.pages_per_seq == 4 and tc.lengths.dtype == torch.int32
        lay = (lambda p: None if p is None else p[0])
        jk, jv = jkv.gather_pages(lay(jc.k_pages), lay(jc.v_pages), jc.page_indices,
                                  ks_pages=lay(jc.ks_pages), vs_pages=lay(jc.vs_pages), head_dim=64)
        tk, tv = tkv.gather_pages(lay(tc.k_pages), lay(tc.v_pages), tc.page_indices,
                                  ks_pages=lay(tc.ks_pages), vs_pages=lay(tc.vs_pages))
        np.testing.assert_array_equal(f32(tk), f32(jk))
        np.testing.assert_array_equal(f32(tv), f32(jv))


def test_paged_attention_oracle_and_dispatch():
    """paged_attention_xla (new token already written) against the JAX
    oracle; paged_cached_attention takes the kernel form up to 16 new tokens
    and the gather + cached_attention route above, both equal to JAX's."""
    jc, tc = _pool(2, 2, 64, 16, 4, [9, 30], "float32", False)
    rng = np.random.RandomState(5)
    jq, tq = both(rng.standard_normal((2, 8, 64)), "float32")
    # the JAX oracle reads unfolded (n_kv, P, ps, hd) pools: the port's layout
    want = jkv.paged_attention_xla(jq, jnp.asarray(tc.k_pages[0].numpy()),
                                   jnp.asarray(tc.v_pages[0].numpy()), jc.lengths,
                                   jc.page_indices)
    got = tkv.paged_attention_xla(tq, tc.k_pages[0], tc.v_pages[0], tc.lengths, tc.page_indices)
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=2e-5)
    for sq in (3, 20):
        (jq, tq), (jk, tk), (jv, tv) = _chunk(rng, 2, sq, 2, 4, 64, "float32")
        kd, vd = jkv.gather_pages(jc.k_pages[0], jc.v_pages[0], jc.page_indices, head_dim=64)
        want = jcached_attention(jq, jk, jv, kd, vd, jc.lengths)
        got = tkv.paged_cached_attention(tq, tk, tv, tc.k_pages, tc.v_pages, tc.lengths,
                                         tc.page_indices, layer=0)
        np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=2e-5)


# ---------------------------------------------------------------- writes


def _write_case(s, int8, dtype="float32", seed=0, start=None):
    """JAX fold-stored pools with random contents, a non-identity table,
    new tokens (L, b, s, nkv, hd) and start positions (page-crossing)."""
    n_layers, nkv, hd, ps, slots, pps = 3, 2, 64, 64, 4, 4
    rng = np.random.RandomState(seed)
    pc = jkv.init_paged_cache(n_layers, nkv, hd, slots * pps + 1, ps, slots, pps,
                              kv_dtype="int8" if int8 else None)
    pt = np.asarray(pc.page_indices) + 1
    kp = jnp.asarray(rng.standard_normal(pc.k_pages.shape), pc.k_pages.dtype)
    vp = jnp.asarray(rng.standard_normal(pc.v_pages.shape), pc.v_pages.dtype)
    if int8:
        kp, vp = (jnp.asarray(rng.randint(-127, 128, pc.k_pages.shape), jnp.int8)
                  for _ in range(2))
    new = [both(rng.standard_normal((n_layers, slots, s, nkv, hd)), dtype) for _ in range(2)]
    if start is None:
        start = rng.randint(0, pps * ps - s, (slots,))
    extra = {}
    if int8:
        extra = {k: jnp.asarray(rng.uniform(0.01, 0.02, pc.ks_pages.shape), jnp.float32)
                 for k in ("ks_pages", "vs_pages")}
    jc = jkv.PagedKVCache(k_pages=kp, v_pages=vp, page_indices=jnp.asarray(pt, jnp.int32),
                          lengths=jnp.zeros((slots,), jnp.int32), head_dim=hd, **extra)
    return jc, new, np.asarray(start, np.int32)


def _port_write(jc, new, start):
    tc = paged_cache_from_jax(_np_cache(jc), device="cpu")
    pools = tkv.write_tokens_all_layers_plain(tc.k_pages, tc.v_pages, new[0][1], new[1][1],
                                              tc.page_indices, torch.from_numpy(start),
                                              tc.ks_pages, tc.vs_pages)
    return tc, pools


def _jax_as_port(pools, jc):
    base = jc if isinstance(jc, dict) else _np_cache(jc)
    fields = dict(base, k_pages=np.asarray(pools[0]), v_pages=np.asarray(pools[1]))
    if len(pools) == 4:
        fields.update(ks_pages=np.asarray(pools[2]), vs_pages=np.asarray(pools[3]))
    return paged_cache_from_jax(fields, device="cpu")


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s", [1, 3, 64])
def test_paged_write_plain_vs_xla(s, int8):
    """write_tokens_all_layers' plain version against the JAX XLA scatter at
    s 1, 3 and 64 (page-crossing starts): every pool entry equal once the JAX
    pools are unfolded (int8: the same eager quantizer, values and scales
    equal)."""
    jc, new, start = _write_case(s, int8, seed=s)
    _, got = _port_write(jc, new, start)
    want = jkv.write_tokens_all_layers(jc.k_pages, jc.v_pages, new[0][0], new[1][0],
                                       jc.page_indices, jnp.asarray(start), jc.ks_pages,
                                       jc.vs_pages)
    want = _jax_as_port(want, jc)
    for g, w in zip(got, (want.k_pages, want.v_pages, want.ks_pages, want.vs_pages)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("int8,s", [(False, 1), (False, 3), (True, 5)])
def test_paged_write_plain_vs_pallas_interpret(int8, s):
    """The same against the JAX Pallas write (_write_kv, and _write_scales
    for int8, interpret mode), a chunk crossing a page boundary in every slot
    (s 3 / 5: the speculative verify width)."""
    start = np.full((4,), 64 - 2, np.int32) if s > 1 else None
    jc, new, start = _write_case(s, int8, seed=11 + s, start=start)
    _, got = _port_write(jc, new, start)
    fields = _np_cache(jc)   # the JAX write consumes (donates) its pools
    want = jpaged_write(jc.k_pages, jc.v_pages, new[0][0], new[1][0], jc.page_indices,
                        jnp.asarray(start), jc.ks_pages, jc.vs_pages, interpret=True)
    want = _jax_as_port(want, fields)
    for g, w in zip(got, (want.k_pages, want.v_pages, want.ks_pages, want.vs_pages)):
        assert torch.equal(g, w)


def test_write_tokens_one_layer_and_trash_overflow():
    """write_tokens (one layer, unfolded (n_kv, P, ps, hd) pools) equals the
    JAX per-layer scatter; a position past the table's last page lands in
    the TRASH page 0 and nowhere else."""
    rng = np.random.RandomState(4)
    kp, vp = (rng.standard_normal((2, 9, 16, 32)).astype(np.float32) for _ in range(2))
    kn, vn = (rng.standard_normal((2, 5, 2, 32)).astype(np.float32) for _ in range(2))
    pt = (rng.permutation(8) + 1).reshape(2, 4).astype(np.int32)
    start = np.array([14, 40], np.int32)
    want = jkv.write_tokens(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn), jnp.asarray(vn),
                            jnp.asarray(pt), jnp.asarray(start))
    got = tkv.write_tokens(*(torch.from_numpy(a.copy()) for a in (kp, vp, kn, vn, pt, start)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    plain = tkv.write_tokens_plain(*(torch.from_numpy(a.copy()) for a in (kp, vp, kn, vn, pt,
                                                                           start)))
    for g, w in zip(plain, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tk = torch.from_numpy(kp.copy())
    far = torch.tensor([4 * 16, 4 * 16 + 9], dtype=torch.int32)
    tkv.write_tokens(tk, torch.from_numpy(vp.copy()), torch.from_numpy(kn),
                     torch.from_numpy(vn), torch.from_numpy(pt), far)
    changed = (tk != torch.from_numpy(kp)).flatten(2).any(-1)      # (nkv, P)
    assert changed[:, 0].all() and not changed[:, 1:].any()


# ---------------------------------------------------------------- cached_attention, sampling


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_row", [False, True])
def test_cached_attention(dtype, per_row):
    """cached_attention with one int pos and with a (b,) tensor of per-row
    positions against the JAX function: f32 2e-5, bf16 1.6e-2."""
    rng = np.random.RandomState(1)
    b, sq, nkv, r, hd, s_len = 3, 4, 2, 3, 32, 24
    (jq, tq), (jk, tk), (jv, tv) = _chunk(rng, b, sq, nkv, r, hd, dtype)
    (jck, tck), (jcv, tcv) = (both(rng.standard_normal((b, s_len, nkv, hd)), dtype)
                              for _ in range(2))
    pos = np.array([0, 7, 24], np.int32) if per_row else 11
    want = jcached_attention(jq, jk, jv, jck, jcv, jnp.asarray(pos) if per_row else pos)
    got = tatt.cached_attention(tq, tk, tv, tck, tcv, torch.from_numpy(pos) if per_row else pos)
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=ATOL[dtype])


def test_sample_token_batched():
    """Greedy rows (temperature 0) equal argmax; sampled rows stay inside
    their nucleus and follow the JAX package's distribution; a generator with
    the same seed draws the same tokens."""
    rng = np.random.RandomState(2)
    logits = rng.standard_normal((4, 12)).astype(np.float32) * 2
    temps = np.array([0.0, 0.7, 0.0, 1.3], np.float32)
    topp = np.array([0.9, 0.8, 0.5, 0.95], np.float32)
    n = 1500
    rows = np.repeat(logits, n, axis=0)
    t_rep, p_rep = np.repeat(temps, n), np.repeat(topp, n)

    def draw(seed):
        return tsampling.sample_token_batched(
            torch.from_numpy(rows), torch.Generator().manual_seed(seed), torch.from_numpy(t_rep),
            torch.from_numpy(p_rep)).numpy().reshape(4, n)

    got = draw(0)
    np.testing.assert_array_equal(got, draw(0))
    jgot = np.asarray(jsampling.sample_token_batched(
        jnp.asarray(rows), jax.random.PRNGKey(0), jnp.asarray(t_rep),
        jnp.asarray(p_rep))).reshape(4, n)
    for i in (0, 2):
        assert (got[i] == logits[i].argmax()).all() and (jgot[i] == logits[i].argmax()).all()
    for i in (1, 3):
        z = np.exp((logits[i] - logits[i].max()) / temps[i])
        probs = z / z.sum()
        order = np.argsort(-probs)
        nucleus = set(order[(np.cumsum(probs[order]) - probs[order]) <= topp[i]])
        assert set(got[i]) <= nucleus and set(jgot[i]) <= nucleus and len(set(got[i])) > 1
        np.testing.assert_allclose(np.bincount(got[i], minlength=12) / n,
                                   np.bincount(jgot[i], minlength=12) / n, atol=0.05)


# ---------------------------------------------------------------- allocator, init


def test_pagepool_refcounts_and_trash():
    pool = tkv.PagePool(6)
    a = pool.alloc(2)
    assert pool.free_pages == 3 and 0 not in a
    pool.share(a)
    pool.release(a)
    assert pool.free_pages == 3 and pool.refcount(a[0]) == 1
    pool.release(a)
    assert pool.free_pages == 5 and pool.refcount(a[0]) == 0
    assert pool.alloc(6) is None
    with pytest.raises(ValueError):
        pool.release([tkv.PagePool.TRASH])
    with pytest.raises(ValueError):
        pool.share(a)


@pytest.mark.parametrize("total,int8", [(9, False), (5, True)])
def test_init_paged_cache_table_and_layout(total, int8):
    """Identity table when the pool covers slots x pages_per_seq, zeros when
    oversubscribed, as the reference; pools token-major, scale pools beside
    int8 ones, the page table and lengths int32."""
    pc = tkv.init_paged_cache(2, 2, 64, total, 16, 2, 4, dtype=torch.float32,
                              kv_dtype="int8" if int8 else None, device="cpu")
    jc = jkv.init_paged_cache(2, 2, 64, total, 16, 2, 4, dtype=jnp.float32,
                              kv_dtype="int8" if int8 else None)
    np.testing.assert_array_equal(pc.page_indices.numpy(), np.asarray(jc.page_indices))
    assert pc.k_pages.shape == (2, 2, total, 16, 64) and pc.page_indices.dtype == torch.int32
    assert pc.k_pages.dtype == (torch.int8 if int8 else torch.float32)
    assert (pc.ks_pages is not None) == int8 and pc.lengths.dtype == torch.int32
    if int8:
        assert pc.ks_pages.shape == (2, 2, total, 16) and pc.ks_pages.dtype == torch.float32
