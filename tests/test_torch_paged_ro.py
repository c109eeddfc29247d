"""Port parity, the read-only paged decode (``engine/kvcache.py::
paged_attention_decode``, the kernel entry ``ops/paged_decode.py::
paged_decode_ro``): one query token a slot whose k/v the pools already hold,
its length counting it. Its plain version (the path a CPU tensor takes)
against the reference's ``paged_attention_xla`` on the same pools, written by
the JAX package's own paged write and carried over by
``convert.paged_cache_from_jax``; against the paged decode with the token
given as the new one (``paged_decode_attention_plain``, sq = 1) after the
same token is written; and pinned to the oracle's hd ** -0.5 scale, which
the reference's bundled kernel branch does not apply (ROADMAP C5). CPU only.

Tolerances: test_torch_paged.py's (f32 2e-5: sums in another order; bf16
1.6e-2: the two forms round p to bf16 at other points).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.engine import kvcache as jkv

from accessory_tpu_torch.engine import kvcache as tkv
from accessory_tpu_torch.ops.paged_decode import paged_decode_attention_plain, paged_decode_ro

from test_torch_ops import both, f32
from test_torch_paged import ATOL, CASES, _pool


def _layer(tc):
    return tc.k_pages[0], tc.v_pages[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_paged_attention_decode_matches_the_reference_oracle(case, dtype):
    """GQA at head_dim 64 and MHA at 128, a shuffled table, lengths at page
    edges (lengths count the token, so they start at 1)."""
    hd, r, ps, lengths = CASES[case]
    lengths = [max(1, n) for n in lengths]
    nkv, pps = 2, 4
    b = len(lengths)
    jc, tc = _pool(b, nkv, hd, ps, pps, lengths, dtype, False, seed=case)
    jq, tq = both(np.random.RandomState(case).standard_normal((b, nkv * r, hd)), dtype)
    kp, vp = _layer(tc)
    # the JAX oracle reads unfolded (n_kv, P, ps, hd) pools: the port's layout
    want = jkv.paged_attention_xla(jq, jnp.asarray(f32(kp)).astype(jq.dtype),
                                   jnp.asarray(f32(vp)).astype(jq.dtype), jc.lengths,
                                   jc.page_indices)
    got = tkv.paged_attention_decode(tq, kp, vp, tc.lengths, tc.page_indices)
    assert got.dtype == tq.dtype and got.shape == (b, nkv * r, hd)
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_read_only_form_is_the_paged_decode_after_the_write(dtype):
    """The token's k/v written at each slot's old length, then attended read-
    only with the length counting it, equals the paged decode that takes the
    token as its new one over the old length."""
    hd, r, ps, _ = CASES[0]
    lengths = [0, 1, 15, 16, 17, 63]   # old lengths: the token fits the 4 x 16 table
    nkv, pps = 2, 4
    b = len(lengths)
    _, tc = _pool(b, nkv, hd, ps, pps, [n + 1 for n in lengths], dtype, False, seed=7)
    rng = np.random.RandomState(3)
    tq, tk, tv = (both(rng.standard_normal((b, 1, h, hd)), dtype)[1] for h in (nkv * r, nkv, nkv))
    old = torch.tensor(lengths, dtype=torch.int32)
    want = paged_decode_attention_plain(tq, tk, tv, tc.k_pages, tc.v_pages, old,
                                        tc.page_indices, layer=0)
    kp, vp = _layer(tc)
    tkv.write_tokens(kp, vp, tk, tv, tc.page_indices, old)
    got = paged_decode_ro(tq[:, 0], kp, vp, old + 1, tc.page_indices)
    np.testing.assert_allclose(f32(got), f32(want[:, 0]), rtol=0, atol=ATOL[dtype])


def test_the_port_keeps_the_oracle_scale():
    """ROADMAP C5: the reference's bundled paged kernel computes its scores
    without hd ** -0.5, its oracle with it; the port follows the oracle, and
    the unscaled function differs from it by far more than any tolerance."""
    hd, r, ps, lengths = CASES[1]
    lengths = [max(1, n) for n in lengths]
    _, tc = _pool(len(lengths), 2, hd, ps, 4, lengths, "float32", False, seed=1)
    q = torch.from_numpy(np.random.RandomState(2).standard_normal((len(lengths), 2 * r, hd))
                         .astype(np.float32)) * 3
    kp, vp = _layer(tc)
    got = tkv.paged_attention_decode(q, kp, vp, tc.lengths, tc.page_indices)
    scaled = tkv.paged_attention_xla(q, kp, vp, tc.lengths, tc.page_indices)
    unscaled = tkv.paged_attention_xla(q * hd ** 0.5, kp, vp, tc.lengths, tc.page_indices)
    np.testing.assert_allclose(got.numpy(), scaled.numpy(), rtol=0, atol=0)
    assert float((unscaled - scaled).abs().max()) > 0.1


def test_paged_decode_ro_raises_off_cpu_and_cuda():
    q = torch.empty((2, 8, 64), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tkv.paged_attention_decode(q, q, q, q, q)
