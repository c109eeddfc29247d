"""Port parity, ``accessory_tpu_torch/util/profiling.py`` against
``accessory_tpu/util/profiling.py``: ``params_bytes`` on the same tree (dense
arrays and quantized weights built from the same numpy arrays on both
sides), ``roofline_report``'s fields and arithmetic, ``time_fn``'s two-point
fit, and ``device_busy_from_trace`` on synthetic Chrome traces (overlapping
kernels counted once, a window clipping them, the trace read from a dict, a
file, a gzip file and a directory). CPU only; exact arithmetic, no tolerance
but float rounding (1e-12 relative).
"""

import gzip
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.quant import qtensor as jq
from accessory_tpu.util import profiling as jprof

from accessory_tpu_torch.quant import qtensor as tq
from accessory_tpu_torch.util import profiling as tprof

from test_torch_generate import one_torch_thread  # noqa: F401


def _trees():
    """One tree in both packages' forms from the same numpy arrays: dense
    leaves of three dtypes, lists, and a 4-bit and an 8-bit quantized
    weight."""
    rng = np.random.RandomState(0)
    dense = {"tok": rng.randn(64, 32).astype(np.float32),
             "norm": rng.randn(32).astype(np.float16),
             "ids": rng.randint(0, 9, size=(7,)).astype(np.int32)}
    quant = [(rng.randint(0, 2 ** 31, size=(16, 48)).astype(np.uint32),
              rng.rand(2, 48).astype(np.float32), rng.rand(2, 48).astype(np.float32), 4),
             (rng.randint(0, 2 ** 31, size=(32, 24)).astype(np.uint32),
              rng.rand(1, 24).astype(np.float32), rng.rand(1, 24).astype(np.float32), 8)]

    def jqw(p, s, z, bits):
        return jq.QuantizedWeight(packed=jnp.asarray(p), scales=jnp.asarray(s),
                                  zeros=jnp.asarray(z), bits=bits, group_size=64,
                                  in_dim=128, out_dim=p.shape[1])

    def tqw(p, s, z, bits):
        return tq.QuantizedWeight(packed=torch.from_numpy(p.astype(np.int32)),
                                  scales=torch.from_numpy(s), zeros=torch.from_numpy(z),
                                  bits=bits, group_size=64, in_dim=128, out_dim=p.shape[1])

    jtree = {"emb": {k: jnp.asarray(v) for k, v in dense.items()},
             "layers": [{"w": jqw(*q), "b": jnp.asarray(dense["norm"])} for q in quant]}
    ttree = {"emb": {k: torch.from_numpy(v) for k, v in dense.items()},
             "layers": [{"w": tqw(*q), "b": torch.from_numpy(dense["norm"])} for q in quant]}
    return jtree, ttree


def test_params_bytes_equals_jax():
    """The same tree counts the same bytes in both packages (a quantized
    weight: packed, scales and zeros; a dense leaf: its elements)."""
    jtree, ttree = _trees()
    want = jprof.params_bytes(jtree)
    assert tprof.params_bytes(ttree) == want > 0
    # non-tensor leaves count nothing, as a JAX tree holds none
    assert tprof.params_bytes({"t": ttree, "n": None, "s": "x", "i": 3}) == want


def test_roofline_report_fields():
    """The reference's five fields, from ``time_fn``'s step time and the
    params' bytes plus the KV bytes at the given bandwidth."""
    _, ttree = _trees()
    calls = []

    def step(params, k):
        calls.append(k)

    rep = tprof.roofline_report(step, ttree, 8, 1000, 3, hbm_bw=1e9, device="cpu")
    assert set(rep) == {"step_ms", "tokens_per_s", "weight_bytes", "achieved_gbps",
                        "roofline_fraction"}
    assert calls and set(calls) == {3}
    wb = tprof.params_bytes(ttree)
    dt = rep["step_ms"] / 1e3
    assert rep["weight_bytes"] == wb
    np.testing.assert_allclose(rep["tokens_per_s"], 8 / dt, rtol=1e-12)
    np.testing.assert_allclose(rep["achieved_gbps"], (wb + 1000) / dt / 1e9, rtol=1e-12)
    np.testing.assert_allclose(rep["roofline_fraction"], (wb + 1000) / 1e9 / dt, rtol=1e-12)


def test_time_fn_two_point_fit(monkeypatch):
    """(t(n2 calls) - t(n1 calls)) / (n2 - n1): a fixed cost per run drops
    out. A fake clock: each call 2 ms, each run 5 ms more."""
    clock = [0.0]
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: clock[0])

    def f():
        clock[0] += 0.002

    real_range = range

    def timed_range(n):   # the run's fixed cost, charged as it starts
        clock[0] += 0.005
        return real_range(n)

    monkeypatch.setattr(tprof, "range", timed_range, raising=False)
    got = tprof.time_fn(f, n1=10, n2=30, device="cpu")
    np.testing.assert_allclose(got, 0.002, rtol=1e-9)


def _kernel(ts, dur, name="k", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}


TRACE = {"traceEvents": [
    _kernel(0, 10, "a"), _kernel(5, 10, "b"),        # overlap: [0, 15)
    _kernel(20, 5, "c"),                             # [20, 25)
    _kernel(21, 2, "d"),                             # inside c
    _kernel(40, 10, "e"),                            # [40, 50)
    _kernel(3, 100, "cpu", cat="cpu_op"),            # not a kernel
    {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
]}


def test_device_busy_is_the_union_of_kernel_intervals():
    got = tprof.device_busy_from_trace(TRACE)
    assert got["n_kernels"] == 5
    np.testing.assert_allclose(got["busy_s"], (15 + 5 + 10) / 1e6, rtol=1e-12)
    np.testing.assert_allclose(got["span_s"], 50 / 1e6, rtol=1e-12)
    # the sum of durations would count the overlaps twice
    assert sum(e - s for s, e, _ in tprof.kernel_intervals(TRACE)) == 37


def test_device_busy_in_a_window():
    got = tprof.device_busy_from_trace(TRACE, window=(12, 45))
    assert got["n_kernels"] == 4                      # b, c, d, e cross it
    np.testing.assert_allclose(got["busy_s"], (3 + 5 + 5) / 1e6, rtol=1e-12)
    np.testing.assert_allclose(got["span_s"], 33 / 1e6, rtol=1e-12)
    assert tprof.device_busy_from_trace(TRACE, window=(26, 39))["busy_s"] == 0.0


def test_device_busy_reads_files_and_directories(tmp_path):
    (tmp_path / "plain").mkdir()
    (tmp_path / "plain" / "trace.json").write_text(json.dumps(TRACE))
    with gzip.open(tmp_path / "t.json.gz", "wt") as f:
        json.dump(TRACE, f)
    want = tprof.device_busy_from_trace(TRACE)
    for src in (tmp_path / "plain", tmp_path / "plain" / "trace.json", tmp_path / "t.json.gz"):
        assert tprof.device_busy_from_trace(str(src)) == want
    with pytest.raises(FileNotFoundError):
        (tmp_path / "empty").mkdir()
        tprof.device_busy_from_trace(str(tmp_path / "empty"))


@pytest.mark.parametrize("busy,wall,want", [(1.0, 4.0, 0.75), (5.0, 4.0, 0.0), (1.0, 0.0, 0.0)])
def test_idle_share(busy, wall, want):
    assert tprof.idle_share(busy, wall) == want
