"""Profiling and roofline reporting on the card.

Port of ``accessory_tpu/util/profiling.py``:

* ``trace(logdir)``: a ``torch.profiler`` capture of the CPU and the card,
  written to ``logdir/trace.json`` (Chrome trace format, for Perfetto) when
  the block ends; the block gets the profiler object;
* ``device_busy_from_trace``: the time the card spent in kernels in a trace
  (the union of the kernel intervals in a window, so kernels that overlap
  on two streams count once) against the window's span;
* ``time_fn``: seconds a call between CUDA events around back-to-back calls,
  with the fixed cost of a run taken out by a two-point fit;
* ``params_bytes`` / ``roofline_report``: the bytes of a params tree and a
  decode step's time against the bytes bound.

Besides, the measurement helpers ``chip_smoke.py`` and the engines' checks
share: ``kernel_ms`` (device ms a call, the summed duration of the kernels a
run of calls launched, from the profiler's CUDA events, with the retakes of
traces that lose kernel events), ``busy_profile`` (a function run a few
times under ``trace``: its busy ms a call from ``device_busy_from_trace``,
its kernels' ms by name, and its idle share against a wall time) and
``idle_share``. Their defaults are the card's: ``HBM_BYTES_PER_S`` is the
H100 SXM's published 3.35 TB/s.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import math
import os
import statistics
import time
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM5, published

# traces ``kernel_ms`` took again: without device time, or short of events
retakes = {"empty": 0, "short": 0}


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, cpu: bool = True) -> Iterator[object]:
    """Profile the block on the card (and the CPU, with ``cpu``); yields the
    ``torch.profiler.profile`` object and, with ``logdir``, writes its
    Chrome trace to ``logdir/trace.json`` at the end. The card's queue is
    drained before the trace closes."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        yield prof
        torch.cuda.synchronize()
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _events_of(tr) -> list:
    """The events of a trace: a parsed Chrome trace (dict), a path to one
    (``.json`` or ``.json.gz``), or a directory holding one (the newest)."""
    if isinstance(tr, dict):
        return tr.get("traceEvents", [])
    path = str(tr)
    if os.path.isdir(path):
        cands = [os.path.join(root, f) for root, _, files in os.walk(path) for f in files
                 if f.endswith((".json", ".json.gz"))]
        if not cands:
            raise FileNotFoundError(f"no trace .json under {path}")
        path = max(cands, key=os.path.getmtime)   # newest: stale traces linger
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def kernel_intervals(tr) -> list:
    """(start µs, end µs, name) of every CUDA kernel of a trace (``_events_of``'
    forms): the complete events of category "kernel"."""
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""))
            for e in _events_of(tr)
            if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel"]


def device_busy_from_trace(tr, window: Optional[Tuple[float, float]] = None
                           ) -> Dict[str, float]:
    """Seconds the card spent in kernels in a trace: ``busy_s`` the length
    of the union of the kernel intervals (clipped to ``window``, (start,
    end) in the trace's µs, where given), ``span_s`` the first kernel's
    start to the last one's end in the window (or the window), and
    ``n_kernels``. ``tr``: a parsed Chrome trace, a path to one or a
    directory holding one (``trace(logdir)`` writes it). wall - busy is the
    host's share of a run."""
    iv = kernel_intervals(tr)
    if window is not None:
        lo, hi = window
        iv = [(max(s, lo), min(e, hi), n) for s, e, n in iv if e > lo and s < hi]
    busy, end = 0.0, -math.inf
    for s, e, _ in sorted(iv):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    if window is not None:
        span = window[1] - window[0]
    else:
        span = (max(e for _, e, _ in iv) - min(s for s, _, _ in iv)) if iv else 0.0
    return {"busy_s": busy / 1e6, "span_s": span / 1e6, "n_kernels": len(iv)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(f: Callable, *args, n1: int = 20, n2: int = 120, device="cuda") -> float:
    """Seconds a call of ``f(*args)``, amortized: runs of n1 and n2 calls
    timed between CUDA events (``time.perf_counter`` for ``device="cpu"``),
    and (t2 - t1) / (n2 - n1), which takes out the fixed cost of a run."""
    f(*args)
    _sync(device)
    if torch.device(device).type != "cuda":
        runs = []
        for n in (n1, n2):
            t0 = time.perf_counter()
            for _ in range(n):
                f(*args)
            runs.append(time.perf_counter() - t0)
        return (runs[1] - runs[0]) / (n2 - n1)
    runs = []
    for n in (n1, n2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            f(*args)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / 1e3)
    return (runs[1] - runs[0]) / (n2 - n1)


def params_bytes(params) -> int:
    """Bytes of a params tree (dicts, lists, tuples): a QuantizedWeight's
    packed, scales and zeros, every other tensor's elements. Other leaves
    count nothing."""
    from accessory_tpu_torch.quant.qtensor import QuantizedWeight

    if isinstance(params, QuantizedWeight):
        return sum(t.numel() * t.element_size() for t in (params.packed, params.scales,
                                                          params.zeros))
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(params_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(params_bytes(v) for v in params)
    return 0


def roofline_report(step_fn: Callable, params, batch: int, kv_bytes_per_step: int = 0,
                    *step_args, hbm_bw: float = HBM_BYTES_PER_S,
                    device="cuda") -> Dict[str, float]:
    """A decode step ``step_fn(params, *step_args)`` timed by ``time_fn``
    against its bytes bound (the params' bytes plus ``kv_bytes_per_step``,
    read once, at ``hbm_bw``)."""
    dt = time_fn(step_fn, params, *step_args, device=device)
    wbytes = params_bytes(params)
    bytes_per_step = wbytes + kv_bytes_per_step
    return {"step_ms": dt * 1e3, "tokens_per_s": batch / dt, "weight_bytes": wbytes,
            "achieved_gbps": bytes_per_step / dt / 1e9,
            "roofline_fraction": bytes_per_step / hbm_bw / dt}


def idle_share(busy_ms: float, wall_ms: float) -> float:
    """The share of a wall time the card was not in a kernel."""
    return max(0.0, 1.0 - busy_ms / wall_ms) if wall_ms > 0 else 0.0


def busy_profile(fn: Callable[[], object], calls: int, wall_ms: Optional[float] = None,
                 shares: Sequence[str] = (), top: int = 10) -> Dict[str, object]:
    """``fn()`` run ``calls`` times under ``trace``: ``device_busy_ms_per_call``
    (``device_busy_from_trace``: the union of its kernels' intervals a call),
    ``kernels_ms_per_call`` (the summed kernel time a call),
    ``top_kernels_ms_per_call`` (by name, the ``top`` largest),
    ``wall_ms_per_call_profiled`` (tracing slows the host) and, against
    ``wall_ms`` (an unprofiled wall time a call), ``device_idle_share``.
    ``shares``: kernel-name substrings whose ms a call and share of busy are
    added. A trace without kernels gives {"device_time": "not measured"}."""
    _sync("cuda")
    t0 = time.perf_counter()
    with trace(cpu=False) as prof:
        for _ in range(calls):
            fn()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    events = trace_events(prof)
    busy = device_busy_from_trace(events)
    if busy["n_kernels"] == 0:
        return {"device_time": "not measured (no kernel events in the trace)"}
    by_name: Dict[str, float] = {}
    for s, e, name in kernel_intervals(events):
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3 / calls
    busy_ms = busy["busy_s"] * 1e3 / calls
    out = {"device_busy_ms_per_call": busy_ms,
           "kernels_ms_per_call": sum(by_name.values()),
           "n_kernels_per_call": busy["n_kernels"] / calls,
           "wall_ms_per_call_profiled": wall,
           "top_kernels_ms_per_call": {k[:80]: v for k, v in
                                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}}
    if wall_ms is not None:
        out["device_idle_share"] = idle_share(busy_ms, wall_ms)
    for sub in shares:
        ms = sum(v for k, v in by_name.items() if sub in k)
        out[f"{sub}_ms_per_call"], out[f"{sub}_share_of_busy"] = ms, ms / busy_ms
    return out


def trace_events(prof) -> dict:
    """A finished profiler's Chrome trace, parsed (written to a temporary
    file, which is removed)."""
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def kernel_ms(fn: Callable, arg_sets, min_iters: int = 30, repeats: int = 3, by=None):
    """Device ms a call over round-robin argument sets: the summed duration
    of every kernel the calls launched, from the profiler's CUDA events (host
    time between launches is not counted); the median of ``repeats`` traces,
    so one stray does not make the reading. The CUDA trace sometimes loses
    kernel events (all, or a few of a run's), and a trace that lost some
    reads low: a trace without device time is taken again, up to 5 times
    in all, and then it raises (no other clock stands in for it); a trace
    with fewer kernel events than calls (every call launches one at least),
    or than another trace of the same calls, is taken again up to twice,
    then used. Both are counted in ``retakes``. ``by``: kernel-name
    substrings; then {substring: ms a call} of the kernels whose name holds
    each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    n = len(arg_sets) * max(1, math.ceil(min_iters / len(arg_sets)))
    per_call, most = [], 0
    for _ in range(repeats):
        events, shorts = None, 0
        for _attempt in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(n):
                    fn(*arg_sets[i % len(arg_sets)])
                torch.cuda.synchronize()
            got = [(e.key, getattr(e, "self_device_time_total", 0), e.count)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            if sum(us for _, us, _ in got) <= 0:
                retakes["empty"] += 1
                continue
            events, count = got, sum(c for _, _, c in got)
            most = max(most, count)
            if count >= max(n, most):
                break
            retakes["short"] += 1
            shorts += 1
            if shorts == 3:
                break
        if events is None:
            raise RuntimeError("kernel_ms: 5 profiler traces in a row held no device time")
        if by is None:
            per_call.append(sum(us for _, us, _ in events) / 1e3 / n)
        else:
            per_call.append({sub: sum(us for key, us, _ in events if sub in key) / 1e3 / n
                             for sub in by})
    if by is None:
        return statistics.median(per_call)
    return {sub: statistics.median(c[sub] for c in per_call) for sub in by}
