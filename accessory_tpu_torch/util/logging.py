"""Training metrics and logging. Port of ``accessory_tpu/util/logging.py``
(setup_for_distributed, SmoothedValue, MetricLogger, write_log_line); the
memory figure is ``torch.cuda.max_memory_allocated`` (0 on a host without a
card)."""

from __future__ import annotations

import builtins
import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch


def setup_for_distributed(is_master: bool) -> None:
    """Silence ``print`` on every process but the master (``force=True``
    prints anyway) and prefix each line with a timestamp."""
    builtin_print = builtins.print

    def print_fn(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
            builtin_print(f"[{now}]", *args, **kwargs)

    builtins.print = print_fn


class SmoothedValue:
    """Track a series: windowed median / average, global average."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


def _device_mem_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1024 ** 3 if torch.cuda.is_available() else 0.0


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if v is not None:
                self.meters[k].update(float(v))

    def __getattr__(self, attr):
        # only called for names that are not attributes: a meter by its name
        meters = self.__dict__.get("meters", {})
        if attr in meters:
            return meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def __str__(self) -> str:
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "",
                  start_iter: int = 0, total: Optional[int] = None):
        """Yield (i, item) from ``start_iter``, printing every ``print_freq``
        items the meters, iteration and data time and peak device memory."""
        i = start_iter
        if total is None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = None
        start = end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield i, obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                where = f"[{i}/{total}]" if total else f"[{i}]"
                eta = ""
                if total:
                    secs = int(iter_time.global_avg * (total - i))
                    eta = f" eta: {datetime.timedelta(seconds=secs)}"
                print(f"{header} {where}{eta} {self} time: {iter_time} data: {data_time} "
                      f"mem: {_device_mem_gb():.1f}GB", flush=True)
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))}", flush=True)


def write_log_line(output_dir: str, stats: Dict) -> None:
    """Append a JSON line to ``output_dir/log.txt``."""
    with open(os.path.join(output_dir, "log.txt"), "a") as f:
        f.write(json.dumps(stats) + "\n")
