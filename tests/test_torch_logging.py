"""Port parity, training metrics and logging (``util/logging.py``): the
reference's and the port's ``MetricLogger`` and ``setup_for_distributed``
driven through the same calls, compared by what they print and return.
Timestamps, times and memory figures are masked: they are the only parts
that differ from run to run. CPU only."""

import builtins
import re

import pytest

from accessory_tpu.util import logging as jlog

from accessory_tpu_torch.util import logging as tlog

MODULES = {"reference": jlog, "port": tlog}


def _drive_meters(mod):
    """Updates, a meter added by name, attribute access and the text."""
    logger = mod.MetricLogger(delimiter=" | ")
    logger.add_meter("lr", mod.SmoothedValue(window_size=2, fmt="{value:.6f}"))
    for i in range(5):
        logger.update(loss=2.0 / (i + 1), lr=1e-3 * (i + 1), skipped=None)
    meter = logger.loss
    return (str(logger), sorted(logger.meters), meter.median, meter.global_avg,
            logger.lr.value, str(logger.lr))


def test_meters_by_name_and_add_meter():
    assert _drive_meters(tlog) == _drive_meters(jlog)


@pytest.mark.parametrize("name", ["reference", "port"])
def test_an_unknown_meter_is_an_attribute_error(name):
    logger = MODULES[name].MetricLogger()
    logger.update(loss=1.0)
    with pytest.raises(AttributeError):
        logger.accuracy   # noqa: B018
    assert not hasattr(logger, "grad_norm") and hasattr(logger, "loss")


def _masked(text: str) -> str:
    text = re.sub(r"\[\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\]", "[TIME]", text)
    return re.sub(r"\d+(\.\d+)?", "N", text)


@pytest.mark.parametrize("is_master", [True, False])
def test_setup_for_distributed(capsys, is_master):
    out = {}
    for name, mod in MODULES.items():
        saved = builtins.print
        try:
            mod.setup_for_distributed(is_master)
            print("step", 3, "loss", 0.5)
            print("forced line", force=True)
        finally:
            builtins.print = saved
        out[name] = capsys.readouterr().out
    assert out["port"] == out["reference"]
    assert _masked(out["port"]).count("[TIME]") == (2 if is_master else 1)


@pytest.mark.parametrize("total", [None, 4])
def test_log_every(capsys, total):
    """The items yielded and the lines printed (with the numbers masked)."""
    out = {}
    for name, mod in MODULES.items():
        logger = mod.MetricLogger()
        items = []
        for i, obj in logger.log_every(iter("abcd"), 2, header="Epoch: [0]", total=total):
            logger.update(loss=float(i))
            items.append((i, obj))
        out[name] = (items, _masked(capsys.readouterr().out))
    assert out["port"] == out["reference"]
    assert out["port"][0] == [(0, "a"), (1, "b"), (2, "c"), (3, "d")]
