"""The readers of the program's spans (``spans.py``, ``metrics/*``) on a
made-up context: each reads the mean stream ms or the median host ms of
its span over the first ``units`` occurrences only, and None where there
is nothing to read."""

import itertools

import pytest

from gpubench import common

from multimodal_isic_tpu_torch.utils import trace

STREAM = {"preprocess_ms.infer": "preprocess",
          "preprocess_ms.train": "preprocess",
          "jitter_ms.train": "preprocess.jitter",
          "vit_ms.infer": "convmae.vit",
          "fwd_ms.train": "step.forward",
          "bwd_ms.train": "step.backward",
          "opt_ms.train": "step.optimizer"}
HOST = {"host_ms.infer": ("fusion.forward", "convmae.encode"),
        "host_ms.train": ("step",)}
IDS = itertools.count(1)


def made(name, host_ms, device_ms):
    """A closed record of ``name``, opened at 1 s past the epoch."""
    i = next(IDS)
    r = trace.Record(name, i, None, i, 10 ** 9, 0)
    r.end_ns = r.start_ns + int(host_ms * 1e6)
    r.device_ms = device_ms
    return r


def fake(monkeypatch, records):
    monkeypatch.setattr(trace, "spans", lambda: list(records))


def ctx(units=2):
    return {"segment": {"units": units}}


@pytest.mark.parametrize("metric", sorted(STREAM))
def test_stream_reader_means_the_first_units(metric, monkeypatch):
    name = STREAM[metric]
    fake(monkeypatch, [made("other", 1.0, 99.0), made(name, 5.0, 1.0),
                       made(name, 5.0, 2.0), made(name, 5.0, 50.0)])
    assert common.metric_reader(metric).read(ctx(2)) == pytest.approx(1.5)
    assert common.metric_reader(metric).read(ctx(3)) == pytest.approx(53 / 3)


@pytest.mark.parametrize("metric", sorted(HOST))
@pytest.mark.parametrize("which", [0, -1])
def test_host_reader_medians_the_first_units(metric, which, monkeypatch):
    name = HOST[metric][which]
    fake(monkeypatch, [made("other", 70.0, 1.0), made(name, 1.0, 1.0),
                       made(name, 3.0, 1.0), made(name, 40.0, 1.0),
                       made(name, 2.0, 1.0)])
    assert common.metric_reader(metric).read(ctx(2)) == pytest.approx(2.0)
    assert common.metric_reader(metric).read(ctx(3)) == pytest.approx(3.0)


@pytest.mark.parametrize("metric", sorted(STREAM) + sorted(HOST))
def test_reader_finds_nothing(metric, monkeypatch):
    """None with no spans of its name, with only open ones, on the CPU (no
    CUDA events), and without a traced segment."""
    reader = common.metric_reader(metric)
    fake(monkeypatch, [])
    assert reader.read(ctx()) is None
    name = (STREAM.get(metric) or HOST[metric][0])
    r = made(name, 1.0, 1.0)
    r.end_ns = None
    fake(monkeypatch, [r])
    assert reader.read(ctx()) is None
    fake(monkeypatch, [made(name, 1.0, 1.0)])
    assert reader.read({"segment": None}) is None
    if metric in STREAM:
        fake(monkeypatch, [made(name, 1.0, None)])
        assert reader.read(ctx()) is None
