"""The port's spans (``utils/trace.py``): off, they record nothing and touch
no profiler, event or sync; on, under ``trace.recording()`` or a
``torch.profiler``, each layer gives its spans with their parents, units
and nested host intervals on the profiler's clock, and outputs are the same
bit for bit.  Tiny models on the CPU.

The test marked ``cuda`` (a span around a kernel against the profiler's
record of it) skips here and runs on a card with

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py
"""

import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_isic_tpu_torch.data import augment as aug
from multimodal_isic_tpu_torch.models.convmae import ConvMAE
from multimodal_isic_tpu_torch.models.fusion import MultiModalFusionNet
from multimodal_isic_tpu_torch.train.fusion import (fusion_optimizer,
                                                    make_fusion_train_step)
from multimodal_isic_tpu_torch.train.mae import (mae_optimizer,
                                                 make_mae_train_step)
from multimodal_isic_tpu_torch.utils import trace

NAMES = {"preprocess", "preprocess.jitter", "fusion.forward",
         "convmae.encode", "convmae.vit", "step", "step.forward",
         "step.backward", "step.optimizer"}
MAE = dict(img_size=32, embed_dims=(128, 128, 128), depths=(1, 1, 1),
           num_heads=4, decoder_dim=32, decoder_depth=1, decoder_heads=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    trace.reset()
    yield
    trace.reset()


def _fusion_step():
    torch.manual_seed(0)
    model = MultiModalFusionNet(radiomics_dim=8, backbone="efficientnet-b0",
                                fusion_strategy="concat")
    model.train()
    step = make_fusion_train_step(model, fusion_optimizer(model))
    g = torch.Generator().manual_seed(1)
    batch = {"image": torch.rand(2, 32, 32, 3, generator=g),
             "radiomics": torch.randn(2, 8, generator=g),
             "age": torch.randn(2, generator=g),
             "sex": torch.tensor([0, 2]), "loc": torch.tensor([3, 14]),
             "artifacts": torch.tensor([[0, 1] * 3, [1, 0] * 3]),
             "target": torch.tensor([1, 6])}

    def run():
        loss, correct = step(batch, torch.Generator().manual_seed(2))
        return [loss, correct, *model.state_dict().values()]
    return run


def _mae_step():
    torch.manual_seed(0)
    model = ConvMAE(**MAE)
    step = make_mae_train_step(model, mae_optimizer(model), 0.75)
    imgs = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))

    def run():
        loss = step(imgs, None, torch.Generator().manual_seed(2))
        return [loss, *model.state_dict().values()]
    return run


def _encode():
    torch.manual_seed(0)
    model = ConvMAE(**MAE, with_decoder=False).eval()
    imgs = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))

    def run():
        with torch.inference_mode():
            return list(model.encode(imgs, 0.0))
    return run


def _u8(b=2, hw=40, seed=3):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 256, (b, hw, hw, 3), generator=g,
                          dtype=torch.uint8),
            torch.randint(0, 2, (b, hw, hw), generator=g,
                          dtype=torch.uint8) * 255)


def _policies():
    imgs, masks = _u8()
    fast = aug.make_fusion_train_fast((32, 32))

    def run():
        out = [aug.preprocess_eval_batch(imgs, (32, 32)),
               *aug.fusion_eval_batch(imgs, masks, (32, 32)),
               *aug.mae_eval_batch(imgs, masks, (32, 32)),
               *aug.fusion_train_batch(imgs, masks,
                                       torch.Generator().manual_seed(4),
                                       (32, 32)),
               aug.mae_train_batch(imgs, masks,
                                   torch.Generator().manual_seed(5),
                                   (32, 32))[0],
               fast(imgs, None, torch.Generator().manual_seed(6))[0]]
        return out
    return run


WORK = {"fusion_step": _fusion_step, "mae_step": _mae_step,
        "encode": _encode, "policies": _policies}


@pytest.fixture
def on(request):
    """Recording on, by ``trace.recording()`` or by a CPU profiler; yields
    the profiler (or None) so a test can read its events afterwards."""
    if request.param == "recording":
        with trace.recording():
            yield None
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            yield prof


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def _nested(child, parent):
    assert child.parent == parent.id and child.unit == parent.unit
    assert parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


@pytest.mark.parametrize("work", sorted(WORK))
def test_off_records_nothing_and_touches_no_profiler(work, monkeypatch):
    """Off, a span is the shared no-op: it builds no span object, so it
    enters no ``record_function``, makes no CUDA event and no sync."""
    run = WORK[work]()

    def refuse(*a, **k):
        raise AssertionError("a span did work while tracing was off")
    entered = []
    init = torch.autograd.profiler.record_function.__init__

    def counted(self, name, *a, **k):
        entered.append(name)
        init(self, name, *a, **k)
    monkeypatch.setattr(trace, "_Span", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__",
                        counted)
    run()
    assert trace.spans() == []
    assert trace.span("step") is trace.span("preprocess")
    assert not NAMES & set(entered)


@pytest.mark.parametrize("on", ["recording", "profiler"], indirect=True)
@pytest.mark.parametrize("work", ["fusion_step", "mae_step"])
def test_train_step_spans(work, on):
    run = WORK[work]()
    run()
    recs = trace.spans()
    steps = [r for r in recs if r.name == "step"]
    assert len(steps) == 1
    step = steps[0]
    assert step.parent is None and step.unit == step.id
    kids = [r for r in recs if r.parent == step.id]
    assert [r.name for r in kids] == ["step.forward", "step.backward",
                                      "step.optimizer"]
    for k in kids:
        _nested(k, step)
        assert k.device_ms is None  # the CPU has no device clock
    assert kids[0].end_ns <= kids[1].start_ns
    assert kids[1].end_ns <= kids[2].start_ns
    assert all(r.unit == step.id for r in recs)
    by = _by_name(recs)
    if work == "fusion_step":
        _nested(by["fusion.forward"][0], kids[0])
    else:
        enc, vit = by["convmae.encode"][0], by["convmae.vit"][0]
        _nested(enc, kids[0])
        _nested(vit, enc)


@pytest.mark.parametrize("on", ["recording", "profiler"], indirect=True)
def test_encode_spans(on):
    WORK["encode"]()()
    enc, vit = trace.spans()
    assert (enc.name, vit.name) == ("convmae.encode", "convmae.vit")
    assert enc.parent is None and enc.unit == enc.id
    _nested(vit, enc)


@pytest.mark.parametrize("on", ["recording", "profiler"], indirect=True)
def test_policy_spans(on):
    """``mae_eval_batch`` → ``fusion_eval_batch`` →
    ``preprocess_eval_batch`` is one ``preprocess``; the fast policy's
    jitter is a ``preprocess.jitter`` inside its ``preprocess``."""
    imgs, masks = _u8()
    aug.mae_eval_batch(imgs, masks, (32, 32))
    (pre,) = trace.spans()
    assert pre.name == "preprocess" and pre.parent is None
    trace.reset()
    aug.make_fusion_train_fast((32, 32))(imgs, None,
                                         torch.Generator().manual_seed(6))
    pre, jit = trace.spans()
    assert (pre.name, jit.name) == ("preprocess", "preprocess.jitter")
    _nested(jit, pre)


def test_no_span_in_the_profilers_events():
    """Spans are not profiler ranges: none of their names is among a CPU
    profiler's events, which still recorded the step's operators."""
    run = WORK["fusion_step"]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    names = {e.name for e in prof.events()}
    assert "aten::addmm" in names and not NAMES & names
    assert {r.name for r in trace.spans()} >= {"step", "fusion.forward"}


@pytest.mark.parametrize("work", sorted(WORK))
def test_outputs_bit_identical_on_and_off(work):
    off = WORK[work]()()
    with trace.recording():
        on = WORK[work]()()
    assert trace.spans()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_start_on_the_epoch_clock():
    """A span's start lies between ``time.time_ns()`` read before it and
    after it: the profiler's clock (ns since the Unix epoch)."""
    with trace.recording():
        for _ in range(3):
            t0 = time.time_ns()
            with trace.span("step"):
                t1 = time.time_ns()
            t2 = time.time_ns()
            r = trace.spans()[-1]
            assert t0 <= r.start_ns <= t1 <= r.end_ns <= t2


def test_same_name_nesting_and_decorator():
    @trace.spanned("preprocess")
    def inner(x):
        return x + 1

    @trace.spanned("preprocess")
    def outer(x):
        with trace.span("preprocess.jitter"):
            return inner(inner(x))
    assert outer(1) == 3 and trace.spans() == []
    assert outer.__name__ == "outer"
    with trace.recording():
        outer(1)
    pre, jit, pre2, pre3 = trace.spans()
    assert (pre.name, jit.name) == ("preprocess", "preprocess.jitter")
    # directly inside the jitter, each inner preprocess is a span of its own
    assert pre2.parent == pre3.parent == jit.id
    trace.reset()
    with trace.recording():
        with trace.span("preprocess"):
            inner(1)
    assert [r.name for r in trace.spans()] == ["preprocess"]


def test_threads_keep_their_own_stacks():
    """Eight threads opening nested spans at once, switching every 10 µs:
    no id given twice, and every child's parent and unit are a span of its
    own thread."""
    n_threads, n_units = 8, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def work(k):
        for _ in range(n_units):
            with trace.span(f"unit{k}"):
                with trace.span(f"child{k}"):
                    pass
    try:
        with trace.recording():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = trace.spans()
    assert len(recs) == 2 * n_threads * n_units
    assert len({r.id for r in recs}) == len(recs)
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name.startswith("child"):
            parent = by_id[r.parent]
            assert parent.name == "unit" + r.name[5:]
            _nested(r, parent)
        else:
            assert r.parent is None and r.unit == r.id


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_span_encloses_its_kernel_on_the_profilers_clock(cuda):
    """Under a device-only profiler, a span around a matmul and a
    ``synchronize()`` encloses the kernel's interval as the profiler
    recorded it, and its ``device_ms`` is the kernel's time within 10%.
    The profiler's first launch, which sets up its own tracing, runs
    before the span."""
    from torch.autograd import DeviceType
    a = torch.randn(8192, 8192, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a @ a
        torch.cuda.synchronize()
        with trace.span("step"):
            b = a @ a
            torch.cuda.synchronize()
    (r,) = trace.spans()
    kernels = sorted((e.start_ns(), e.end_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA
                     and e.end_ns() > e.start_ns())
    # the warm-up's launches, then the span's: the same ones again
    assert len(kernels) >= 2 and len(kernels) % 2 == 0
    ours = kernels[len(kernels) // 2:]
    k0, k1 = ours[0][0], max(e for _, e in ours)
    assert r.start_ns <= k0 < k1 <= r.end_ns
    kernel_ms = (k1 - k0) / 1e6
    assert abs(r.device_ms - kernel_ms) <= 0.1 * kernel_ms
    assert b.shape == a.shape
