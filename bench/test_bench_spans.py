"""The attribution arithmetic of ``bench/spans.py`` on synthetic events:
unions of nested and repeated spans, clipping to the window, device
operations joined to their launches by correlation id, and nothing where
nothing matches."""
from __future__ import annotations

import types

import pytest
import torch

import harness
import spans

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    """The accessors of a profiler event that ``Spans.read`` calls."""

    def __init__(self, name, dev, start, dur, corr=0, tid=1, ann=False):
        self._v = (name, dev, start, dur, corr, tid, ann)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_nested_and_repeated_spans_count_once():
    s = spans.Spans({"plan.stage": [(10, 50, 1), (20, 40, 1), (45, 70, 1),
                                    (100, 110, 1)]}, [], (0, 1000))
    assert s.intervals("plan.stage") == [(10, 70), (100, 110)]
    assert s.seconds("plan.stage") == pytest.approx(70e-9)
    # two names overlapping: their union, once
    s = spans.Spans({"sparse.gather": [(0, 30, 1)],
                     "sparse.scatter": [(20, 60, 1)]}, [], (0, 1000))
    assert s.seconds("sparse.gather", "sparse.scatter") == \
        pytest.approx(60e-9)


def test_spans_and_operations_clip_to_the_window():
    s = spans.Spans({"experiment.call": [(0, 150, 1), (180, 400, 1),
                                         (500, 600, 1)]},
                    [(110, 1, 90, 130), (300, 1, 290, 420),
                     (550, 1, 540, 560)], (100, 300))
    assert s.intervals("experiment.call") == [(100, 150), (180, 300)]
    assert s.ops == [(110, 1, 100, 130), (300, 1, 290, 300)]
    # the op launched at 300 lies inside the clipped span's end
    assert s.device_seconds_under("experiment.call") == pytest.approx(40e-9)


def test_an_operation_launched_outside_every_span_counts_under_none():
    ops = [(15, 1, 100, 200),      # launched in the nested stage
           (60, 1, 200, 260),      # in the execute span alone
           (80, 1, 260, 300),      # outside every span
           (15, 2, 300, 400),      # inside the interval, another thread
           (None, None, 400, 450)]  # its launch not recorded
    s = spans.Spans({"plan.execute": [(10, 70, 1)],
                     "plan.stage": [(12, 20, 1)]}, ops, (0, 1000))
    assert s.device_seconds_under("plan.stage") == pytest.approx(100e-9)
    # nested spans count for their ancestors
    assert s.device_seconds_under("plan.execute") == pytest.approx(160e-9)
    assert s.device_seconds_under("plan.execute", "plan.stage") == \
        pytest.approx(160e-9)


def test_overlapping_operations_count_once():
    ops = [(5, 1, 100, 200), (6, 1, 150, 220), (7, 1, 150, 180)]
    s = spans.Spans({"generate.lm": [(0, 10, 1)]}, ops, (0, 1000))
    assert s.device_seconds_under("generate.lm") == pytest.approx(120e-9)


def test_nothing_matches_gives_none():
    s = spans.Spans({"plan.build": [(0, 10, 1)]}, [(50, 1, 60, 70)],
                    (0, 1000))
    assert s.seconds("experiment.measures") is None
    assert s.device_seconds_under("plan.build") is None
    assert s.device_seconds_under("sparse.gather") is None
    # a span wholly outside the window is dropped
    s = spans.Spans({"plan.build": [(2000, 3000, 1)]}, [], (0, 1000))
    assert s.seconds("plan.build") is None
    assert spans.Spans.of(None) is None


def test_read_joins_operations_to_their_launches():
    events = [
        Event("bench.window", CPU, 0, 1000, corr=1),
        Event("generate.lm", CPU, 100, 400, corr=2),
        Event("aten::mm", CPU, 110, 20, corr=60),          # torch op: no join
        Event("cudaLaunchKernel", CPU, 120, 5, corr=60),
        Event("cudaGraphLaunch", CPU, 300, 10, corr=61),
        Event("cudaMemcpyAsync", CPU, 600, 10, corr=62),
        Event("gemm_kernel", CUDA, 130, 50, corr=60),
        Event("graph_kernel", CUDA, 320, 60, corr=61),
        Event("graph_kernel_2", CUDA, 380, 40, corr=61),
        Event("Memcpy HtoD", CUDA, 610, 30, corr=62),
        Event("generate.lm", CUDA, 130, 290, corr=2, ann=True),  # its copy
    ]
    s = spans.Spans.read(_prof(events), (0, 1000))
    assert set(s.spans) == {"generate.lm"}
    assert len(s.ops) == 4
    assert s.device_seconds_under("generate.lm") == pytest.approx(150e-9)
    assert s.seconds("generate.lm") == pytest.approx(400e-9)


def test_of_reads_the_profile_once():
    events = [Event("plan.build", CPU, 0, 10)]
    p = types.SimpleNamespace(_prof=_prof(events), window_ns=(0, 100))
    first = spans.Spans.of(p)
    events.append(Event("plan.build", CPU, 20, 10))
    assert spans.Spans.of(p) is first
    assert first.seconds("plan.build") == pytest.approx(10e-9)


def _view(cell, s, busy=1e-6, window_s=1e-6):
    p = types.SimpleNamespace(_spans=s, busy_s=lambda: busy,
                              window_s=window_s)
    return harness.RunView(harness.Cell.load(cell), window_s, p, None, {},
                           {"queries": 4}, {})


@pytest.mark.parametrize("metric,names,value", [
    ("experiment.measures_share.batch", ("experiment.measures",), 0.25),
    ("experiment.plan_build_share.batch", ("plan.build",), 0.25),
])
def test_host_share_readers(metric, names, value):
    s = spans.Spans({names[0]: [(0, 150, 1), (100, 250, 1)]}, [],
                    (0, 1000))
    assert harness.load_reader(metric)(_view("rq2-fat.t250", s)) == \
        pytest.approx(value)


def test_gather_scatter_reader():
    ops = [(5, 1, 0, 100), (15, 1, 100, 300), (25, 1, 300, 400)]
    s = spans.Spans({"sparse.gather": [(0, 10, 1)],
                     "sparse.scatter": [(10, 20, 1)]}, ops, (0, 1000))
    read = harness.load_reader("sparse_ops.gather_scatter_share.batch")
    assert read(_view("rq2-fat.t250", s, busy=400e-9)) == pytest.approx(0.75)
