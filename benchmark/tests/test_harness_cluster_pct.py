"""``kernel.eig_chunk_cluster_pct`` on synthetic traces: the share of the
``eig_chunk`` kernel events that ran the cluster layout, and no reading
from a trace without ``eig_chunk`` events or without a trace."""

import pytest

from harness_helpers import BENCH  # noqa: F401 (puts arpobench on the path)

from arpobench import cells, harness

NAME = "kernel.eig_chunk_cluster_pct"


def _k(name, cat="kernel"):
    return dict(ph="X", pid=2, tid=2, cat=cat, name=name, ts=0, dur=10)


def _run(events):
    t = dict(events=events, n_steps=1, launches={}, agg=None, span_done=None)
    return harness.RunView({}, t, None, None)


def test_the_share_of_cluster_events():
    events = [
        _k("void (anonymous namespace)::eig_chunk_kernel<float, 1>(...)"),
        _k("void (anonymous namespace)::eig_chunk_kernel<float, 8>(...)"),
        _k("void (anonymous namespace)::eig_chunk_kernel_cluster<float, 8>"
           "(...)"),
        _k("void (anonymous namespace)::eig_chunk_kernel_cluster<float, 2>"
           "(...)"),
        _k("void at::native::elementwise_kernel<128, 2>(...)"),
        # host-side records of the launch are not device events
        _k("eig_chunk_kernel_cluster", cat="cuda_runtime"),
        dict(_k("eig_chunk_kernel_cluster<float, 4>"), ph="i"),
    ]
    read = cells.metric_readers()[NAME].read
    assert read(_run(events)) == pytest.approx(50.0)
    assert read(_run(events[:2])) == 0.0
    assert read(_run(events[2:4])) == 100.0


def test_no_eig_chunk_events_no_reading():
    read = cells.metric_readers()[NAME].read
    assert cells.metric_readers()[NAME].UNIT == "%"
    assert read(_run([_k("void at::native::elementwise_kernel<128, 2>()")])) \
        is None
    assert read(_run([])) is None
    assert read(harness.RunView({}, None, None, None)) is None
