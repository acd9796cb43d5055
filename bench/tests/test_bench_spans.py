"""The span reductions (``bench/spans.py``) and the per-layer readers of
the program's spans, on hand-made trace summaries (times in the trace's
microseconds)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import spans  # noqa: E402
from bench import run as bench_run  # noqa: E402
from bench.devtrace import TraceSummary  # noqa: E402

TIMES = ("store_init_ms", "store_upload_ms", "store_grow_ms", "resolve_ms",
         "retire_ms", "idle_unattributed_ms")


def _summary(host, gaps=()):
    return TraceSummary(window_s=1.0, busy_s=0.0, device_ops={}, kernels=[],
                        gaps=list(gaps), host=sorted(host))


def _outcome(summary, jobs=2):
    return bench_run.Outcome(
        jobs=[bench_run.Job(990, 0.5, {}) for _ in range(jobs)],
        setup_s=1.0, window_s=1.0, peak_bytes=None, mismatched=0,
        jobs_wrong=0, trace=summary)


def _read(metric, out):
    return bench_run.reader(metric)(out)


# Two jobs' worth: a retirement holding a readback (which holds a free)
# and a free of its own; an init holding its upload; a grow that no
# other span covers.  An aten op and the harness's spans are not the
# program's.
HOST = [
    (0.0, 100.0, "repro_torch.store.init"),
    (10.0, 30.0, "repro_torch.store.upload"),
    (12.0, 14.0, "aten::copy_"),
    (200.0, 300.0, "repro_torch.sched.retire"),
    (210.0, 240.0, "repro_torch.sched.resolve"),
    (220.0, 225.0, "repro_torch.store.free"),
    (280.0, 290.0, "repro_torch.store.free"),
    (400.0, 1400.0, "repro_torch.store.grow"),
    (2000.0, 2500.0, "repro_torch.sched.retire"),
]


def test_totals_counts_and_self_time_with_nested_children():
    sp = spans.read(_summary(HOST))
    assert sp.count == {"store.init": 1, "store.upload": 1,
                        "sched.retire": 2, "sched.resolve": 1,
                        "store.free": 2, "store.grow": 1}
    assert sp.total_us["sched.retire"] == 600.0
    # 100 less the resolve (30, its free inside it) and the other free
    assert sp.self_us["sched.retire"] == 100.0 - 30.0 - 10.0 + 500.0
    assert sp.self_us["sched.resolve"] == 25.0
    assert sp.self_us["store.init"] == 80.0      # the aten op is no span
    out = _outcome(_summary(HOST))
    assert _read("retire_ms", out) == pytest.approx(560.0 / 1e3 / 2)
    assert _read("resolve_ms", out) == pytest.approx(30.0 / 1e3 / 2)
    assert _read("store_init_ms", out) == pytest.approx(100.0 / 1e3 / 2)
    assert _read("store_upload_ms", out) == pytest.approx(20.0 / 1e3 / 2)
    assert _read("store_grow_ms", out) == pytest.approx(1000.0 / 1e3 / 2)


def test_a_span_starting_with_its_parent_is_its_child():
    sp = spans.read(_summary([(5.0, 9.0, "repro_torch.sched.resolve"),
                              (5.0, 20.0, "repro_torch.sched.retire")]))
    assert sp.self_us == {"sched.retire": 11.0, "sched.resolve": 4.0}


def test_the_union_merges_overlapping_spans():
    host = [(0.0, 10.0, "repro_torch.a"), (5.0, 15.0, "repro_torch.b"),
            (15.0, 20.0, "repro_torch.c"), (30.0, 40.0, "repro_torch.d"),
            (32.0, 35.0, "repro_torch.e")]
    assert spans.read(_summary(host)).union == [(0.0, 20.0), (30.0, 40.0)]
    assert spans.union([]) == []


def test_a_gap_half_covered_by_a_span():
    host = [(50.0, 150.0, "repro_torch.sched.assemble"),
            (0.0, 100.0, "aten::empty")]
    out = _outcome(_summary(host, gaps=[(100.0, 200.0)]))
    # half the gap's 100 us is named, over two jobs
    assert _read("idle_unattributed_ms", out) == pytest.approx(50.0 / 1e3 / 2)
    # two gaps, one covered whole and one not at all; spans over busy
    # time count for nothing
    host = [(0.0, 10.0, "repro_torch.store.init"),
            (10.0, 60.0, "repro_torch.sched.retire")]
    out = _outcome(_summary(host, gaps=[(0.0, 30.0), (70.0, 80.0)]))
    assert _read("idle_unattributed_ms", out) == pytest.approx(10.0 / 1e3 / 2)
    assert spans.covered([(0.0, 30.0), (70.0, 80.0)],
                         [(0.0, 10.0), (10.0, 60.0)]) == 30.0


def test_without_program_spans_the_readers_find_nothing():
    out = _outcome(_summary([(0.0, 100.0, "aten::lift_fresh")],
                            gaps=[(100.0, 900.0)]))
    assert spans.read(out.trace) is None
    # a program without spans (the parent of the spans) reads nothing,
    # and so does an untraced run (or a CPU one), which has no trace
    for trace in (out.trace, None):
        out = _outcome(trace)
        for metric in TIMES:
            assert _read(metric, out) is None, metric


def test_a_name_absent_from_a_traced_run_reads_zero():
    out = _outcome(_summary([(0.0, 10.0, "repro_torch.store.init")]))
    assert _read("store_grow_ms", out) == 0.0
    assert _read("idle_unattributed_ms", out) == 0.0     # no idle time
