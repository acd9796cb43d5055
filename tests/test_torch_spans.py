"""The program spans of the port's mining path (``repro_torch.core.spans``)
on the CPU: each one lands in an exported profiler trace as a
``user_annotation`` under its ``repro_torch.`` name, as often as the
work it covers happens, nested as documented; with no profiler
recording no span site enters ``record_function`` and the counters are
those of a traced run."""

import json
from collections import Counter

import pytest
torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import spans  # noqa: E402
from repro_torch.core.bitmap import BitmapDB  # noqa: E402
from repro_torch.core.eclat import BitmapMiner  # noqa: E402
from repro_torch.data import transactions as tdata  # noqa: E402

# Each span and the program spans it may sit in (None: none); a
# ``sched.resolve`` sits in its group's ``sched.retire`` only when the
# ring defers the readback (inflight > 1).
PARENTS = {
    "store.init": {None},
    "store.upload": {"store.init"},
    "store.suffix": {"store.init"},
    "store.grow": {"sched.dispatch"},
    "store.compact": {None},
    "store.free": {"sched.resolve", "sched.retire"},
    "sched.assemble": {None},
    "sched.dispatch": {None},
    "sched.retire": {None},
    "sched.resolve": {"sched.retire", None},
}
TIMES = {"runtime_s", "assemble_s", "resolve_s"}
# Small chunks on a small slab, so a job grows and compacts the slab and
# makes about a hundred launches.
DB = tdata.gen_powerlaw_baskets(n_trans=300, n_items=200, avg_trans_len=6,
                                seed=0)
MINSUP = 3
JOBS = 2


def _mine(inflight):
    """``JOBS`` jobs of one miner: the maps and the stats of each."""
    miner = BitmapMiner(device="cpu", inflight=inflight, pair_chunk=64)
    bdb = BitmapDB.from_db(DB, MINSUP, 8)
    return [miner.mine_packed(bdb, MINSUP) for _ in range(JOBS)]


def _traced(inflight, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        jobs = _mine(inflight)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return jobs, events


def _counters(stats):
    return {k: v for k, v in stats.as_dict().items() if k not in TIMES}


@pytest.mark.parametrize("inflight", [1, 2])
def test_each_span_is_a_user_annotation_counted_with_its_work(inflight,
                                                              tmp_path):
    jobs, events = _traced(inflight, tmp_path)
    ours = [ev for ev in events if ev.get("ph") == "X"
            and ev.get("name", "").startswith(spans.PREFIX)]
    assert {ev["cat"] for ev in ours} == {"user_annotation"}
    n = Counter(ev["name"][len(spans.PREFIX):] for ev in ours)
    assert set(n) == set(PARENTS)
    stats = [st for _, st in jobs]
    assert n["store.init"] == JOBS
    assert n["sched.dispatch"] == sum(st.device_calls for st in stats)
    assert n["sched.resolve"] == n["sched.dispatch"]
    assert n["store.grow"] == sum(st.grows for st in stats) > 0
    assert n["store.compact"] == sum(st.compactions for st in stats) > 0
    assert n["sched.assemble"] == n["sched.retire"]


def _nest(events):
    """Each program span of a Chrome trace with its nearest enclosing
    program span (``None`` at the top) and its depth, in start order."""
    ours = sorted(((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                    ev["name"][len(spans.PREFIX):]) for ev in events
                   if ev.get("ph") == "X"
                   and ev.get("name", "").startswith(spans.PREFIX)),
                  key=lambda sp: (sp[0], -sp[1]))
    open_ = []                      # the enclosing spans, outermost first
    for s, e, name in ours:
        while open_ and open_[-1][1] <= s + 1e-3:
            open_.pop()
        yield name, (open_[-1][2] if open_ else None), len(open_) + 1
        assert not open_ or e <= open_[-1][1] + 1e-3, "spans overlap"
        open_.append((s, e, name))


@pytest.mark.parametrize("inflight", [1, 2])
def test_spans_nest_as_documented(inflight, tmp_path):
    _, events = _traced(inflight, tmp_path)
    seen = Counter()
    previous = None
    for name, parent, depth in _nest(events):
        assert parent in PARENTS[name], (name, parent)
        assert depth <= 3
        seen[(name, parent)] += 1
        if name == "sched.resolve" and parent is None:
            # serial mode resolves each chunk right after its dispatch
            assert previous == "sched.dispatch"
        if parent is None:
            previous = name
    assert (seen[("sched.resolve", "sched.retire")] > 0) == (inflight > 1)
    assert (seen[("sched.resolve", None)] > 0) == (inflight == 1)
    assert seen[("store.free", "sched.resolve")] > 0
    assert seen[("store.free", "sched.retire")] > 0


@pytest.mark.parametrize("inflight", [1, 2])
def test_groups_retire_in_the_order_they_were_assembled(inflight, tmp_path):
    """A reader pairs a drain group's spans by order: the k-th
    ``sched.retire`` retires the k-th ``sched.assemble``'s group, after
    it was assembled and before more than ``inflight`` later groups
    are."""
    _, events = _traced(inflight, tmp_path)
    ours = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                   ev["name"][len(spans.PREFIX):]) for ev in events
                  if ev.get("ph") == "X" and ev.get("name") in (
                      spans.PREFIX + "sched.assemble",
                      spans.PREFIX + "sched.retire"))
    assembled = [(s, e) for s, e, name in ours if name == "sched.assemble"]
    retired = [s for s, _, name in ours if name == "sched.retire"]
    assert len(retired) == len(assembled) > 2 * JOBS
    for k, start in enumerate(retired):
        assert start >= assembled[k][1]
        assert sum(s < start for s, _ in assembled) <= k + inflight


@pytest.mark.parametrize("inflight", [1, 2])
def test_no_span_is_entered_without_a_profiler(inflight, monkeypatch,
                                               tmp_path):
    traced = _traced(inflight, tmp_path)[0]

    def refuse(*_a, **_k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(spans, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert spans.span("sched.retire") is spans.span("store.init")
    plain = _mine(inflight)
    for (out, st), (t_out, t_st) in zip(plain, traced, strict=True):
        assert out == t_out
        assert _counters(st) == _counters(t_st)
        assert set(st.as_dict()) == set(t_st.as_dict())
