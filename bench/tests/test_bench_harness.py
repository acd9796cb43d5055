"""A run of each cell with the chip's look skipped: the program's plain
path on the CPU at a small size, sound and with the timed path broken
underneath.  A sound run is correct; each fault makes it incorrect."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import run as bench_run  # noqa: E402

# Each cell at a size the CPU mines in a second; the minsups keep the
# mix's shape (one rung, or four in turn).  "ladder" is the Kosarak
# configuration under ``traffic/ladder.json``, a mix kept for a later
# cell; "declat" the same configuration mined with diffsets.
# "tabular" is the dense tabular family (``tabular.json`` beside this
# file) mined with diffsets at 0.28: a dense dEclat lattice, nearly every
# candidate frequent (some seconds a job on the CPU).
SMALL = {
    "kosarak-eclat.deep": (4000, [0.004]),
    "declat": (3000, [0.01]),
    "ladder": (6000, [0.02, 0.04, 0.08, 0.16]),
    "tabular": (3000, [0.28]),
}


def small_cell(name):
    cell = bench_run.load_cell("kosarak-eclat.deep")
    if name == "ladder":
        cell.traffic = json.loads(
            (ROOT / "bench" / "traffic" / "ladder.json").read_text())
    elif name == "declat":
        cell.config = dict(cell.config,
                           miner=dict(cell.config["miner"], scheme="declat"))
    elif name == "tabular":
        cell.config = json.loads(
            (ROOT / "bench" / "tests" / "tabular.json").read_text())
    n_trans, rel = SMALL[name]
    cell.config = dict(cell.config, n_trans=n_trans)
    cell.traffic = dict(cell.traffic, minsup_rel=rel)
    return cell


def correct(out):
    return all(c["value"] <= c["limit"]
               for c in bench_run.check_lines(out).values())


def run_small(name, seed=2**32 + 5, trace=False, seconds=0.05):
    return bench_run.run_cell(small_cell(name), seed, seconds, trace,
                              device="cpu")


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct(name):
    out = run_small(name, trace=True, seconds=3.0)
    assert correct(out) and out.mismatched == 0
    order = bench_run.job_minsups(small_cell(name), SMALL[name][0])
    assert len(out.jobs) >= len(order)
    assert [j.minsup for j in out.jobs[:len(order)]] == order
    checked = [j for j in out.jobs if j.itemsets is not None]
    assert 0 < len(checked) <= bench_run.CHECKED_JOBS
    assert all(len(j.itemsets) > 1 for j in checked)
    assert out.needed_bytes and all(b > 0 for b in out.needed_bytes)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    out.peaks = json.loads((ROOT / "bench" / "peaks.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        value = bench_run.reader(m["name"])(out)
        # on the CPU the trace's and the card's readings are absent
        assert value is None or value >= 0, m["name"]
    assert bench_run.reader("mine_s")(out) > 0


def _alter_an_answer(monkeypatch):
    from repro_torch.core import eclat
    real = eclat.PendingPairResult.resolve

    def resolve(self):
        out = real(self)
        if out:
            ki, slot, sup, extra = out[0]
            out[0] = (ki, slot, sup + 1, extra)
        return out
    monkeypatch.setattr(eclat.PendingPairResult, "resolve", resolve)


def _drop_half_the_batch(monkeypatch):
    from repro_torch.core import eclat
    real = eclat.BitmapMiner.evaluate_pairs

    def evaluate_pairs(self, cols):
        n = cols["ua"].size
        return real(self, {k: v[: (n + 1) // 2] for k, v in cols.items()})
    monkeypatch.setattr(eclat.BitmapMiner, "evaluate_pairs", evaluate_pairs)


def _state_unchanged(monkeypatch):
    from repro_torch.core import frontier
    monkeypatch.setattr(frontier.FrontierScheduler, "run",
                        lambda self, root: None)


FAULTS = {"answer altered": _alter_an_answer,
          "half the batch left out": _drop_half_the_batch,
          "step returns its state unchanged": _state_unchanged}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_broken_timed_path_is_incorrect(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    out = run_small(name)
    assert not correct(out)
    checked = [j for j in out.jobs if j.itemsets is not None]
    assert out.jobs_wrong == len(checked) > 0


def test_the_checked_jobs_are_a_sample_drawn_from_the_seed(monkeypatch):
    monkeypatch.setattr(bench_run, "CHECKED_JOBS", 3)

    cell = small_cell("ladder")
    cell.config = dict(cell.config, n_trans=1000)
    cell.traffic = dict(cell.traffic, minsup_rel=[0.1, 0.2])

    def picked(seed):
        out = bench_run.run_cell(cell, seed, 2.0, False, device="cpu")
        assert len(out.jobs) > 6 and correct(out)
        return [i for i, j in enumerate(out.jobs) if j.itemsets is not None]
    a = picked(2**31 + 1)
    assert len(a) == 3
    assert a != list(range(3)) or picked(2**31 + 2) != a


def test_the_check_numbers_come_last():
    out = run_small("kosarak-eclat.deep")
    checks = bench_run.check_lines(out)
    assert list(checks) == ["mismatched_itemsets", "jobs_wrong"]
    assert all(set(c) == {"value", "limit"} for c in checks.values())


def test_no_card_no_result(capsys):
    """Without CUDA the run exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    rc = bench_run.main(["--workload", "kosarak-eclat.deep", "--seed", "1",
                         "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    gives no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "kosarak-eclat.deep",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_spec_names_files_that_exist():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for conf in spec["configs"]:
        assert (ROOT / conf["file"]).is_file()
    for w in spec["workloads"]:
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench_run.reader(m["name"]))


def test_seeds_shuffle_the_same_database():
    cell = small_cell("kosarak-eclat.deep")
    a = run_small("kosarak-eclat.deep", seed=1)
    b = run_small("kosarak-eclat.deep", seed=2**40 + 3)
    sizes = [sorted(out.jobs[0].itemsets.values()) for out in (a, b)]
    assert sizes[0] == sizes[1] and correct(a) and correct(b)
    assert cell.config["data_seed"] == 0
    assert np.isfinite(a.setup_s)
