"""tools/batch_bench.py — the reference battery harness (batch.py:105-164).

Runs the harness end-to-end on a tiny procedural domain (CPU, XLA rows only;
the CUDA rows need a GPU). Checks the CSV contract and that the battery's three solver families
agree on what the reference battery measures: percent-valid and iteration
bookkeeping.
"""

import csv
import importlib
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

batch_bench = importlib.import_module("batch_bench")

from epic_tpu import maps, native  # noqa: E402
from epic_tpu.config import EpicConfig, SolverConfig  # noqa: E402


@pytest.fixture()
def tiny_domain(monkeypatch):
    img = maps.recursive_maze(48, 48, seed=4)
    monkeypatch.setitem(batch_bench.DOMAINS, "tiny", img.shape)
    monkeypatch.setattr(batch_bench, "load_domain",
                        lambda name: img if name == "tiny" else None)
    return img


def test_battery_csv_contract(tiny_domain, tmp_path):
    out = tmp_path / "results.csv"
    cfg = EpicConfig(solver=SolverConfig(epsilon=1e-2, backend="xla"))
    batch_bench.run("tiny", cfg, str(out))

    rows = list(csv.DictReader(open(out)))
    solvers = {r["Solver"] for r in rows}
    assert {"cpu_sor_f32", "cpu_sor_f64"} <= solvers
    if native.available():
        assert "log_native_cpu" in solvers
    assert any(s.startswith("log_xla") for s in solvers)

    for r in rows:
        assert r["Domain"] == "tiny"
        assert 0.0 <= float(r["Percent Valid"]) <= 1.0
        assert float(r["Time to Converge"]) > 0
        assert int(r["Iterations"]) > 0

    # The battery's point: log-space rows are valid where SOR collapses or
    # at least never worse (reference batch.py's percent-valid column).
    pv = {r["Solver"]: float(r["Percent Valid"]) for r in rows}
    log_rows = [v for k, v in pv.items() if k.startswith("log_")]
    assert all(v >= pv["cpu_sor_f32"] - 1e-9 for v in log_rows)

    # Native and XLA run the identical protocol: iteration counts equal.
    if native.available():
        iters = {r["Solver"]: int(r["Iterations"]) for r in rows}
        xla_key = next(k for k in iters if k.startswith("log_xla"))
        assert iters["log_native_cpu"] == iters[xla_key]


def test_battery_all_domains_loop(tiny_domain, tmp_path, monkeypatch):
    # `--domain all` iterates the registry; shrink it to the tiny fixture to
    # keep the test hermetic and fast.
    monkeypatch.setattr(batch_bench, "DOMAINS", {"tiny": tiny_domain.shape})
    out = tmp_path / "all.csv"
    cfg = EpicConfig(solver=SolverConfig(epsilon=1e-2, backend="xla"))
    batch_bench.run("all", cfg, str(out))
    rows = list(csv.DictReader(open(out)))
    assert {r["Domain"] for r in rows} == {"tiny"}
