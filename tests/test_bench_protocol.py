"""Pin bench.py's measurement protocol (ramp-discard medians).

The first trials after a compile warm caches and allocators, so the
headline QPS is the median over the post-ramp trials only, with the
ramp trials recorded separately.
"""

import sys
import os

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench


def _fake_bench_fn(qps_sequence):
    """bench_fn stub: returns rows with a scripted qps series and a
    perfect-recall ids/dists payload (gt == ids)."""
    nq, k = 8, 10
    ids = np.tile(np.arange(k, dtype=np.int64), (nq, 1))
    dists = -np.ones((nq, k), np.float32) * np.arange(1, k + 1)
    calls = {"n": 0, "warmups": []}

    def fn(warmup):
        i = min(calls["n"], len(qps_sequence) - 1)
        calls["n"] += 1
        calls["warmups"].append(warmup)
        return {"qps": qps_sequence[i], "ids": ids, "dists": dists,
                "mean_latency_ms": 1.0}

    return fn, ids, dists, calls


def test_ramp_trials_excluded_from_median():
    # 2 ramp trials (one an outlier burst) then a 3-trial plateau:
    # the median must come from the plateau only.
    seq = [300_000.0, 10_000.0, 40_000.0, 41_000.0, 42_000.0]
    fn, ids, dists, calls = _fake_bench_fn(seq)
    row = bench._bench_median(fn, ids, dists, k=10, repeats=3, ramp=2)
    assert row["qps"] == 41_000.0
    assert row["qps_min"] == 40_000.0 and row["qps_max"] == 42_000.0
    # ramp trials recorded, not medianed
    assert row["qps_ramp"] == [300_000.0, 10_000.0]
    # exactly ramp + repeats invocations; only the first warms compile
    assert calls["n"] == 5
    assert calls["warmups"] == [1, 0, 0, 0, 0]


def test_row_metrics_attached_and_arrays_stripped():
    seq = [1.0, 2.0, 3.0, 4.0, 5.0]
    fn, ids, dists, _ = _fake_bench_fn(seq)
    row = bench._bench_median(fn, ids, dists, k=10, repeats=3, ramp=2)
    # gt == ids -> perfect recall, zero rderr
    assert row["recall"] == 1.0
    assert abs(row["rderr"]) < 1e-12
    assert "ids" not in row and "dists" not in row
    assert row["mean_latency_ms"] == 1.0


def test_headline_is_compact_and_tags_provisional():
    # a caller may record only a bounded stdout tail and may kill the
    # run mid-build — bench.py prints a PROVISIONAL headline right after
    # the flat rows (no index needed) so a timeout still leaves the
    # number in the tail. Both the provisional and final lines must be
    # compact and carry vs_baseline.
    prov = bench._headline(70729.5, 25418.0,
                           {"mode": "flat", "recall": 0.9866},
                           provisional=True)
    assert prov["provisional"] is True
    assert prov["vs_baseline"] == round(70729.5 / 25418.0, 3)
    assert prov["unit"] == "QPS" and prov["value"] == 70729.5
    final = bench._headline(70729.5, 25418.0, {"mode": "flat"})
    assert "provisional" not in final
    import json
    assert len(json.dumps(final)) < 600  # fits a bounded output tail

    # zero/absent baseline must not divide by zero
    assert bench._headline(1.0, 0.0, {})["vs_baseline"] == 0.0


def test_bench_repeats_default_is_median_of_five():
    # headline rows are medians of five post-ramp trials
    assert bench.REPEATS == 5


def test_bench_rows_carry_sorted_trials():
    # rows expose their sorted post-ramp trials next to the median
    seq = [9.0, 9.0, 30.0, 10.0, 20.0]
    fn, ids, dists, _ = _fake_bench_fn(seq)
    row = bench._bench_median(fn, ids, dists, k=10, repeats=3, ramp=2)
    assert row["qps_trials"] == [10.0, 20.0, 30.0]
    assert row["qps"] == 20.0
