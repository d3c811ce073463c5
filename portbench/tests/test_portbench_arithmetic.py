"""The metric arithmetic on synthetic numbers: the idle share as the union
of device intervals over the whole traced window, the window's rate, and
the 95th percentile over every frame."""

import json
import statistics

import numpy as np
import pytest

from portbench.harness import check, stats, trace


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                         (4.0, 5.0)]
    assert stats.union_length(stats.clip(iv, 0.5, 3.5)) == \
        pytest.approx(2.0)


def _chrome(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_idle_share_counts_host_time_before_and_after(tmp_path):
    # Window 1000..2000 us; kernels cover 1200-1400 and 1300-1500 (union
    # 300 us) and one outside the window; idle = 1 - 300/1000.
    ev = [{"ph": "X", "name": trace.ANNOTATION, "cat": "user_annotation",
           "ts": 1000, "dur": 1000},
          {"ph": "X", "name": "k1", "cat": "kernel", "ts": 1200, "dur": 200},
          {"ph": "X", "name": "k2", "cat": "kernel", "ts": 1300, "dur": 200},
          {"ph": "X", "name": "k3", "cat": "kernel", "ts": 5000, "dur": 50},
          {"ph": "X", "name": "memcpy", "cat": "gpu_memcpy", "ts": 1900,
           "dur": 100},
          {"ph": "X", "name": "aten::add", "cat": "cpu_op", "ts": 1550,
           "dur": 300}]
    tr = trace.read_chrome_trace(_chrome(tmp_path, ev), units=2)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(400e-6)
    assert len(tr.kernels) == 2
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] in ("k1", "k2", "memcpy")
    longest = bd["idle_gaps"][0]
    assert longest[0] == "host: aten::add"
    assert longest[1] == pytest.approx(400e-6)


def test_window_rate_and_p95():
    assert stats.window_rate(100.0, 10.0, 12.0) == pytest.approx(50.0)
    assert stats.window_rate(0.0, 10.0, 12.0) is None
    rng = np.random.default_rng(0)
    xs = rng.exponential(size=401)
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert stats.percentile([3.0], 95) == 3.0


def test_spread_is_quartiles_over_median():
    xs = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def test_comparisons():
    import torch

    ref = torch.tensor([[1.0, 1.0, 1.0], [0.0, 0.0, 0.0], [2.0, 2.0, 2.0]],
                       dtype=torch.float64)
    got = ref.clone().float()
    got[1, 0] = 1e-3                       # beyond atol
    got[2, 2] = 2.0 * (1 + 5e-4)           # inside rtol
    assert check.pixel_mismatch_share(got, ref, 1e-4, 1e-3) == \
        pytest.approx(1 / 3)
    got[0, 0] = float("nan")
    assert check.pixel_mismatch_share(got, ref, 1e-4, 1e-3) == \
        pytest.approx(2 / 3)
    assert check.loss_gap([1.01, 2.0], [1.0, 2.0]) == pytest.approx(0.01)
    a = {"x": torch.ones(4), "y": torch.full((2,), 10.0),
         "z": torch.zeros(3)}
    b = {"x": torch.ones(4) * 1.1, "y": torch.full((2,), 10.0),
         "z": torch.full((3,), 1e-6)}
    # x: |2.2 - 2| over max(2, median 2) = 0.1.
    assert check.leaf_gap(b, a) == pytest.approx(0.1, rel=1e-6)
    assert check.moving_leaves(a) == ["x", "y"]
    # The median leaf by the reference's norm is x (z 0, x 2, y 14.1).
    assert check.median_leaf(a) == "x"
    assert check.leaf_gap(b, a, [check.median_leaf(a)]) == \
        pytest.approx(0.1, rel=1e-6)
    assert check.median_leaf({"p": torch.ones(1), "q": torch.ones(2)}) == "p"
    judged = check.judge({"n": 0.5}, {"n": 1.0, "m": 2.0})
    assert judged["n"]["ok"] and not judged["m"]["ok"]
