"""The metric arithmetic on synthetic numbers: the idle share as the union
of device intervals over the whole traced window, the window's rate, and
the 95th percentile over every frame."""

import json
import statistics

import numpy as np
import pytest

from portbench.harness import check, manifest, runner, stats, trace


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


def test_compare_steps_gives_each_leaf_its_first_gradient_gap():
    import torch

    ref = {"losses": [1.0, 0.9, 0.8],
           "grad": {"scene/albedo": torch.ones(4),
                    "scene/emission": torch.full((2,), 10.0),
                    "camera/translate": torch.full((3,), 1e-3)},
           "change": {"scene/albedo": torch.ones(4),
                      "scene/emission": torch.ones(2),
                      "camera/translate": torch.ones(3)}}
    got = {"losses": [1.0, 0.9, 0.8],
           "grad": {"scene/albedo": torch.ones(4) * 1.1,
                    "scene/emission": torch.full((2,), 10.0),
                    "camera/translate": torch.full((3,), 3e-3)},
           "change": ref["change"]}
    out = runner.compare_steps(got, ref)
    # Over the median leaf's norm, 2: albedo |2.2 - 2| / 2; translate
    # |3e-3 - 1e-3| sqrt(3) / 2, its own norm being below the median's.
    assert out["grad_gap[scene/albedo]"] == pytest.approx(0.1, rel=1e-6)
    assert out["grad_gap[scene/emission]"] == 0.0
    assert out["grad_gap[camera/translate]"] == \
        pytest.approx(1e-3 * 3 ** 0.5, rel=1e-5)
    for leaf in ref["grad"]:
        assert out[f"grad_gap[{leaf}]"] == \
            check.leaf_gap(got["grad"], ref["grad"], [leaf])
    assert out["grad_gap"] == max(out[f"grad_gap[{k}]"] for k in ref["grad"])
    assert list(out).index("grad_gap[scene/albedo]") == \
        list(out).index("grad_gap_median") + 1
    # Only the numbers a configuration's limits name are judged.
    assert set(check.judge(out, {"loss1_gap": 0.005})) == {"loss1_gap"}


def _ranks(*per_rank):
    """A sharded run's stand-in: one Trace of two steps a rank."""
    return type("R", (), {"rank_traces": [
        trace.Trace(0.0, 1.0, units=2, kernels=list(k)) for k in per_rank]})()


def test_allreduce_ms_reads_nccl_kernels_alone():
    # NCCL's kernels by name, in any case, and no other; collective by
    # collective the rank that spins least sets the transfer, even where
    # each rank waits at another one: (0.3 + 0.2) ms over two steps.
    other = [("void fused_hit_kernel<true, false>(...)", 0.3, 5e-3),
             ("at::native::ncclish_elementwise", 0.4, 7e-3)]
    nccl = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)"
    rank0 = other + [(nccl, 0.1, 3e-4), ("NCCLKernel_x", 0.2, 2e-4)]
    rank1 = [(nccl, 0.1, 9e-4), ("NCCLKernel_x", 0.2, 8e-4)] + other
    rank2 = [(nccl, 0.1, 3e-4), ("NCCLKernel_x", 0.2, 5e-3)] + other
    rank3 = [(nccl, 0.1, 4e-3), ("NCCLKernel_x", 0.2, 2e-4)] + other
    read = manifest.metric_module("allreduce_ms_per_step").read
    assert read(_ranks(rank0, rank1)) == pytest.approx(0.25)
    assert read(_ranks(rank1, rank0)) == pytest.approx(0.25)
    assert read(_ranks(rank2, rank3)) == pytest.approx(0.25)
    # A lost record: the smallest rank's whole NCCL time, (0.9 + 0.8) ms.
    assert read(_ranks(rank1, rank3[:1] + other)) == pytest.approx(0.85)
    # Where a rank's trace holds none of them there is nothing to read.
    assert read(_ranks(rank0, other)) is None
    assert read(_ranks()) is None


def test_allreduce_wait_is_the_spin_beyond_the_transfer():
    # Ranks spin 0.5, 1.7 and 0.5 ms over two steps: the mean over the
    # ranks of what lies beyond the transfer, 0.5 ms: 0.4 ms over two.
    def rank(ms):
        return [("ncclDevKernel_AllReduce", 0.1, ms * 1e-3),
                ("void at::native::elementwise_kernel", 0.3, 5e-3)]

    read = manifest.metric_module("allreduce_wait_ms_per_step").read
    assert read(_ranks(rank(0.5), rank(1.7), rank(0.5))) == \
        pytest.approx(0.2)
    assert read(_ranks(rank(0.5), rank(0.5))) == pytest.approx(0.0)
    assert read(_ranks(rank(0.5))) is None
    assert read(_ranks(rank(0.5), [])) is None


def test_device_part_keeps_the_device_operations():
    tr = trace.Trace(0.0, 1.0, units=1,
                     kernels=[("k", 0.1, 0.2), ("k", 0.5, 0.1)],
                     other_ops=[("Memcpy DtoH", 0.7, 0.1)],
                     host_ops=[("aten::mul", 0.0, 0.9)])
    part = tr.device_part()
    assert (part.lo, part.hi, part.units) == (0.0, 1.0, 1)
    assert part.kernels == tr.kernels and part.other_ops == tr.other_ops
    assert part.host_ops == [] and part.busy_s == pytest.approx(tr.busy_s)


def test_rank_cores_split_the_cores_nearest_each_card():
    from portbench.harness import ranks

    allowed = list(range(32))
    # Two NUMA nodes of 16 cores, two cards on each: 8 cores a rank.
    node = [set(range(16)), set(range(16, 32))]
    near = [node[0], node[0], node[1], node[1]]
    got = [ranks.rank_cores(r, near, allowed) for r in range(4)]
    assert got == [list(range(0, 8)), list(range(8, 16)),
                   list(range(16, 24)), list(range(24, 32))]
    # No node read, or one outside the allowed cores: every allowed core,
    # split in rank order.
    for near in ([set()] * 4, [set(range(64, 96))] * 4):
        got = [ranks.rank_cores(r, near, list(range(4, 12)))
               for r in range(4)]
        assert got == [[4, 5], [6, 7], [8, 9], [10, 11]]
    # Fewer cores than ranks: no share, and the rank is left unpinned.
    assert ranks.rank_cores(3, [set()] * 4, [0, 1]) == []
    assert ranks._cpulist("0-2,8,10-11\n") == {0, 1, 2, 8, 10, 11}


def test_step_line_reads_quartiles_and_each_rank():
    from portbench.harness import ranks

    line = ranks.step_line([0.5, 0.6, 0.7, 0.8, 0.9],
                           [[0.4, 0.5, 0.6], [0.3], []])
    assert "5 steps" in line and "min 0.5000" in line
    assert "max 0.9000" in line
    assert line.endswith("0.5000, 0.3000, -")
