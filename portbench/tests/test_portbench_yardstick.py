"""The frozen bounds, the counts of work and the trace reduction against
hand counts at small shapes."""

import pytest

from portbench import trace as T
from portbench.yardstick import bounds as B
from portbench.yardstick import work as W


def test_kernel_matrix_bound_counts_by_hand():
    # K(Z, Z) at n = 4, d = 2: 10 distinct entries, 4·(8 + 16) bytes, 10·(4 + 12) operations
    b = B.kernel_matrix_bound(1, 4, 4, 2, True)
    assert (b["bytes"], b["ops"], b["bound_by"]) == (96, 160, "bytes")
    assert b["bound_ms"] == pytest.approx(1e3 * 96 / 3.35e12)
    # a 3 × 5 cross at d = 2: 15 entries, 4·(6 + 10 + 15) bytes
    c = B.kernel_matrix_bound(2, 3, 5, 2, False)
    assert (c["bytes"], c["ops"]) == (2 * 4 * 31, 2 * 15 * 16)


def test_ts_cov_bound_counts_by_hand():
    # m = 3, n = 5, d = 2: 6 distinct entries, 4·(6 + 15 + 9) bytes, 6·(2·7 + 12) operations
    b = B.ts_cov_bound(1, 3, 5, 2)
    assert (b["bytes"], b["ops"]) == (120, 156)
    big = B.ts_cov_bound(1, 1000, 16384, 10)
    assert big["bound_by"] == "operations"


def test_work_of_a_fitting_loop_batch():
    # N = 4, d = 2, q = 2, 6 candidates, 5 Adam steps
    w = W.pathwise_batch(4, 2, 2, 6, 5)
    assert w["flops"] == pytest.approx(64 / 3 + 2 * 16 * 2 + 5 * (64 / 3 + 128 / 3))
    assert len(w["kernel_matrix"]) == 7 and not w["ts_cov"]
    assert w["kernel_matrix"][0] == B.kernel_matrix_bound(1, 4, 4, 2, True)
    assert w["kernel_matrix"][-1] == B.kernel_matrix_bound(1, 6, 4, 2, False)
    pinned = W.pathwise_batch(4, 2, 2, 6, 0)
    assert pinned["flops"] == pytest.approx(64 / 3 + 64) and len(pinned["kernel_matrix"]) == 2


def test_work_of_an_exact_suggestion():
    w = W.exact_ts_batch(4, 2, 6, 3)
    # the solve over 6 candidates (16·6), per chunk of 3 the upper vᵀv (4·3·4) and its Cholesky (9)
    assert w["flops"] == pytest.approx(96 + 2 * (48 + 9))
    assert w["ts_cov"] == [B.ts_cov_bound(1, 3, 4, 2)] * 2
    assert w["kernel_matrix"] == [B.kernel_matrix_bound(1, 4, 3, 2, False)] * 2


def _trace():
    ops = [T.DeviceOp("void kernel_matrix_tile<float, 3, true>", 100, 200, 1, "kernel"),
           T.DeviceOp("sm80_xmma_gemm_f32", 150, 400, 2, "kernel"),
           T.DeviceOp("Memcpy HtoD", 600, 700, 3, "memcpy"),
           T.DeviceOp("potrf_kernel", 800, 900, 4, "kernel")]
    launch = {1: 10, 2: 60, 3: 500, 4: 590}
    spans = [T.Span("gp.polish_backward", 50, 80), T.Span("gp.polish_backward", 550, 595)]
    host = [T.Span("aten::mm", 400, 650), T.Span("aten::add", 700, 790)]
    return T.Trace(ops, launch, spans, host, (0, 1000))


def test_trace_reduction():
    t = _trace()
    assert T.busy_intervals(t) == [(100, 400), (600, 700), (800, 900)]
    assert T.busy_s(t) == pytest.approx(500e-9) and T.window_s(t) == pytest.approx(1e-6)
    assert [o.correlation for o in T.launched_under(t, "gp.polish_backward")] == [2, 4]
    assert [o.correlation for o in T.kernels(t, ("gemm", "potrf"))] == [2, 4]
    br = T.breakdown(t)
    assert br["device_ops"][0] == ["sm80_xmma_gemm_f32", pytest.approx(250e-9)]
    assert dict((n, s) for n, s in br["idle_gaps"]) == pytest.approx(
        {"host": 100e-9 + 100e-9, "aten::mm": 200e-9, "aten::add": 100e-9})


def test_metric_readers_on_a_known_trace():
    from portbench import manifest

    t = _trace()
    batches = [{"n": 4, "fit": True}, {"n": 4, "fit": True}]
    work = [W.pathwise_batch(4, 2, 2, 6, 1) for b in batches]
    run = T.Run({"dim": 2}, {"entry": "loop"}, batches, work, t)

    def read(name):
        return manifest.metric_reader(name)(run)

    assert read("launches_per_batch") == 1.5
    assert read("device_idle") == pytest.approx(50.0)
    assert read("fit_backward_ms") == pytest.approx(1e3 * 350e-9 / 2)
    assert read("linalg_ms") == pytest.approx(1e3 * 350e-9 / 2)
    need = sum(b["bound_ms"] for w in work for b in w["kernel_matrix"])
    assert read("kernel_matrix_roofline") == pytest.approx(100 * need / 1e3 / 100e-9)
    assert read("ts_cov_roofline") is None
    assert read("step_mfu") == pytest.approx(100 * sum(w["flops"] for w in work) / (1e-6 * 67e12))
