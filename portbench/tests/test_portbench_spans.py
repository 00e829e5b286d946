"""The span metrics (``portbench/spans.py`` and their readers) on a trace
built by hand, and on traced tiny runs of the cells on the CPU."""

import pytest

from portbench import manifest, run
from portbench import spans as S
from portbench import trace as T
from portbench.tests import tiny

SPAN_METRICS = ("syncs_per_batch", "sync_idle_ms", "caller_idle_ms", "sampler_ms", "factor_ms",
                "loss_evals_per_fit", "ladder_rungs_per_factor")


def _trace(with_batches=True):
    """Two iterations. Busy 0-100, 150-300, 400-500, 700-800, 900-950 of a
    window 0-1000: gaps starting at 100 (in a sync span), 300 (outside
    every span), 500 (in a callback), 800 (in a sync span) and 950
    (elsewhere in the second iteration)."""
    ops = [T.DeviceOp("kernel_matrix_tile", 0, 100, 1, "kernel"), T.DeviceOp("ts_cov_partial", 150, 300, 2, "kernel"),
           T.DeviceOp("Memcpy DtoH", 400, 500, 3, "memcpy"), T.DeviceOp("sm80_xmma_gemm", 700, 800, 4, "kernel"),
           T.DeviceOp("elementwise", 900, 950, 5, "kernel")]
    launch = {1: 8, 2: 145, 3: 390, 4: 650, 5: 890}
    spans = [T.Span("gp.factor", 5, 40), T.Span("linalg.cholesky_ladder", 6, 170),
             T.Span("linalg.cholesky_rung", 7, 30), T.Span("linalg.cholesky_rung", 60, 80),
             T.Span("sync.linalg.ladder", 90, 160), T.Span("acq.sample", 140, 280),
             T.Span("gp.loss", 10, 20), T.Span("gp.loss", 30, 35), T.Span("gp.loss", 36, 38),
             T.Span("bo.callback", 480, 550), T.Span("acq.sample", 645, 700),
             T.Span("sync.bo.incumbent", 790, 810), T.Span("portbench.window", 0, 1000)]
    if with_batches:
        spans += [T.Span("bo.iteration", 0, 290), T.Span("bo.iteration", 380, 1000)]
    return T.Trace(ops, launch, spans, [], (0, 1000))


def _run(trace):
    batches = [{"n": 4, "fit": True}, {"n": 4, "fit": False}]
    return T.Run({"dim": 2}, {"entry": "loop"}, batches, [{} for _ in batches], trace)


def test_idle_gaps_belong_to_the_innermost_span_at_their_start():
    t = _trace()
    assert S.idle_gaps(t) == [(100, 150), (300, 400), (500, 700), (800, 900), (950, 1000)]
    assert S.idle_by_owner(t) == {"sync": 50 + 100, "caller": 100 + 200, "program": 50}
    assert S.count(t, "sync.") == 2 and S.count(t, "gp.loss") == 3 and S.marks_batches(t)


def test_span_readers_on_a_known_trace():
    run_ = _run(_trace())

    def read(name):
        return manifest.metric_reader(name)(run_)

    assert read("syncs_per_batch") == 1.0
    assert read("sync_idle_ms") == pytest.approx(1e3 * 150e-9 / 2)
    assert read("caller_idle_ms") == pytest.approx(1e3 * 300e-9 / 2)
    assert read("sampler_ms") == pytest.approx(1e3 * (150 + 100) * 1e-9 / 2)
    assert read("factor_ms") == pytest.approx(1e3 * 100e-9 / 2)
    assert read("loss_evals_per_fit") == 3.0
    assert read("ladder_rungs_per_factor") == 2.0
    idle_ms = (1 - T.busy_s(run_.trace) / T.window_s(run_.trace)) * T.window_s(run_.trace) * 1e3 / 2
    assert read("sync_idle_ms") + read("caller_idle_ms") <= idle_ms


def test_span_readers_give_nothing_for_a_program_without_spans():
    """A program that marks no batch (the benchmark's parent of these
    metrics) gives every span reader ``None``, and none raises."""
    t = _trace(with_batches=False)
    bare = T.Trace(t.ops, t.launch_ns, [s for s in t.spans if s.name == T.WINDOW_SPAN], [], t.window_ns)
    for name in SPAN_METRICS:
        assert manifest.metric_reader(name)(_run(bare)) is None, name
    for name in ("syncs_per_batch", "sync_idle_ms", "caller_idle_ms"):
        assert manifest.metric_reader(name)(_run(t)) is None, name


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("spans")))


@pytest.mark.parametrize("name", [w["name"] for w in manifest.load_manifest()["workloads"]])
def test_a_traced_tiny_run_reports_the_counters(root, name):
    """On the CPU the trace holds no device operation, so only the counters
    read: the reads per batch, the rungs per ladder and, where the cell
    fits, the loss evaluations per fit (the Adam steps and the final
    forward)."""
    cell = manifest.load_cell(f"tiny_{name}", root)
    res = run.run_cell(cell, 2**31 + 11, 0.3, True, "cpu")
    metrics = res["metrics"]
    listed = {m["name"] for m in cell.per_layer}
    assert {"syncs_per_batch", "ladder_rungs_per_factor"} <= set(metrics) <= listed
    assert metrics["ladder_rungs_per_factor"]["value"] >= 1.0
    if cell.traffic["entry"] == "suggest":
        chunks = tiny.TINY["n_candidates"] // tiny.TINY["ts_chunk"]
        assert metrics["syncs_per_batch"]["value"] >= chunks
    else:
        assert metrics["syncs_per_batch"]["value"] >= 2  # the factorization's ladder and the incumbent
    if "loss_evals_per_fit" in listed:
        assert metrics["loss_evals_per_fit"]["value"] == int(cell.traffic["fit_maxiter"]) + 1
    assert res["correct"], res["checks"]
