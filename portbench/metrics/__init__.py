"""One module per per-layer metric, found by its name in ``BENCHMARK.json``.
Each has ``read(run: trace.Run) -> Optional[float]``: ``None`` when the
window holds nothing for it to read, and the harness then leaves it out."""
