"""A kernel's least time on one NVIDIA H100 SXM: the larger of its bytes
over the HBM bandwidth and its operations over the fp32 peak outside the
tensor cores (fp64's on them). Copied from
``turbojax_torch/kernel_bench.py`` (``_bound``, ``kernel_matrix_bound``,
``ts_cov_bound``) and frozen here.

Bytes: each input read once and the output written once, whatever the
kernel reads again. Operations: per distinct output entry, 2d for the
squared distance (2(n + d) with the Gram sum of ``ts_cov``) and 12 for
the epilogue (d² from the norms, clamp, sqrt, exp and the polynomial)."""

from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = 67e12  # fp32 outside the tensor cores; TF32 is not fp32
EPILOGUE_OPS = 12


def bound(nbytes: float, ops: float) -> Dict[str, object]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FLOPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def kernel_matrix_bound(batch: int, n: int, m: int, d: int, same: bool, itemsize: int = 4) -> Dict[str, object]:
    """K(Z, Z) (n(n+1)/2 distinct entries) or a cross of n × m."""
    entries = batch * (n * (n + 1) // 2 if same else n * m)
    nbytes = itemsize * batch * (n * d + (0 if same else m * d) + n * m)
    return bound(nbytes, entries * (2 * d + EPILOGUE_OPS))


def ts_cov_bound(batch: int, m: int, n: int, d: int, itemsize: int = 4) -> Dict[str, object]:
    """k(x*, x*) − vᵀv over an m-point chunk and n training rows."""
    entries = batch * m * (m + 1) // 2
    nbytes = itemsize * batch * (m * d + n * m + m * m)
    return bound(nbytes, entries * (2 * (n + d) + EPILOGUE_OPS))
