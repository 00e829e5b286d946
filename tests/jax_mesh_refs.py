"""The JAX package's multi-device functions as the port's mesh tests run
them for reference, in the test process on the conftest's virtual CPU
devices: compiled. Called eagerly, a ``shard_map`` program takes seconds a
call here, so ``jax_compiled()`` swaps the public primitives of
``turbojax.distributed_linalg`` and ``turbojax.parallel`` for their jitted
selves and sends the panel loops down the JAX package's ``fori`` lane (one
compiled body; the unrolled lane's values to round-off). Nothing in the
JAX package changes; the swap ends with the context.
"""

import contextlib

import jax
import pytest

from turbojax import distributed_linalg as JDL
from turbojax import parallel as JPAR

_JITTED = {
    JDL: {
        "distributed_cholesky": ("mesh", "panel", "unroll"),
        "distributed_solve_lower": ("mesh", "panel", "unroll"),
        "distributed_solve_upper_t": ("mesh", "panel", "unroll"),
        "distributed_gp_posterior": ("mesh", "panel"),
        "distributed_logdet_from_chol": ("mesh",),
        "distributed_kernel_chol": ("mesh", "panel", "kernel", "unroll", "jitter"),
        "distributed_cross_covariance": ("mesh", "kernel"),
    },
    JPAR: {
        "sharded_acq_topq": ("q", "mesh", "config", "acq", "kappa", "xi"),
        "sharded_thompson_select": ("q", "mesh", "config", "chunk_size"),
        "sharded_fit_gp": ("config", "mesh"),
    },
}


@contextlib.contextmanager
def jax_compiled():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JDL, "UNROLL_MAX_PANELS", 0)
        for module, fns in _JITTED.items():
            for name, static in fns.items():
                mp.setattr(module, name, jax.jit(getattr(module, name), static_argnames=static))
        yield
