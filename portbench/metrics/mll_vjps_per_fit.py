"""Layer ``surrogate fit``: closed-form backwards of the marginal likelihood
per fitting batch, the program's ``gp.mll_vjp`` spans counted (one each
differentiated loss evaluation: each Adam step's, not the final forward's),
recorded on autograd's thread. A program whose backward runs through the
Cholesky by reverse mode records none, and this reads nothing. Moves
``points_per_s``."""

from portbench import spans as S


def read(run):
    fits = sum(1 for b in run.batches if b["fit"])
    vjps = S.count(run.trace, "gp.mll_vjp")
    if not fits or not vjps:
        return None
    return vjps / fits
