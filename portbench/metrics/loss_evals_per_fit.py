"""Layer ``surrogate fit``: evaluations of the fit's loss per fitting
batch, the program's ``gp.loss`` spans counted (each Adam step or L-BFGS
probe, and the final forward): each is one K(X, X) and one Cholesky of
N × N. Moves ``points_per_s``."""

from portbench import spans as S


def read(run):
    fits = sum(1 for b in run.batches if b["fit"])
    evals = S.count(run.trace, "gp.loss")
    if not fits or not evals:
        return None
    return evals / fits
