"""Layer ``surrogate fit``: device milliseconds per fitting batch of the
work launched under the program's ``gp.polish_backward`` span (the
marginal likelihood's backward in each optimizer step), matched to the
span by the launch call's time, since autograd launches from its own
thread. Moves ``points_per_s``."""

from portbench import trace as T


def read(run):
    fits = sum(1 for b in run.batches if b["fit"])
    ops = T.launched_under(run.trace, "gp.polish_backward")
    if not fits or not ops:
        return None
    return 1e3 * T.device_s(ops) / fits
