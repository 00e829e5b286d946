"""Layer ``loop``: idle device ms per completed batch in gaps that begin
outside every ``bo.suggest`` and ``bo.iteration`` span, or inside a
``bo.callback`` span: the caller's time (the harness's synchronize and
record copies, the objective, the draws handed in), the part of
``device_idle`` that no change to the program can remove. Moves
``points_per_s``."""

from portbench import spans as S


def read(run):
    return S.idle_ms_per_batch(run, "caller")
