"""Layer ``loop``: idle device ms per completed batch in gaps that begin
inside one of the program's ``sync.*`` spans (a host read of a device
value): the part of ``device_idle`` that removing the program's reads
could win. Moves ``points_per_s``."""

from portbench import spans as S


def read(run):
    return S.idle_ms_per_batch(run, "sync")
