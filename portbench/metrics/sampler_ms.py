"""Layer ``posterior and samplers``: device ms per completed batch of the
operations launched under the program's ``acq.sample`` span (the Thompson
samplers: exact chunked, RFF, pathwise, distributed pathwise; the
dispatcher is not marked, so no draw counts twice). Moves
``points_per_s``."""

from portbench import spans as S


def read(run):
    return S.device_ms_per_batch(run, "acq.sample")
