"""Layer ``loop``: host reads of a device value per completed batch, the
program's ``sync.<module>.<site>`` spans counted (the TS ladder's
``int(info)``, the posterior ladder's, the loop's incumbent, the fits'
stopping flags). Moves ``points_per_s``: each read waits for the device
and leaves it idle while the host launches again."""

from portbench import spans as S


def read(run):
    if not run.batches or not S.marks_batches(run.trace):
        return None
    return S.count(run.trace, S.SYNC) / len(run.batches)
