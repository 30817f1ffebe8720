"""traceback_redo_pct.amplicon: `traceback_redo_pct` (`metrics/traceback_redo_pct.py`:
the host tracebacks redone at the full band) over the amplicon
cell's window: both maps of every sample, the screen's and
align_to_target's."""

from core.spec import Spec


def read(run):
    return Spec.reader("traceback_redo_pct").read(run)
