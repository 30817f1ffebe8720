"""extend_fill_pct.amplicon: `extend_fill_pct` (`metrics/extend_fill_pct.py`:
the windows' own share of the score-only extension launches' rows) over the amplicon
cell's window: both maps of every sample, the screen's and
align_to_target's."""

from core.spec import Spec


def read(run):
    return Spec.reader("extend_fill_pct").read(run)
