"""window_pad_pct.amplicon: `window_pad_pct` (`metrics/window_pad_pct.py`:
the padding share of the extension windows) over the amplicon
cell's window: both maps of every sample, the screen's and
align_to_target's."""

from core.spec import Spec


def read(run):
    return Spec.reader("window_pad_pct").read(run)
