"""window_pad_pct: the padding share of the extension windows the device
scores on the host path: 100 x (1 - `window_bytes` / `window_bytes_padded`),
the program's counters of `map.extend` (real query and target bases against
the bytes of the padded window arrays), summed over the window."""

from core import spans


def read(run):
    sp = spans.window(run)
    if not sp:
        return None
    padded = spans.counted(sp, "window_bytes_padded")
    if not padded:
        return None
    return 100.0 * (1.0 - spans.counted(sp, "window_bytes") / padded)
