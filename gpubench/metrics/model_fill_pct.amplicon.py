"""model_fill_pct.amplicon: how much of the variant model's launched rows
are candidates: 100 x `model_rows` / `model_rows_launched`, the program's
counters of `variant.model` (candidates times models, against batches of
256 times models), summed over the window. A program without the counters
reads nothing."""

from core import spans


def read(run):
    sp = spans.window(run)
    if not sp:
        return None
    launched = spans.counted(sp, "model_rows_launched")
    if not launched:
        return None
    return 100.0 * spans.counted(sp, "model_rows") / launched
