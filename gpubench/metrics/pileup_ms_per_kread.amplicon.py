"""pileup_ms_per_kread.amplicon: host time in the program's
`variant.pileup` spans (`stranded_pileup`: the CIGARs' run arrays and the
strand-resolved counts), in ms per thousand input reads of the window's
samples. A program without the span reads nothing."""

from core import readings, spans


def read(run):
    sp = spans.window(run)
    reads = readings.completed(run, "reads")
    if not sp or not reads or not spans.named(sp, "variant.pileup"):
        return None
    return 1e6 * spans.seconds(sp, "variant.pileup") / reads
