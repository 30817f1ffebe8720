"""Tiny configurations and traffic for the CPU tests: the same files' keys,
at sizes a test run holds."""

import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def profile_world():
    cfg = _load("configs", "zymo_d6300.json")
    cfg["name"] = "zymo_tiny"
    cfg["db_seed"] = 11
    w = cfg["world"]
    w["relatives_per_species"] = 1
    w["species"] = [dict(s, genome_bp=40000) for s in w["species"][:3]]
    tr = _load("traffic", "profile_trim.json")
    tr.update(reads_per_sample=24, pool=2, warmup_reads=6)
    tr["profile"].update(length_log_mean=6.9, length_log_sigma=0.25,
                         max_length=1800)
    tr["adapters"].update(middle_rate=0.2)
    return cfg, tr


def map_world():
    cfg = _load("configs", "refseq_bact_1g.json")
    cfg["name"] = "refseq_tiny"
    cfg["db_seed"] = 12
    cfg["species"] = 2
    cfg["world"].update(layout=[[1, 2], [1, 1]], genome_bp=40000)
    tr = _load("traffic", "map_ont.json")
    tr.update(reads_per_call=24, pool=2, slice_size=16, check_sample=6)
    tr["profile"].update(length_log_mean=6.6, length_log_sigma=0.3,
                         max_length=1500)
    return cfg, tr


def map_world_long():
    """Reads of 5-8 kb, so that the program's band is 256 and the
    control's fixed band of 128 falls short on them."""
    cfg, tr = map_world()
    cfg["world"].update(genome_bp=120000)
    tr.update(reads_per_call=12, pool=1, slice_size=12, check_sample=8)
    tr["profile"].update(length_log_mean=8.85, length_log_sigma=0.1,
                         max_length=7900)
    return cfg, tr


def map_world_20k():
    """Reads of about 17 kb, over the 16,384 b of the fused path's gate,
    so that every slice takes the path of the cell's ONT calls: host
    seeding, the score-only kernel, the host traceback."""
    cfg, tr = map_world()
    cfg["world"].update(genome_bp=60000)
    tr.update(reads_per_call=3, pool=1, slice_size=2, check_sample=3)
    tr["profile"].update(length_log_mean=9.76, length_log_sigma=0.02,
                         max_length=20000)
    return cfg, tr
