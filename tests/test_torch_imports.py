"""The port stands alone: importing megapath_nano_tpu_torch and every one of
its submodules leaves jax and the TPU package (megapath_nano_tpu) out of
sys.modules, and no source file of the package, nor chip_smoke.py, imports
either or mentions pallas."""

import os
import pkgutil
import re
import subprocess
import sys

import megapath_nano_tpu_torch

PKG_DIR = os.path.dirname(megapath_nano_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _modules():
    names = ["megapath_nano_tpu_torch"]
    for m in pkgutil.walk_packages([PKG_DIR], "megapath_nano_tpu_torch."):
        names.append(m.name)
    return names


def test_package_imports_without_jax():
    names = _modules()
    assert {"megapath_nano_tpu_torch.align.pipeline",
            "megapath_nano_tpu_torch.kernels.sw",
            "megapath_nano_tpu_torch.kernels.chain",
            "megapath_nano_tpu_torch.state",
            "megapath_nano_tpu_torch.native.lib",
            "megapath_nano_tpu_torch.native.banded",
            "megapath_nano_tpu_torch.index.minimizer",
            "megapath_nano_tpu_torch.align.anchors",
            "megapath_nano_tpu_torch.align.records",
            "megapath_nano_tpu_torch.report.samout",
            "megapath_nano_tpu_torch.utils.dna",
            "megapath_nano_tpu_torch.utils.log",
            "megapath_nano_tpu_torch.native.ssw",
            "megapath_nano_tpu_torch.io.fastq",
            "megapath_nano_tpu_torch.io.adapters",
            "megapath_nano_tpu_torch.db.refdb",
            "megapath_nano_tpu_torch.report.writers",
            "megapath_nano_tpu_torch.report.histograms",
            "megapath_nano_tpu_torch.sim.simulator",
            "megapath_nano_tpu_torch.cli.main",
            "megapath_nano_tpu_torch.cli.amr",
            "megapath_nano_tpu_torch.cli.build_db",
            "megapath_nano_tpu_torch.io.sam",
            "megapath_nano_tpu_torch.io.bgzf",
            "megapath_nano_tpu_torch.db.taxdump",
            "megapath_nano_tpu_torch.db.sqlite_taxonomy",
            "megapath_nano_tpu_torch.db.refseq_plan",
            "megapath_nano_tpu_torch.dist.sharded_aligner"} <= set(names)
    assert {f"megapath_nano_tpu_torch.amr.{m}" for m in (
        "db", "consensus", "orf", "protein", "scan", "report",
        "module")} <= set(names)
    assert {f"megapath_nano_tpu_torch.taxon.{m}" for m in (
        "intervals", "abundance", "best_align", "filters", "reassign",
        "noise_stats", "bed_cache", "assembly_selection", "profiler",
        "genome_filters", "noise_projection")} <= set(names)
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'megapath_nano_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PKG_DIR):
        if root == PKG_DIR and "build" in dirs:
            dirs.remove("build")    # build outputs, not sources of the port
        paths += [os.path.join(root, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh"))]
    return paths


def test_sources_do_not_mention_jax_or_pallas():
    offenders = []
    for path in _port_sources():
        with open(path) as fh:
            text = fh.read()
        for word in ("import jax", "from jax", "pallas"):
            if word in text:
                offenders.append((os.path.relpath(path, REPO), word))
    assert not offenders, offenders


def test_sources_do_not_import_the_tpu_package():
    # `import megapath_nano_tpu`, `from megapath_nano_tpu.x import y`,
    # importlib strings: any of them, but not megapath_nano_tpu_torch
    pat = re.compile(r"(?:\bimport|\bfrom|import_module\(\s*[\"'])\s*"
                     r"megapath_nano_tpu(?![_\w])")
    assert pat.search("from megapath_nano_tpu.utils import dna")
    assert pat.search("import megapath_nano_tpu")
    assert not pat.search("from megapath_nano_tpu_torch.utils import dna")
    paths = _port_sources()
    assert len(paths) > 15
    offenders = []
    for path in paths:
        with open(path) as fh:
            for no, line in enumerate(fh, 1):
                if pat.search(line):
                    offenders.append((os.path.relpath(path, REPO), no))
    assert not offenders, offenders
