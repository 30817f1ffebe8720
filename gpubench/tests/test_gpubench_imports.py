"""Nothing the harness runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from core.spec import HERE

ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "megapath_nano_tpu"}


def _sources(sub=""):
    base = os.path.join(HERE, sub)
    for dirpath, _, files in os.walk(base):
        if "tests" in dirpath.split(os.sep) or "cache" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_names_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imported_tops(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = set(_imported_tops(path))
        assert "megapath_nano_tpu_torch" not in tops, path
        assert not tops & FORBIDDEN, path


def test_loaded_modules_after_a_run_have_no_jax():
    """Drive a tiny CPU run in a fresh process and list what it loaded, by
    whole top-level names (megapath_nano_tpu_torch is not
    megapath_nano_tpu)."""
    code = (
        "import sys, os, time, torch\n"
        f"sys.path[:0] = [{HERE!r}, {ROOT!r}]\n"
        "torch.set_num_threads(2)\n"
        "import run\n"
        "from core.spec import Spec\n"
        "from tests import tiny\n"
        "cfg, tr = tiny.map_world()\n"
        "spec = Spec.load(run.ROOT)\n"
        "res = run.execute(spec, {'name': 'map.refseq1g.ont', 'chips': 1},"
        " cfg, tr, 7, 0.1, False, 'cpu', time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()
    assert last[-1] == "[]"
    assert "megapath_nano_tpu_torch" in last[-2]
