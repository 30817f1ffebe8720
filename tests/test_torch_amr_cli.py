"""Port parity for the AMR entry points, the sharded CLI and the DB
builder, in process: `megapath_nano_tpu_torch.cli.main --amr_db` and
`--index_shards 3`, `cli.amr` and `cli.build_db` (device "cpu") against the
TPU package's CLIs (backend "jnp"), on a world like tests/test_cli.py's (two
assemblies, a resistance gene in the first and one in no genome, 50 reads
with qualities and one junk read). Each run writes the same files:
byte-equal, archives member by member, `.timing` only required to exist,
the SAM's `@PG` line aside (it names the writer). The `plan` and
`taxonomy_db` subcommands run on the inputs of tests/test_refseq_plan.py and
tests/test_taxdump.py (SQLite files compared table by table through
`iterdump`)."""

import os
import sqlite3

import numpy as np
import pytest
import torch

from megapath_nano_tpu.cli import amr as jamr
from megapath_nano_tpu.cli import build_db as jbuild_db
from megapath_nano_tpu.cli import main as jcli
from megapath_nano_tpu.io.fastq import write_fasta, write_fastq
from megapath_nano_tpu.utils.dna import decode, mutate, random_sequence
from megapath_nano_tpu.utils.dna import revcomp
from megapath_nano_tpu_torch.cli import amr as tamr
from megapath_nano_tpu_torch.cli import build_db as tbuild_db
from megapath_nano_tpu_torch.cli import main as tcli
from test_refseq_plan import _row, _summary
from test_taxdump import NAMES, NODES, SUMMARY
from test_torch_profile_cli import _actions
from test_torch_profiler import assert_same_files


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the whole module, its module-scoped fixtures
    included (xdist runs several files at once)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_cli_world(tmp):
    """tests/test_cli.py's world (FASTA, metadata, reads) plus a second
    gene FASTA (a gene of the first assembly and one of no genome) for
    `--amr_db` given as a file."""
    rng = np.random.default_rng(0)
    gene = random_sequence(rng, 800)
    g1 = np.concatenate([random_sequence(rng, 12000), gene,
                         random_sequence(rng, 4000)])
    g2 = random_sequence(rng, 15000)
    write_fasta(str(tmp / "asm1.fna"), ["chr1"], [g1])
    write_fasta(str(tmp / "asm2.fna"), ["chr2"], [g2])
    with open(tmp / "meta.tsv", "w") as f:
        f.write("asmA\t100\t10\t1\tSpecies foo\n")
        f.write("asmB\t200\t20\t2\tSpecies bar\n")
    write_fasta(str(tmp / "genes.fna"), ["blaX"], [gene])
    with open(tmp / "pheno.tsv", "w") as f:
        f.write("blaX\tampicillin;cephalothin\n")
    write_fasta(str(tmp / "card.fna"), ["tetQ", "vanY"],
                [g1[3000:4100].copy(), random_sequence(rng, 900)])
    reads, quals = [], []
    for _ in range(50):
        genome = g1 if rng.random() < 0.7 else g2
        s = int(rng.integers(0, len(genome) - 800))
        r = mutate(rng, genome[s: s + 800], 0.03, 0.015, 0.015)
        if rng.integers(0, 2):
            r = revcomp(r)
        reads.append(r)
        quals.append(np.full(len(r), 25, np.int8))
    reads.append(random_sequence(rng, 500))     # junk: QC drops it
    quals.append(np.full(500, 3, np.int8))
    write_fastq(str(tmp / "reads.fastq"),
                [f"read{i}" for i in range(len(reads))], reads, quals)
    return tmp


def ref_argv(world, out):
    return ["ref", "--fasta", str(world / "asm1.fna"), "--fasta",
            str(world / "asm2.fna"), "--metadata", str(world / "meta.tsv"),
            "--out", str(out)]


def amr_argv(world, out):
    return ["amr", "--name", "resfinder", "--fasta",
            str(world / "genes.fna"), "--phenotypes",
            str(world / "pheno.tsv"), "--out", str(out)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world, with each package's `build_db ref` and `amr` run once:
    jax/refdb, jax/amrdb, port/refdb, port/amrdb."""
    w = make_cli_world(tmp_path_factory.mktemp("amrcli"))
    for side, mod in (("jax", jbuild_db), ("port", tbuild_db)):
        assert mod.main(ref_argv(w, w / side / "refdb")) == 0
        assert mod.main(amr_argv(w, w / side / "amrdb")) == 0
    return w


def test_build_db_writes_the_reference_files(world):
    for db in ("refdb", "amrdb"):
        names = assert_same_files(str(world / "jax" / db),
                                  str(world / "port" / db))
        assert names == ({"refdb": ["refdb.json", "refdb.npz"],
                          "amrdb": ["amrdb.json", "amrdb.npz"]}[db])


@pytest.fixture(scope="module")
def amr_runs(world):
    """The profile CLI with `--amr_db` (a DB directory and a gene FASTA),
    once per package, each on its own DBs; returns the output folders."""
    outs = {}
    for side, mod, dev in (("jax", jcli, ["--backend", "jnp"]),
                           ("port", tcli, ["--device", "cpu"])):
        out = world / side / "out"
        assert mod.main(
            ["--query", str(world / "reads.fastq"), "--db",
             str(world / side / "refdb"), "--amr_db",
             str(world / side / "amrdb"), "--amr_db",
             str(world / "card.fna"), "--output_folder", str(out),
             "--output_prefix", "demo"] + dev) == 0
        outs[side] = out
    return outs


def test_cli_with_amr_writes_the_reference_files(amr_runs):
    names = assert_same_files(str(amr_runs["jax"]), str(amr_runs["port"]))
    assert {"demo.preport", "demo.results.csv", "demo.species.sam",
            "demo.timing"} <= set(names)
    results = (amr_runs["port"] / "demo.results.csv").read_text()
    assert "blaX[" in results and "tetQ[" in results
    assert "AMPICILLIN" in results and "vanY" not in results
    timing = (amr_runs["port"] / "demo.timing").read_text()
    assert "amr" in timing


def _amr_argv(world, side, out, target):
    src = (["--db", str(world / side / "refdb")] if target == "db"
           else ["--reference", str(world / "asm1.fna")])
    return ["--query_sam", str(world / "jax" / "out" / "demo.species.sam"),
            "--amr_db", str(world / side / "amrdb"), "--amr_db",
            str(world / "card.fna"), "--output_folder", str(out),
            "--min_depth", "1"] + src


def test_cli_amr_on_the_species_sam(world, amr_runs, tmp_path):
    """cli.amr on the `.species.sam` of the run above, the target sequences
    from the RefDB."""
    assert jamr.main(_amr_argv(world, "jax", tmp_path / "jax", "db")
                     + ["--backend", "jnp"]) == 0
    assert tamr.main(_amr_argv(world, "port", tmp_path / "port", "db")
                     + ["--device", "cpu"]) == 0
    names = assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert names == ["amr.results.csv"]
    assert "blaX[" in (tmp_path / "port" / "amr.results.csv").read_text()


def test_cli_amr_reference_fasta_fails_as_the_reference(world, amr_runs,
                                                         tmp_path):
    """`--reference` imports io.fastq.read_fasta, which neither package
    has: the copy keeps the original's behaviour (a reference defect,
    ROADMAP.md §3)."""
    for mod, dev in ((jamr, ["--backend", "jnp"]),
                     (tamr, ["--device", "cpu"])):
        with pytest.raises(ImportError, match="read_fasta"):
            mod.main(_amr_argv(world, "jax", tmp_path, "reference") + dev)


def test_amr_parser_keeps_every_dest_but_backend():
    j, t = _actions(jamr.build_parser()), _actions(tamr.build_parser())
    assert set(j) - set(t) == {"backend"}
    assert set(t) - set(j) == {"device"}
    for dest in set(j) - {"backend"}:
        assert j[dest] == t[dest], dest
    assert t["device"][:3] == (["--device"], "cuda", ["cuda", "cpu"])


def test_amr_cli_defaults_to_the_card(world, amr_runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tamr.main(["--query_sam", str(amr_runs["jax"] / "demo.species.sam"),
                   "--db", str(world / "port" / "refdb"), "--amr_db",
                   str(world / "port" / "amrdb"), "--output_folder",
                   str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_cli_index_shards_writes_the_reference_files(world, tmp_path):
    """The profile CLI with `--index_shards 3` (2 assemblies: one shard
    empty), no AMR, on the DB the TPU package's build_db wrote."""
    common = ["--query", str(world / "reads.fastq"), "--db",
              str(world / "jax" / "refdb"), "--output_prefix", "demo",
              "--index_shards", "3", "--no_amr"]
    assert jcli.main(common + ["--output_folder", str(tmp_path / "jax"),
                               "--backend", "jnp"]) == 0
    assert tcli.main(common + ["--output_folder", str(tmp_path / "port"),
                               "--device", "cpu"]) == 0
    names = assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert {"demo.preport", "demo.microbe_stat",
            "demo.species.paf"} <= set(names)


def _write_dump(d):
    d.mkdir()
    (d / "nodes.dmp").write_text(NODES)
    (d / "names.dmp").write_text(NAMES)
    (d / "assembly_summary.txt").write_text(SUMMARY)
    return d


def test_build_db_ref_with_taxdump_matches(tmp_path):
    dump = _write_dump(tmp_path / "dump")
    rng = np.random.default_rng(0)
    for acc in ("GCF_E", "GCF_K"):
        seq = decode(random_sequence(rng, 3000))
        (tmp_path / f"{acc}.fna").write_text(f">{acc}_chr1\n{seq}\n")
    for side, mod in (("jax", jbuild_db), ("port", tbuild_db)):
        assert mod.main(
            ["ref", "--fasta", str(tmp_path / "GCF_E.fna"), "--fasta",
             str(tmp_path / "GCF_K.fna"), "--assembly_name", "GCF_E",
             "--assembly_name", "GCF_K", "--taxdump", str(dump),
             "--assembly_summary", str(dump / "assembly_summary.txt"),
             "--out", str(tmp_path / side), "--k", "13", "--w", "7"]) == 0
    assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"))


def _dump_sql(path):
    con = sqlite3.connect(path)
    try:
        return list(con.iterdump())
    finally:
        con.close()


def test_build_db_plan_and_taxonomy_db_match(tmp_path):
    rows = [
        _row("A1", "reference genome", 1001, 100, "Complete Genome"),
        _row("A2", "representative genome", 1002, 100, "Complete Genome"),
        _row("A3", "representative genome", 1003, 100, "Scaffold"),
        _row("A4", "na", 1004, 100, "Chromosome"),
        _row("B1", "representative genome", 2001, 200, "Complete Genome"),
        _row("B2", "na", 2002, 200, "Complete Genome"),
        _row("C1", "na", 3001, 300, "Complete Genome"),
    ]
    summary = _summary(tmp_path, rows)
    dump = _write_dump(tmp_path / "dump")
    for side, mod in (("jax", jbuild_db), ("port", tbuild_db)):
        out = tmp_path / side
        assert mod.main(["plan", "--assembly_summary",
                         f"bacteria={summary}", "--plasmid_files", "3",
                         "--out", str(out / "plan")]) == 0
        assert mod.main(["taxonomy_db", "--taxdump", str(dump),
                         "--assembly_summary",
                         str(dump / "assembly_summary.txt"), "--out",
                         str(out / "ncbi_taxonomy.db")]) == 0
    names = assert_same_files(str(tmp_path / "jax" / "plan"),
                              str(tmp_path / "port" / "plan"))
    assert names == ["download.tsv", "fetch.sh"]
    assert os.access(tmp_path / "port" / "plan" / "fetch.sh", os.X_OK)
    jsql = _dump_sql(str(tmp_path / "jax" / "ncbi_taxonomy.db"))
    tsql = _dump_sql(str(tmp_path / "port" / "ncbi_taxonomy.db"))
    assert jsql == tsql and any("Escherichia coli" in s for s in tsql)
