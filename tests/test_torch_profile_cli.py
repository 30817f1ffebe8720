"""Port parity for the profile CLI: `megapath_nano_tpu_torch.cli.main` with
`--device cpu` against `megapath_nano_tpu.cli.main` with `--backend jnp`, on
a world like tests/test_cli.py's (two assemblies, 50 reads with qualities and
one junk read that the read filter drops; the DB built by the TPU package's
build_db from FASTA and a metadata table), without `--amr_db`. Each run
writes the same files, byte-equal (archives member by member; `.timing`
holds wall times and is only required to exist). The port's parser keeps
every flag and dest of the original but `--backend`, which becomes
`--device`. (`--amr_db` and `--index_shards`: tests/test_torch_amr_cli.py
and tests/test_torch_sharded.py.)"""

import numpy as np
import pytest
import torch

from megapath_nano_tpu.cli import build_db as jbuild_db
from megapath_nano_tpu.cli import main as jcli
from megapath_nano_tpu.io.fastq import write_fasta, write_fastq
from megapath_nano_tpu.utils.dna import mutate, random_sequence, revcomp
from megapath_nano_tpu_torch.cli import main as tcli
from test_torch_profiler import assert_same_files


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cliworld")
    rng = np.random.default_rng(0)
    gene = random_sequence(rng, 800)
    g1 = np.concatenate([random_sequence(rng, 12000), gene,
                         random_sequence(rng, 4000)])
    g2 = random_sequence(rng, 15000)
    human = np.concatenate([random_sequence(rng, 9000), g2[3000:4200]])
    write_fasta(str(tmp / "asm1.fna"), ["chr1"], [g1])
    write_fasta(str(tmp / "asm2.fna"), ["chr2"], [g2])
    write_fasta(str(tmp / "human.fna"), ["chrH"], [human])
    with open(tmp / "meta.tsv", "w") as f:
        f.write("asmA\t100\t10\t1\tSpecies foo\n")
        f.write("asmB\t200\t20\t2\tSpecies bar\n")
    with open(tmp / "hmeta.tsv", "w") as f:
        f.write("GRCh38\t9606\t9606\t9605\tHomo sapiens\n")
    reads, quals = [], []
    for i in range(50):
        g, genome = (0, g1) if rng.random() < 0.7 else (1, g2)
        if i % 10 == 9:
            genome = human[:9000]
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
    for name, fastas, meta in (("refdb", ["asm1.fna", "asm2.fna"],
                                "meta.tsv"),
                               ("humandb", ["human.fna"], "hmeta.tsv")):
        argv = ["ref", "--metadata", str(tmp / meta), "--out",
                str(tmp / name)]
        for fa in fastas:
            argv += ["--fasta", str(tmp / fa)]
        assert jbuild_db.main(argv) == 0
    return tmp


def _common(world, out):
    return ["--query", str(world / "reads.fastq"), "--db",
            str(world / "refdb"), "--output_folder", str(out),
            "--output_prefix", "demo"]


# name -> extra flags of the run
RUNS = {
    "default": [],
    "noise_gates": ["--human_db", "HUMAN", "--human_filter",
                    "--spike_filter", "--reassignment",
                    "--unique_alignment", "--closing_spike_filter",
                    "--short_alignment_filter", "--min_alignment_length",
                    "500", "--archive_format", "zip"],
    "mapping_only": ["--mapping_only"],
    "filter_fq_only": ["--filter_fq_only", "--head_crop", "20",
                       "--min_read_length", "300"],
    "outputs_off": ["--no_adaptor_trimming", "--no_output_per_read_data",
                    "--no_output_noise_stat", "--no_output_genome_set",
                    "--output_trimmed_and_filtered_query",
                    "--read_length_bin_size", "250",
                    "--quality_score_bin_size", "0.5",
                    "--reassign_read_id", "--max_aligned_reads", "30"],
}


@pytest.mark.parametrize("run", list(RUNS))
def test_cli_writes_the_reference_files(world, run, tmp_path):
    extra = [str(world / "humandb") if a == "HUMAN" else a
             for a in RUNS[run]]
    assert jcli.main(_common(world, tmp_path / "jax") + extra
                     + ["--backend", "jnp"]) == 0
    assert tcli.main(_common(world, tmp_path / "port") + extra
                     + ["--device", "cpu"]) == 0
    names = assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert "demo.timing" in names
    if run in ("default", "noise_gates"):
        assert {"demo.preport", "demo.microbe_stat", "demo.read_stat",
                "demo.species.paf"} <= set(names)
        preport = (tmp_path / "port" / "demo.preport").read_text()
        assert preport.splitlines()[1].startswith("10\tSpecies foo")
    if run == "mapping_only":
        assert {"demo.species.paf", "demo.species.sam"} <= set(names)


def _actions(parser):
    return {a.dest: (sorted(a.option_strings), a.default, a.choices,
                     a.nargs, a.const, a.required, type(a).__name__)
            for a in parser._actions}


def test_parser_keeps_every_dest_but_backend():
    j, t = _actions(jcli.build_parser()), _actions(tcli.build_parser())
    assert set(j) - set(t) == {"backend"}
    assert set(t) - set(j) == {"device"}
    for dest in set(j) - {"backend"}:
        assert j[dest] == t[dest], dest
    assert t["device"][:3] == (["--device"], "cuda", ["cuda", "cpu"])


def test_options_from_args_match():
    flags = [
        "--query", "x.fq", "--db", "d", "--min_alignment_score", "17",
        "--species_id_min_aligned_bp", "123",
        "--variable_region_percent", "40",
        "--expected_max_depth_stdev", "4.5",
        "--closing_expected_max_depth_stdev", "7.5",
        "--max_alignment_noise_overlap", "60",
        "--unique_alignment_threshold", "70",
        "--reassignment_ratio", "0.07", "--reassignment_error_rate", "0.03",
        "--similar_species_marker_num_genus", "5",
        "--similar_species_marker_alignment_similarity_1", "99",
        "--similar_species_marker_similarity_combine_logic", "and",
        "--noise_projection_num_read_to_simulate", "500",
        "--min_percent_abundance_to_perform_noise_projection", "30",
        "--microbe_repetitive_region_filter_abundance_threshold_99_2", "5",
        "--human_filter_alignment_score_percent", "80",
        "--assembly_selection", "--human_filter", "--genome_pair_cache", "c",
        "--amplicon_filter_module"]
    for extra in ([], ["--amr_db", "x"]):
        ja = jcli.build_parser().parse_args(flags + extra)
        ta = tcli.build_parser().parse_args(flags + extra)
        for kw in ({}, {"have_human": True, "have_assembly": True}):
            jo, to = (jcli.options_from_args(ja, **kw),
                      tcli.options_from_args(ta, **kw))
            jd, td = vars(jo), vars(to)
            assert set(jd) == set(td)
            for k in jd:
                if k == "align":
                    a = {f: v for f, v in vars(jd[k]).items()
                         if f != "backend"}
                    assert a == {f: v for f, v in vars(td[k]).items()
                                 if f in a}
                else:
                    assert jd[k] == td[k], k
    assert jcli.output_gates_from_args(ja) == tcli.output_gates_from_args(ta)


def test_cli_defaults_to_the_card(world, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcli.main(_common(world, tmp_path))
