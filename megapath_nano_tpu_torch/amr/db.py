"""AMR gene databases: sequences + (gene, drug/class) metadata.

The reference scans consensus sequences with five external tools/DBs —
ResFinder, RGI/CARD, AMRFinder, BLASTn vs MEGARes, BLASTn/p vs CBMAR
(reference: bin/megapath_nano_amr.py:48-70). The framework models each as an
AMRGeneDB (gene FASTA + per-gene drug annotations) scanned by the same
minimizer/DP engine, reproducing their database matching with identity and
coverage thresholds (90% / 60%, megapath_nano_amr.py:246-247).

Loaders parse the common public header formats; synthetic DBs are used in
tests. prepare scripts live in db_preparation (megapath_nano_tpu/db/).

The port's own copy of megapath_nano_tpu/amr/db.py.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex


@dataclass
class AMRGeneDB:
    name: str                              # e.g. "resfinder", "card"
    gene_names: list[str]
    sequences: list[np.ndarray]
    drugs: list[list[str]]                 # per gene: associated drug names
    classes: list[str] = field(default_factory=list)  # per gene drug class
    accessions: list[str] = field(default_factory=list)  # per gene acc_id
    taxa: list = field(default_factory=list)  # per gene: organism
    #                                           restriction (None = any) —
    #                                           AMRFinder --taxon gating
    #                                           (megapath_nano_amr.py:53-56)
    _index: MinimizerIndex | None = None

    def index(self, *, k: int = 15, w: int = 5) -> MinimizerIndex:
        if self._index is None:
            self._index = MinimizerIndex.build(self.sequences,
                                               self.gene_names, k=k, w=w)
        return self._index

    @staticmethod
    def from_fasta(name: str, path: str,
                   header_parser=None) -> "AMRGeneDB":
        """Load genes from FASTA; header_parser(header) -> (gene, [drugs]).
        Default parser: resfinder-style `gene_variant_accession` headers with
        no drug info (drugs attached via a phenotype table)."""
        from megapath_nano_tpu_torch.io.fastq import read_fastq

        batch = read_fastq(path)
        genes, seqs = [], []
        for i in range(batch.num_reads):
            genes.append(batch.ids[i])
            seqs.append(batch.read(i))
        if header_parser:
            parsed = [header_parser(g) for g in genes]
            gene_names = [p[0] for p in parsed]
            drugs = [p[1] for p in parsed]
            accs = [p[2] if len(p) > 2 else "" for p in parsed]
        else:
            gene_names = genes
            drugs = [[] for _ in genes]
            accs = ["" for _ in genes]
        return AMRGeneDB(name, gene_names, seqs, drugs, accessions=accs)

    def save(self, path: str) -> None:
        import json
        import os

        import numpy as np_

        os.makedirs(path, exist_ok=True)
        flat = (np_.concatenate(self.sequences) if self.sequences
                else np_.zeros(0, np_.int8))
        offsets = np_.zeros(len(self.sequences) + 1, np_.int64)
        np_.cumsum([len(s) for s in self.sequences], out=offsets[1:])
        np_.savez_compressed(os.path.join(path, "amrdb.npz"),
                             seq=flat, offsets=offsets)
        with open(os.path.join(path, "amrdb.json"), "w") as f:
            json.dump({"name": self.name, "gene_names": self.gene_names,
                       "drugs": self.drugs, "classes": self.classes,
                       "accessions": self.accessions, "taxa": self.taxa}, f)

    @staticmethod
    def load(path: str) -> "AMRGeneDB":
        import json
        import os

        import numpy as np_

        z = np_.load(os.path.join(path, "amrdb.npz"))
        with open(os.path.join(path, "amrdb.json")) as f:
            meta = json.load(f)
        seqs = [z["seq"][s:e] for s, e in zip(z["offsets"][:-1],
                                              z["offsets"][1:])]
        return AMRGeneDB(meta["name"], meta["gene_names"], seqs,
                         meta["drugs"], meta.get("classes", []),
                         accessions=meta.get("accessions", []),
                         taxa=meta.get("taxa", []))

    def attach_phenotypes(self, table: dict[str, list[str]]) -> None:
        """Attach drug lists by gene-name lookup (ResFinder phenotype.txt
        style)."""
        for i, g in enumerate(self.gene_names):
            base = g.split("_")[0]
            self.drugs[i] = table.get(g, table.get(base, self.drugs[i]))


def canonical_drug(name: str) -> str:
    """Drug-name canonicalization, operation-exact to the reference
    (megapath_nano_amr.py:99-107 remove_endswith + canonicalize): strip a
    trailing 's', then a trailing ' antibiotic', remove dashes,
    uppercase."""
    x = name.strip()
    for suffix in ("s", " antibiotic"):
        if x.endswith(suffix):
            x = x[: -len(suffix)]
    return x.replace("-", "").upper()


# MEGARes 2.00 drug-class vocabulary — the fixed list the reference matches
# gene labels against (megapath_nano_amr.py:134)
MEGARES_CLASSES = [
    "AMINOCOUMARINS", "AMINOGLYCOSIDES", "BACITRACIN", "BETALACTAMS",
    "CATIONIC_ANTIMICROBIAL_PEPTIDES", "ELFAMYCINS", "FLUOROQUINOLONES",
    "FOSFOMYCIN", "FUSIDIC_ACID", "GLYCOPEPTIDES", "LIPOPEPTIDES",
    "METRONIDAZOLE", "MLS", "MULTI-DRUG_RESISTANCE",
    "MYCOBACTERIUM_TUBERCULOSIS-SPECIFIC_DRUG", "PHENICOL", "RIFAMPIN",
    "SULFONAMIDES", "TETRACYCLINES", "THIOSTREPTON", "TRIMETHOPRIM",
    "TUNICAMYCIN"]


def parse_card_header(header: str):
    """CARD nucleotide FASTA headers:
    gb|<acc>|<strand>|<coords>|ARO:<id>|<gene name> [organism]
    -> (gene, [], accession). Drugs come from the ARO index table
    (attach via attach_phenotypes / aro mapping), as RGI does."""
    parts = header.split("|")
    acc = parts[1] if len(parts) > 1 else header
    gene = parts[-1] if parts else header
    gene = re.sub(r"\s*\[.*\]$", "", gene).strip()
    return gene, [], acc


def parse_megares_header(header: str):
    """MEGARes headers: MEG_<n>|<type>|<class>|<mechanism>|<group>
    -> (group, [class-if-drug-class], MEG accession). The reference maps
    the gene label against the fixed class vocabulary
    (megapath_nano_amr.py:134-141)."""
    parts = header.split("|")
    acc = parts[0] if parts else header
    gene = parts[4] if len(parts) > 4 else header
    drug = []
    label = header.upper()
    for cls in MEGARES_CLASSES:
        if cls in label:
            drug = [cls]
            break
    return gene, drug, acc


def parse_resfinder_header(header: str):
    """ResFinder headers: <gene>_<variant>_<accession>
    -> (gene_variant, [], accession); phenotypes attach from
    phenotypes.txt."""
    parts = header.split("_")
    acc = parts[-1] if len(parts) >= 3 else ""
    gene = "_".join(parts[:-1]) if len(parts) >= 3 else header
    return gene, [], acc
