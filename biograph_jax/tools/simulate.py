"""Seeded sequencing samples: a haploid genome with planted SNPs and
error-free single-end reads from both strands.

Every run regenerates its data from a seed, so a deployment needs no data
outside the repository.  What is planted here is the truth a discovery run
is scored against (`truth_match`), and `record_digest` gives the comparable
form of a record set (two backends, two engines, two commits).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Iterable

import numpy as np


# the planted SNPs sit at least this far from each other and from the ends:
# one bubble per SNP (two SNPs closer than a read length would make one
# complex event) with read-length context on both sides
MIN_SNP_GAP = 300


@dataclass
class HaploidSample:
    genome: np.ndarray  # uint8 [G] reference codes (A=0 C=1 G=2 T=3)
    snp_pos: np.ndarray  # int64 [S] sorted 0-based reference positions
    snp_alt: np.ndarray  # uint8 [S] donor base at each SNP
    reads: np.ndarray  # uint8 [R, L] donor reads, every other one reverse-complemented

    @property
    def donor(self) -> np.ndarray:
        d = self.genome.copy()
        d[self.snp_pos] = self.snp_alt
        return d

    def reference(self, name: str = "chr1"):
        """The genome as a one-contig Reference."""
        from biograph_jax.index.reference import Contig, Reference

        G = len(self.genome)
        return Reference(flat=self.genome, is_n=np.zeros(G, bool),
                         contigs=[Contig(name=name, start=0, length=G)])


def haploid_sample(seed: int, genome_len: int, n_snps: int,
                   read_len: int = 100, depth: float = 30.0) -> HaploidSample:
    """A uniform random genome, `n_snps` SNPs (one per equal block, at least
    MIN_SNP_GAP apart), and round(depth * genome_len / read_len) reads at
    uniform random starts, half of them reverse-complemented."""
    if genome_len < read_len or n_snps * MIN_SNP_GAP > genome_len:
        raise ValueError(
            f"genome of {genome_len} bases cannot hold {n_snps} SNPs "
            f"{MIN_SNP_GAP} apart or reads of {read_len}"
        )
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    block = genome_len // max(n_snps, 1)
    half = MIN_SNP_GAP // 2
    snp_pos = (
        np.arange(n_snps, dtype=np.int64) * block
        + half
        + rng.integers(0, block - 2 * half + 1, n_snps)
    )
    snp_alt = ((genome[snp_pos] + rng.integers(1, 4, n_snps)) % 4).astype(np.uint8)
    donor = genome.copy()
    donor[snp_pos] = snp_alt
    n_reads = int(round(depth * genome_len / read_len))
    starts = rng.integers(0, genome_len - read_len + 1, n_reads)
    reads = donor[starts[:, None] + np.arange(read_len)]
    reads[1::2] = (3 - reads[1::2])[:, ::-1]
    return HaploidSample(genome=genome, snp_pos=snp_pos, snp_alt=snp_alt,
                         reads=reads)


def write_fasta(path: str, genome: np.ndarray, name: str = "chr1",
                width: int = 80) -> None:
    seq = np.frombuffer(b"ACGT", np.uint8)[genome]
    full = len(seq) // width * width
    rows = seq[:full].reshape(-1, width)
    nl = np.full((len(rows), 1), ord("\n"), np.uint8)
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        f.write(np.concatenate([rows, nl], axis=1).tobytes())
        if full < len(seq):
            f.write(seq[full:].tobytes() + b"\n")


def write_fastq(path: str, reads: np.ndarray) -> None:
    """Fixed-width records '@r<9 digits>\\n<seq>\\n+\\n<qual>\\n' built in bulk."""
    R, L = reads.shape
    digits = 9
    if R >= 10**digits:
        raise ValueError(f"{R} reads do not fit {digits}-digit names")
    ids = np.arange(R, dtype=np.int64)
    head = np.empty((R, 2 + digits), np.uint8)
    head[:, 0] = ord("@")
    head[:, 1] = ord("r")
    for j in range(digits):
        head[:, 2 + j] = ord("0") + (ids // 10 ** (digits - 1 - j)) % 10
    nl = np.full((R, 1), ord("\n"), np.uint8)
    plus = np.tile(np.frombuffer(b"+\n", np.uint8), (R, 1))
    seq = np.frombuffer(b"ACGT", np.uint8)[reads]
    qual = np.full((R, L), ord("I"), np.uint8)
    rows = np.concatenate([head, nl, seq, nl, plus, qual, nl], axis=1)
    with open(path, "wb") as f:
        f.write(rows.tobytes())


def record_key(r: dict) -> tuple:
    """(chrom, pos, ref, alt, support) of a discovery record."""
    return (r["chrom"], int(r["pos"]), r["ref"], r["alt"], int(r["support"]))


def record_digest(records: Iterable) -> str:
    """sha256 over the sorted record keys: equal iff the record sets are."""
    h = hashlib.sha256()
    for key in sorted(record_key(r) for r in records):
        h.update(repr(key).encode())
    return h.hexdigest()


def truth_match(calls: Iterable[tuple], sample: HaploidSample) -> dict:
    """Recall and precision of calls against the planted SNPs.

    calls: (pos, ref, alt) with 1-based VCF positions on the sample's one
    contig.  A call is true when it is a single-base substitution at a
    planted position with the planted alternate base."""
    calls = list(calls)
    truth = {
        (int(p) + 1, "ACGT"[int(a)]) for p, a in zip(sample.snp_pos, sample.snp_alt)
    }
    called = {(int(p), alt) for p, ref, alt in calls if len(ref) == len(alt) == 1}
    tp = len(truth & called)
    return {
        "truth": len(truth),
        "calls": len(calls),
        "true_positives": tp,
        "recall": tp / max(len(truth), 1),
        "precision": tp / max(len(calls), 1),
    }
