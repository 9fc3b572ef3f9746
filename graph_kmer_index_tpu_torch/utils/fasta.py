"""(The port's copy of graph_kmer_index_tpu/utils/fasta.py.)
Minimal FASTA reading (replaces the reference's pyfaidx dependency,
reference_kmer_index.py:108)."""
from __future__ import annotations


def read_fasta_sequence(file_name: str, reference_name: str | None = None) -> str:
    """Return the sequence of record ``reference_name`` (or the first)."""
    sequences: dict[str, list[str]] = {}
    current = None
    with open(file_name) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                current = line[1:].split()[0]
                sequences[current] = []
            else:
                sequences[current].append(line)
    if reference_name is None:
        reference_name = next(iter(sequences))
    return "".join(sequences[reference_name])


def read_fasta_sequences(file_name: str) -> dict:
    """All records as {name: sequence}."""
    return dict(iter_fasta_reads(file_name))


def iter_fasta_reads(file_name: str):
    """Yield (name, sequence) records."""
    name, parts = None, []
    with open(file_name) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(parts)
                name, parts = line[1:].split()[0], []
            else:
                parts.append(line)
    if name is not None:
        yield name, "".join(parts)
