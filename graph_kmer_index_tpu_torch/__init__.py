"""graph_kmer_index_tpu_torch — the PyTorch/CUDA port of graph_kmer_index_tpu.

This slice ports the read-mapping path (KAGE's mapping hot loop):

    FASTA/FASTQ -> 2-bit read tape -> sliding-window k-mer hashes (kernel
    K1, ``csrc/sliding_hash.cu``) -> packed-record lookup in a
    collision-free index (kernel K2, ``csrc/packed_lookup.cu``) -> per-node
    hit counts.

The package imports neither ``jax`` nor ``graph_kmer_index_tpu``: the
machine with the card has no JAX, so the few numpy host helpers the slice
needs live in :mod:`.hashing`. Every function takes an explicit
``torch.device``; a CUDA tensor goes through the hand-written kernel and a
CPU tensor through the kernel's plain PyTorch twin.
"""
from .device import require_cuda, resolve_device  # noqa: F401
from .models.kmer_index import KmerIndex  # noqa: F401
from .read_kmers import DeviceReadKmers, hash_fasta_file  # noqa: F401
