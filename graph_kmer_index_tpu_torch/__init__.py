"""graph_kmer_index_tpu_torch — the PyTorch/CUDA port of graph_kmer_index_tpu.

Two paths are ported. Read mapping (KAGE's mapping hot loop):

    FASTA/FASTQ -> 2-bit read tape -> sliding-window k-mer hashes (kernel
    K1, ``csrc/sliding_hash.cu``) -> packed-record lookup in a
    collision-free index (kernel K2, ``csrc/packed_lookup.cu``) -> per-node
    hit counts.

And the build that feeds it:

    variant graph -> critical paths -> pooled host span walk (the native
    C++ walker, ``csrc/host/``) -> span expansion on the device
    (``ops.finalize``, hashing the span tapes with K1) -> collision-free
    index with frequencies (``KmerIndex.from_flat_kmers``) -> packed table.

The package imports neither ``jax`` nor ``graph_kmer_index_tpu``: the
machine with the card has no JAX, so the host layer (graph, finder,
containers, hashing, the native library's loader) is the port's own copy.
Every device function takes an explicit ``torch.device``; a CUDA tensor
goes through the hand-written kernel and a CPU tensor through the kernel's
plain PyTorch twin. The host layer imports numpy alone; torch comes in
with the first device module.
"""
import importlib

# name -> submodule, resolved at first use: the pooled find's worker
# processes (parallel.proc_pool) import this package for its host layer
# only (graph, finder, native walker: numpy), and importing torch costs
# each of them seconds of start-up that they would never use
_EXPORTS = {
    "require_cuda": ".device", "resolve_device": ".device",
    "CriticalGraphPaths": ".critical_paths",
    "DenseKmerFinder": ".finder",
    "FlatKmers": ".flat_kmers", "FlatKmers2": ".flat_kmers",
    "Graph": ".graph", "PositionId": ".graph", "VariantToNodes": ".graph",
    "KmerIndex": ".models.kmer_index",
    "DeviceReadKmers": ".read_kmers", "hash_fasta_file": ".read_kmers",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module, __name__), name)
    globals()[name] = value
    return value
