"""graph_kmer_index_tpu_torch — the PyTorch/CUDA port of graph_kmer_index_tpu.

Three paths are ported. Read mapping (KAGE's mapping hot loop):

    FASTA/FASTQ -> 2-bit read tape -> sliding-window k-mer hashes (kernel
    K1, ``csrc/sliding_hash.cu``) -> packed-record lookup in a
    collision-free index (kernel K2, ``csrc/packed_lookup.cu``) -> per-node
    hit counts.

And the build that feeds it:

    variant graph -> critical paths -> pooled host span walk (the native
    C++ walker, ``csrc/host/``) -> span expansion on the device
    (``ops.finalize``, hashing the span tapes with K1) -> collision-free
    index with frequencies (``KmerIndex.from_flat_kmers``) -> packed table.

And the variant-signature path, which makes what KAGE ships:

    reference + VCF variants -> ``build_graph_from_vcf`` -> the scoring
    index above -> ``SnpKmerFinder`` (a sweep of the linear reference,
    hashed by K1) -> ``UniqueVariantKmersFinder`` (signature k-mers per
    variant, scored by ``KmerIndex.get_frequencies`` on the index's
    device) -> signature ``KmerIndex`` with its reverse, reference and
    variant-nodes indexes -> ``IndexBundle`` on disk -> read counts.

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
    **dict.fromkeys((
        "power_array", "reverse_power_array", "letter_sequence_to_numeric",
        "numeric_to_letter_sequence", "kmer_to_hash_fast", "update_hash",
        "sequence_to_kmer_hash", "kmer_hash_to_sequence",
        "kmer_hashes_to_bases", "kmer_hashes_to_complement_hashes",
        "kmer_hashes_to_reverse_complement_hash",
        "kmer_hash_to_reverse_complement_hash"), ".hashing"),
    "CriticalGraphPaths": ".critical_paths",
    "DenseKmerFinder": ".finder",
    "FlatKmers": ".flat_kmers", "FlatKmers2": ".flat_kmers",
    "Graph": ".graph", "PositionId": ".graph", "VariantToNodes": ".graph",
    "SnpKmerFinder": ".snp_finder", "IndelKmerFinder": ".snp_finder",
    "bionumpy_hash": ".bionumpy_wrapper",
    "KmerIndex": ".models.kmer_index",
    "CollisionFreeKmerIndex": ".models.kmer_index",
    "MinimalKmerIndex": ".models.kmer_index",
    "KmerIndex2": ".models.kmer_index",
    "CounterKmerIndex": ".models.kmer_index",
    "ReverseKmerIndex": ".models.reverse_index",
    "ReferenceKmerIndex": ".models.reference_index",
    "UniqueKmerIndex": ".models.unique_index",
    "VariantNodesIndex": ".models.variant_nodes_index",
    "KmerCounter": ".models.counters",
    "CountMinSketchKmerCounter": ".models.counters",
    "KmerFrequencyIndex": ".models.counters",
    "IndexBundle": ".models.bundle",
    "VcfVariant": ".variants", "VcfVariants": ".variants",
    "build_graph_from_vcf": ".graph_builder",
    "build_graph_from_files": ".graph_builder",
    "UniqueVariantKmersFinder": ".unique_variant_kmers",
    "sample_kmers_from_structural_variants": ".structural_variants",
    "ReadKmers": ".read_kmers", "DeviceReadKmers": ".read_kmers",
    "hash_fasta_file": ".read_kmers",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module, __name__), name)
    globals()[name] = value
    return value
