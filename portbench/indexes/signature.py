"""The signature index of a whole-genome variant graph, as KAGE maps reads
against it: one k-mer an allele node, the k-base window of the reference
with the allele in place, centred on the allele (standing in for the
signature search's choice), hashed by the port's K1 and built into a
``KmerIndex`` at the configuration's modulo on the card."""
from __future__ import annotations

import torch

from portbench.lib import genome as gen
from portbench.lib import reference

# windows hashed by K1 in one launch during set-up
WINDOW_BLOCK = 1 << 22


class SignatureIndex:
    def __init__(self, run):
        from graph_kmer_index_tpu_torch.flat_kmers import FlatKmers
        from graph_kmer_index_tpu_torch.models.kmer_index import KmerIndex
        from graph_kmer_index_tpu_torch.ops.encode import sliding_hashes

        dev = run.device
        self.run = run
        self.modulo = int(run.config["modulo"])
        # the inputs' generator; set-up drops it once the reads are drawn
        self.genome = gen.make_genome(run.config, run.seed, dev)
        self.n_nodes = self.genome.n_nodes
        windows = gen.signature_windows(self.genome, WINDOW_BLOCK)
        n = windows.shape[0]
        hashes = torch.empty(n, dtype=torch.int64, device=dev)
        for lo in range(0, n, WINDOW_BLOCK):
            tape = windows[lo:lo + WINDOW_BLOCK].reshape(-1)
            hashes[lo:lo + WINDOW_BLOCK] = sliding_hashes(tape, gen.K)[::gen.K]
        del windows
        row = torch.arange(n, device=dev)
        nodes = ((row // 2) * 3 + 2 + row % 2).to(torch.int32)
        flat = FlatKmers(hashes, nodes,
                         self.genome.pos.repeat_interleave(2),
                         torch.ones(n, dtype=torch.float32, device=dev))
        self.index = KmerIndex.from_flat_kmers(flat, self.modulo, device=dev)

    def reference_rows(self, dev):
        """The reference's rows, from the configuration and the seed made
        anew: nothing of what set-up handed the port."""
        genome = gen.make_genome(self.run.config, self.run.seed, dev)
        windows = gen.signature_windows(genome, WINDOW_BLOCK)
        return reference.signature_rows(windows,
                                        genome.pos.to(torch.int64))


def make(run) -> SignatureIndex:
    return SignatureIndex(run)
