"""What the read-mapping drivers share: the index from the configuration's
index module, a pool of requests drawn from the seed, the outputs kept
for the check, and the check and yardstick after the window.

A request is what ``map_reads`` does after its index load, on one file
of reads: its k-mers on both strands (``include_reverse_complements``)
mapped to node counts, copied to the host once. A file holds
``reads_per_request`` reads of one sample's haplotype. The window cycles
through the pool, one request in flight.
"""
from __future__ import annotations

import torch

from . import checks, genome as gen, harness, reference, roofline


class MapState:
    def __init__(self, run, fmt):
        dev = run.device
        t = run.traffic
        self.idx = harness.load_module("indexes", run.config["index"]).make(run)
        self.n_nodes = self.idx.n_nodes
        genome = self.idx.genome
        hap, poly_a = gen.sample_haplotype(genome, t, run.seed)
        self.reads = []  # per pool item, (n_reads, length) int8 on the host
        self.pool = []
        for item in range(int(t["pool_requests"])):
            g = gen.generator(run.seed, f"reads/{item}", dev)
            reads = gen.sample_reads(hap, poly_a, t,
                                     int(t["reads_per_request"]), g,
                                     int(run.config["poly_a_length"]))
            self.reads.append(reads.cpu())
            self.pool.append(fmt(run, item, reads))
            del reads
        del hap
        self.idx.genome = None  # the reference makes its own again
        self.sample = harness.Sample(gen.sub_seed(run.seed, "sample"),
                                     harness.COUNT_SAMPLE)
        self.last = None
        self.rows = None

    def keep(self, i: int, item: int, kmers, counts) -> None:
        """Keep a request's counts for the check (a sample drawn from the
        seed, and the last request), and the last request's k-mers where
        the port made them."""
        self.sample.offer(i, (item, counts))
        self.last = (i, item, kmers, counts)


def warm_up(run, state, step) -> None:
    """Every shape of the window: one request of each kind (the requests
    of a pool have one shape), twice, so that the allocator holds its
    blocks; then the kept outputs are dropped."""
    for i in range(2):
        step(run, state, i)
    state.sample = harness.Sample(gen.sub_seed(run.seed, "sample"),
                                  harness.COUNT_SAMPLE)
    state.last = None
    run.spans.seconds.clear()
    run.program_stages.clear()


def finish(run, state) -> None:
    """The packed tables go before the reference runs; the index's
    columns stay, to be judged."""
    state.idx.index.device_index = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def check(run, state) -> list:
    """The index against the reference's rows; the last request's read
    k-mers where the port hashed them; the node counts of the kept
    requests."""
    dev = run.device
    idx = state.idx
    state.rows = idx.reference_rows(dev)
    found = checks.index_checks(idx.index, state.rows, idx.modulo, dev)
    idx.index = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    i_last, item, kmers, counts = state.last
    if kmers is not None:
        want = reference.batch_hashes(state.reads[item].to(dev))
        found.append(("read_hashes",
                      checks.mismatches(torch.cat(kmers.segments), want),
                      checks.LIMIT))
        del want
    state.last = None
    kept = dict(state.sample.kept)
    kept[i_last] = (item, counts)
    found.append(("node_counts", checks.count_checks(
        kept, lambda j: state.reads[j].to(dev), state.rows[:2],
        state.n_nodes, dev), checks.LIMIT))
    return found


def yardstick(run, state, launches: int, hashed: bool) -> None:
    """Bytes that K1 and K2 had to move in the window, from the reads'
    shapes and the reference's rows and hashes: the roofline metrics'
    numerators. ``launches``: the K2 launches a request makes, each over
    an equal share of its queries in order; ``hashed``: whether the port
    hashed the reads (K1)."""
    dev = run.device
    sizes = roofline.BucketSizes(state.rows[0], state.rows[1])
    n_items = len(state.pool)
    k2 = 0
    for item in range(n_items):
        requests = len(range(item, run.requests, n_items))
        if not requests:
            continue
        queries = reference.batch_hashes(state.reads[item].to(dev))
        per_request = sum(roofline.k2_bytes(sizes, q, state.n_nodes)
                          for q in queries.chunk(launches))
        k2 += requests * per_request
    run.yard.update(k2_bytes=k2, requests=run.requests)
    if hashed:
        n_bases = sum(r.numel() for r in state.reads) // n_items
        run.yard.update(k1_bytes=run.requests * roofline.k1_bytes(n_bases))
