"""Share of K2's queries that the packed record's lanes answer, with no
bucket scan: 100 x (1 - ``k2.pending`` / ``k2.queries``), from the
port's K2 counters over the traced window, in percent."""
from portbench.lib import program


def read(run):
    c = program.k2_counters(run)
    if c is None:
        return None
    return 100.0 * (1.0 - c["k2.pending"] / c["k2.queries"])
