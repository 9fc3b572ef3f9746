"""Share of the traced window in which the card ran no kernel, copy or
memset, in percent."""
from portbench.lib import readers


def read(run):
    return readers.idle_share_percent(run)
