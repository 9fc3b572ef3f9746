"""Read k-mers of all requests completed in the window, both strands, over
the window's seconds to the last completion (host clock)."""


def read(run):
    return run.window["work"] / run.window["seconds"]
