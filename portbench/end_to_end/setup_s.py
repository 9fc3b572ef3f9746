"""Set-up seconds: from the process's start to the window's, by the host's
clock: imports, the card's start, kernel builds, inputs, the index and
the warm-up."""


def read(run):
    return run.window["setup_s"]
