"""Peak of the card's allocated memory in the window, in GiB:
``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
the window's start, so the resident index and the working set."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.window["peak_bytes"] / 2 ** 30
