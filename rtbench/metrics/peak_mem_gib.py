"""``torch.cuda.max_memory_allocated`` over the window (reset when it
opens), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
