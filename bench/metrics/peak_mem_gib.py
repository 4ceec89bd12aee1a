"""The allocator's peak over the window (`max_memory_allocated` after
`reset_peak_memory_stats` at the end of set-up), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
