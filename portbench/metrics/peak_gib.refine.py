"""Peak device memory of the refine window (the allocator's counter), GiB."""


def read(run):
    peak = run.stats.get("peak_bytes")
    return None if not peak else peak / 1024.0**3
