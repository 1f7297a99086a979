"""batch_size_mean.<kind>: the mean size of the batches the port's
DynamicBatcher dispatched in the untraced window (its `batch_sizes`
counter, read from the window's first batch on)."""


def read(run):
    sizes = run.record.get("batch_sizes")
    if not sizes:
        return None
    return sum(sizes) / len(sizes)
