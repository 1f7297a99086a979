"""device_idle.<kind>: the share (%) of a traced slice in which no
operation ran on the device: 1 minus the union of the profiler's device
intervals over the slice's wall length. One reader for every cell kind
(`.batch`, `.serve`, `.stream`)."""


def read(run):
    trace = run.trace_data
    if trace is None or trace.window_s <= 0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
