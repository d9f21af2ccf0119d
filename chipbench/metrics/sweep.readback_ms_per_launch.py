"""Host milliseconds a kernel launch spent bringing its results back: the
program's ``sweep.readback`` spans (each copy of counters or cycles to the
host after the device has finished, and their unpacking into the sweep's
results), their total over the traced window, over the kernel launches the
program counted. None where the program has no such span."""


def read(ctx):
    n = sum(ctx["launches"].values())
    try:
        from repro_torch import obs
    except ImportError:
        return None
    row = obs.SPANS.get("sweep.readback")
    if not n or row is None:
        return None
    return row[1] * 1e-6 / n
