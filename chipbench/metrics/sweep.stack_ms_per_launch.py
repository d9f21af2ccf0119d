"""Host milliseconds a kernel launch spent stacking traces into a launch's
arrays: the program's ``sweep.stack`` span (``stack_traces`` in a
``run_sweep`` bucket, the mixes' stacking in ``simulate_multicore_batch``),
its total over the traced window, over the kernel launches the program
counted. None where the program has no such span."""


def read(ctx):
    n = sum(ctx["launches"].values())
    try:
        from repro_torch import obs
    except ImportError:
        return None
    row = obs.SPANS.get("sweep.stack")
    if not n or row is None:
        return None
    return row[1] * 1e-6 / n
