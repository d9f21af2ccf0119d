"""Host milliseconds a kernel launch spent hashing traces into the result
cache's keys: the program's ``sweep.cell_key`` span (``cache.cell_key`` over
every cell of a ``run_sweep``), its total over the traced window, over the
kernel launches the program counted. None where the program has no such
span."""


def read(ctx):
    n = sum(ctx["launches"].values())
    try:
        from repro_torch import obs
    except ImportError:
        return None
    row = obs.SPANS.get("sweep.cell_key")
    if not n or row is None:
        return None
    return row[1] * 1e-6 / n
