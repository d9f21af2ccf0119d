"""Host-to-device tensor copies a kernel launch: the program's
``engine.h2d_copies`` counter (each request field, window, rank and timing
array copied to the card) over the traced window, over the kernel launches
the program counted. None where the program has no such counter."""


def read(ctx):
    n = sum(ctx["launches"].values())
    try:
        from repro_torch import obs
    except ImportError:
        return None
    copies = obs.COUNTS.get("engine.h2d_copies")
    if not n or copies is None:
        return None
    return copies / n
