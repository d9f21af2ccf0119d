"""Host milliseconds a kernel launch spent packing its inputs on the device:
the program's ``engine.pack`` span (``lane_inputs`` / ``mix_inputs``: the
window check, the host-to-device copies, IDEAL's rewrite and the range
check's sync), its total over the traced window, over the kernel launches
the program counted. None where the program has no such span."""


def read(ctx):
    n = sum(ctx["launches"].values())
    try:
        from repro_torch import obs
    except ImportError:
        return None
    row = obs.SPANS.get("engine.pack")
    if not n or row is None:
        return None
    return row[1] * 1e-6 / n
