"""Share of the traced window in which no operation ran on the device."""


def read(ctx):
    if ctx["busy_s"] is None:
        return None
    return (1.0 - ctx["busy_s"] / ctx["window_s"]) * 100.0
