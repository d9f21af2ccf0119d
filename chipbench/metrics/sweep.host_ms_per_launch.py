"""Host milliseconds a kernel launch in the sweep layer and entry: the
window's time in which the device was idle (each job's wall less the device
activity inside it; the jobs run back to back) over the kernel launches the
program counted."""


def read(ctx):
    n = sum(ctx["launches"].values())
    if not n or ctx["busy_s"] is None:
        return None
    return (ctx["window_s"] - ctx["busy_s"]) * 1e3 / n
