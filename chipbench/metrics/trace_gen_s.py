"""Seconds of set-up spent generating the pass's traces through the
program's frontend (``trace_for`` -> ``generate_trace``, host clock)."""


def read(ctx):
    return ctx["trace_gen_s"]
