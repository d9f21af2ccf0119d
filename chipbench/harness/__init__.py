"""The harness: one general traffic generator, the program adapter, the trace
reduction and the check."""
