"""The `lane_step` kernel's share of its HBM roofline in the refresh
ladder's cell: its requests read once and its counters written once, at
the card's published bandwidth, over its device time."""
from chipbench.harness.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "lane_step")
