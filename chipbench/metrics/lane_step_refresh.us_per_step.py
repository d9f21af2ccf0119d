"""Device microseconds of the `lane_step` kernel a serial step in the
refresh ladder's cell, where all but the refresh-off point's launches run
the kernel's refresh path: its device time over the steps its launches
run."""
from chipbench.harness.readers import us_per_step


def read(ctx):
    return us_per_step(ctx, "lane_step")
