"""Device microseconds of the `mix_step` kernel a serial step (a request of
its chain): its device time over the steps its launches run."""
from chipbench.harness.readers import us_per_step


def read(ctx):
    return us_per_step(ctx, "mix_step")
