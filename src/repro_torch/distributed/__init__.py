from repro_torch.distributed.sharding import (batch_pspecs, cache_pspecs,
                                              dp_axes, pad_heads_for,
                                              param_pspecs)

__all__ = ["param_pspecs", "batch_pspecs", "cache_pspecs", "dp_axes", "pad_heads_for"]
