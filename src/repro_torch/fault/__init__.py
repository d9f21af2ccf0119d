from repro_torch.fault.watchdog import (StepWatchdog, StragglerEvent,
                                        SupervisedRun)

__all__ = ["StepWatchdog", "StragglerEvent", "SupervisedRun"]
