"""Scripts that drive whole series of runs: the spread sets and the control."""
