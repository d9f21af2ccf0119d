"""Core subsystems of the port (the DRAM simulator)."""
