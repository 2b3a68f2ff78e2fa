"""Chip-side tools that set the limits of ``correct``: the control and the faults."""
