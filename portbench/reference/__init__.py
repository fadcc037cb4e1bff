"""The benchmark's plain reference: a frozen copy of the port's serial
float64 path (``port/``) and, per configuration, the builder of the same
problem from the same inputs (``<config>.py``). Nothing here imports the
port."""
