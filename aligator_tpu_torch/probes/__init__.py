"""Microbenchmarks of the kernels' building blocks on the card (port of
``scripts/``'s probes). Nothing here runs on a solver path."""
