"""Simulation harness of the port (``run_simulation``)."""
