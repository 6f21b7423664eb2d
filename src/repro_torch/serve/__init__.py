"""Megha-scheduled serving engine of the port (``engine.py``)."""
