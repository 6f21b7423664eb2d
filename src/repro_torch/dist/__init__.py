"""Distribution specs: the logical-axis -> mesh-axis policy (``sharding.py``)."""
