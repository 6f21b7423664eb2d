"""The three-term roofline (``analysis.py``), the analytic traffic and
collective models (``traffic.py``) and the results table (``report.py``)."""
