"""The general harness: the cell's files found by name (``cell.py``), the
weights and data drawn from the seed (``weights.py``, ``data.py``), the
comparison that decides ``correct`` (``compare.py``) and the reduction of a
profiler trace (``trace.py``)."""
