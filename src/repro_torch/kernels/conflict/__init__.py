"""K5: the gathered-tile conflict test (``kernel.py``)."""
