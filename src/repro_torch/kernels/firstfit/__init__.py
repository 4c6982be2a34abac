"""K4: the gathered-tile FirstFit (``kernel.py``)."""
