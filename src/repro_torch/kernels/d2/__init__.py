"""K6: the distance-2 FirstFit over two neighbour-colour tiles (``kernel.py``)."""
