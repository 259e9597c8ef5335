"""A layer's least time on the card: the byte arithmetic of each layer
(bytes.py) over the published peaks (peaks.py)."""
