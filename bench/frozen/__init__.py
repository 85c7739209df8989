"""Frozen copies of the arithmetic the metrics are computed with: the
card's published peaks, the kernels' bounds and the models' FLOPs."""
