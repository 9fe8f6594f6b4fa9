"""Measurement scripts behind design choices of the port's kernels (run on a
CUDA card; each prints its numbers and names the card)."""
