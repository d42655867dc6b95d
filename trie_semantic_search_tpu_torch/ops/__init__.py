"""Tensor operations of the serving path and the Hopper kernel wrappers."""
