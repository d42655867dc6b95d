"""Fused hybrid search and host caches."""
