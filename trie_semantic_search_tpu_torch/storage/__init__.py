"""Metadata columns for on-device filtering."""
