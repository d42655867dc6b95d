"""Case storage and the metadata columns for on-device filtering."""
