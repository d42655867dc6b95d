"""Host-side text processing."""
