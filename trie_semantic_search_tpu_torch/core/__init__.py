"""Configuration and error types the serving slice reads."""
