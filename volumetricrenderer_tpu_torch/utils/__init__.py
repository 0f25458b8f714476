"""Debug and observability helpers."""
