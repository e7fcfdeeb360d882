"""The port's benchmark harness (see README.md)."""
