"""Measurement entry points of the port (run with ``python -m`` on the card)."""
