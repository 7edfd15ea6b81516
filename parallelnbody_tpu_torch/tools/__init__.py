"""Measurement tools of the port (see each module)."""
