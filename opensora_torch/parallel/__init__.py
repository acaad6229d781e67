"""Mesh, process-wide mesh context and the ring transport between ranks."""
