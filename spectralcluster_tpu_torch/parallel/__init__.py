"""Batch clustering over a device mesh (``mesh.py``, ``batch.py``)."""
