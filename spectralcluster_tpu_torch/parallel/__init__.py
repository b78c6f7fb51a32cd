"""Clustering over a device mesh: batches (``batch.py``) and one large
recording row-sharded over the ``model`` axis (``sharded.py``, ``ring.py``,
``stripes.py``, ``collectives.py``, ``sanity.py``), on ``mesh.py``'s mesh."""
