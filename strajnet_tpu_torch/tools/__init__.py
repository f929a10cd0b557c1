"""Measuring tools of the port on the card, and the Keras-checkpoint import
CLI; counterparts of the JAX package's ``bench.py``, ``__graft_entry__.py``
and ``tools/``."""
