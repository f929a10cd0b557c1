"""Data parallelism over ranks (``ddp``): the counterpart of the ``'data'``
axis of ``strajnet_tpu/parallel/mesh.py``."""
