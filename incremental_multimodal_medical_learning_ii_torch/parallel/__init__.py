"""Data parallelism over ranks (counterpart of the JAX package's ``parallel/``;
its data-parallel half: ``mesh.py``)."""
