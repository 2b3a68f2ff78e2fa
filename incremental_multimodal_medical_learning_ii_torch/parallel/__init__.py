"""Parallelism over ranks (counterpart of the JAX package's ``parallel/``):
data parallelism (``mesh.py``) and the text tower's tensor-, sequence- and
pipeline-parallel encodes (``tp.py``, ``sp.py``, ``pp.py``)."""
