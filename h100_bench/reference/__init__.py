"""Plain PyTorch references that decide ``correct``.

They import neither JAX nor the port: every weight, table and order they use
is worked out here from what the benchmark hands to both sides.
"""
