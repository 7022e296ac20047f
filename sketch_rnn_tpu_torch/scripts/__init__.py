"""Port of the JAX package's probe scripts (``scripts/probe_*.py``)."""
