"""Sequence parallelism of the port (``tpu_engine/parallel``): ring attention
with a pluggable K/V rotation (every rank in one process, or a rank a
process), Ulysses attention across ranks, and the collectives of the mesh
program (``collectives.py``, ``zero.py``)."""
