"""Sequence parallelism of the port (``tpu_engine/parallel``): ring attention
with a pluggable K/V rotation; the ranks of the ring run in one process on
one device until the multi-GPU slice supplies a rotation across cards."""
