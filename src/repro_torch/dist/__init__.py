"""Distribution utilities: gradient compression.

The port's ``repro.dist`` so far holds :mod:`.compression`, the
error-feedback int8 gradient compressor used by
``TrainConfig(grad_compression=True)``.  ``repro.dist.sharding`` (the
mesh's pspec trees) waits for the port's multi-card slice: the port's
trainer is a single-device step (``ROADMAP.md``).
"""
from . import compression

__all__ = ["compression"]
