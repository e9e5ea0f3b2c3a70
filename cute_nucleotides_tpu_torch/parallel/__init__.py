"""The parallel layer of the port: the batch codec bound to one device and
the streaming runtime.

The port's counterpart of ``cute_nucleotides_tpu/parallel``, so far for one
device: :class:`.data_parallel.ShardedCodec` (upload, compute and download
streams on one card) and :mod:`.runtime` (:func:`.runtime.initialize`,
:class:`.runtime.StreamingEncoder`, :class:`.runtime.StreamingDecoder`).
The mesh, the functional data-parallel forms, the long-sequence mode and
runs across processes are not ported yet (ROADMAP queue 1 item 4).
"""

from .data_parallel import ShardedCodec  # noqa: F401
from .runtime import StreamConfig, StreamingDecoder, StreamingEncoder, initialize  # noqa: F401
