"""The parallel layer of the port: device meshes, the data-parallel batch
codec and analyses, the block-sharded long-sequence mode, and the runtime
across processes.

The port's counterpart of ``cute_nucleotides_tpu/parallel``, with its
names:

* **Data parallel** -- batches of reads sharded over a mesh's ``"data"``
  axis (:func:`data_parallel_encode`, :class:`ShardedCodec`, and the
  analyses :func:`kmer_spectrum`, :func:`match_counts`,
  :func:`sketch_sharded`, :func:`edit_distances`).
* **Sequence/block parallel** -- one very long sequence split over the
  ``"seq"`` axis at word-aligned boundaries, so packed words concatenate
  bit-exactly and scans see a halo of the next shard
  (:mod:`.longseq`).
* **Across processes** -- :func:`.runtime.initialize` joins a
  ``torch.distributed`` group (one card a rank); then :func:`default_mesh`
  spans the group, the forms above compute each rank's own shards and
  reduce over the group (NCCL on the card, gloo on the CPU), and each rank's
  streams consume its own residue class of records (:mod:`.runtime`).

A :class:`.mesh.Mesh` is driven by one process (its collectives run on the
host) or spans the ranks of a group (one ``torch.distributed`` collective
each) (:mod:`.mesh`).
"""

from .mesh import make_mesh, default_mesh  # noqa: F401
from .data_parallel import (  # noqa: F401
    ShardedCodec,
    data_parallel_decode,
    data_parallel_encode,
    edit_distances,
    kmer_spectrum,
    match_counts,
    sketch_sharded,
)
from .longseq import encode_long_2bit, encode_long_b5, decode_long_2bit, decode_long_b5  # noqa: F401
from .runtime import StreamConfig, StreamingDecoder, StreamingEncoder, initialize  # noqa: F401
