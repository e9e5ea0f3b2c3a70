"""Operators: the eager ``torch`` tier (:mod:`.eager`), validation
(:mod:`.validate`), packed-stream scans and counts (:mod:`.seqops`),
search (:mod:`.search`), k-mers (:mod:`.kmer`, :mod:`.sort`), the CUDA
kernels' wrappers (:mod:`.kernels`), and the host layers: the bit contract
(:mod:`.spec`) and the NumPy and C++ oracles (:mod:`.oracle`,
:mod:`.native`)."""
