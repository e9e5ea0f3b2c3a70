"""Codec operators: the eager ``torch`` tier (:mod:`.eager`), validation
(:mod:`.validate`), packed-stream scans (:mod:`.seqops`) and the CUDA
kernels' wrappers (:mod:`.kernels`)."""
