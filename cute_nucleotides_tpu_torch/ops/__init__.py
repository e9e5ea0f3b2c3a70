"""Codec operators: the eager ``torch`` tier (:mod:`.eager`), validation
(:mod:`.validate`) and the CUDA kernels' wrappers (:mod:`.kernels`)."""
