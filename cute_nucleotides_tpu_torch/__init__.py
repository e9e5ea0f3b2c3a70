"""tpu-nucleotides on PyTorch and CUDA: the 2-bit and base-5 nucleotide codecs,
packed-domain search and k-mer counting.

The port of ``cute_nucleotides_tpu`` (the JAX package, kept as the
reference) to PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a).  Tiers: ``torch`` (eager PyTorch, any device), ``cuda`` (the
kernels) and ``auto``.  The package imports nothing of the reference: it
keeps its own copies of the host layers it needs -- the bit contract
(``ops.spec``), the host oracles (``ops.oracle``, ``ops.native``), the
FASTA/FASTQ readers (``utils.io``) and the ``.nup`` container (``nup``).
Nothing here imports JAX.
"""

__version__ = "0.1.0"

#: tiers of the api and the CLI (models takes all but "oracle"); kept here,
#: free of torch, so that the CLI's --help imports no torch
TIERS = ("oracle", "torch", "cuda", "auto")

_LAZY = ("api", "cli", "compat", "interop", "models", "ops", "parallel")


def __getattr__(name):
    # torch-dependent layers load on first touch
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
