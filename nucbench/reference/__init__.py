"""The plain reference that decides ``correct``: plain PyTorch from the
crate's bit contract and Myers' recurrence, written without the port.  It
imports nothing of ``cute_nucleotides_tpu_torch`` and takes nothing the port
made: the benchmark hands it the same inputs it hands the port, and it works
out again whatever the port derives from them.
"""
