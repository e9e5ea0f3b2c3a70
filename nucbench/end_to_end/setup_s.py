"""``setup_s`` (s): from the interpreter's first statement to the window's
start: imports, CUDA, the kernels' build or load, the inputs made from the
seed, and the warm-up of the cell's shapes."""


def read(summary: dict):
    return summary.get("setup_s")
