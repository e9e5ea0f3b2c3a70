"""``python -m nucbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""

import time

T0 = time.perf_counter()  # set-up is counted from here: imports, CUDA, build, inputs, warm-up

import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel caches at fixed paths inside the checkout, so that only a checkout's
# first run builds; the port's own nvcc build already lives there
os.environ["TRITON_CACHE_DIR"] = os.path.join(_ROOT, ".nucbench-cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_ROOT, ".nucbench-cache", "torch_extensions")

from nucbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
