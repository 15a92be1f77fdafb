"""Run one benchmark cell once, from the root of a checkout::

    python3 pabench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m pabench.run ...``).  Exits non-zero, printing no result,
without the CUDA devices the cell asks for.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# run as a script, the first path entry is this folder: put the
# checkout's root there instead, so that ``pabench`` and the program
# import from it and no module here shadows one of the standard library
ROOT = str(Path(__file__).resolve().parent.parent)
if Path(sys.path[0] or ".").resolve() == Path(__file__).resolve().parent:
    sys.path[0] = ROOT

# the program's kernel caches at fixed paths inside the checkout, so that
# only a checkout's first run compiles
import os  # noqa: E402

CACHE = Path(ROOT, ".pabench_cache")
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")

from pabench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(T0))
