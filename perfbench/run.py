"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the ``marlsnake_torch`` package.
Prints one JSON object as its last line (see ``perfbench/harness.py``).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('TRITON_CACHE_DIR', 'triton'),
                 ('CUDA_CACHE_PATH', 'cuda_cache')):
    os.environ[var] = os.path.join(ROOT, 'build', 'perfbench', sub)
# Python's bytecode too is compiled once into the checkout: where the
# interpreter is told not to write it (PYTHONDONTWRITEBYTECODE), every run
# would compile torch's sources again, some seconds of set-up each time
sys.dont_write_bytecode = False
sys.pycache_prefix = os.path.join(ROOT, 'build', 'perfbench', 'pycache')
sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402

if __name__ == '__main__':
    sys.exit(harness.main(sys.argv[1:], T_START))
