"""One run of one cell of the benchmark of the PyTorch/CUDA port
(``uvg266_tpu_torch``), from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

See ``benchmark/harness/cli.py`` and ``PERF.md``.
"""
import os
import sys

# one process with few threads: the BLAS pools of numpy do no work here
# that pays for the cores they take from the program's host threads
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
