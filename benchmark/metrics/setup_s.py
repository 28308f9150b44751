"""setup_s: from the process's start to the window's start (host clock):
imports, the CUDA context, the seeded frame pool, the program's set-up and
the cell's warm-up, and on a checkout's first run the kernels' build."""


def read(run):
    return run.setup_s
