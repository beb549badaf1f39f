"""setup_s: seconds from the process's start to the first timed job: the
imports, the data made from the seed, the warm-up job (the kernels' build
on a checkout's first run, their load from the build directory after)."""


def read(run):
    return run.setup_s
