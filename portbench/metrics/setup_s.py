"""Set-up: from the process's start to the window's (imports, kernel build or
load, weights, inputs, warm-up)."""


def read(run):
    return run.setup_s
