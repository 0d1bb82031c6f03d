"""Videos scored over the whole window, whole chunks from its start to the
read-back of the last one."""


def read(run):
    return run.raw["videos"] / run.window_s
