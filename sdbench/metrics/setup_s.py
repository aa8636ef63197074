"""setup_s: the process's start to the window's start (imports, modules,
weights from the seed, every program the traffic uses captured)."""

UNIT = "s"


def read(run):
    return run.setup_s
