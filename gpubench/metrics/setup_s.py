"""setup_s: from the process's start to the window's (host clock): imports,
the world and inputs from their seeds, the program's set-up, warm-up."""


def read(run):
    return run.setup_s
