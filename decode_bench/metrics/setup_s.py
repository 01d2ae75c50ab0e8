"""Seconds from the process's start to the window's, less the making of
the streams from the seed: imports, CUDA start, the builds (cached after
the first run), the program's Phase A and the warm-up calls."""


def read(w):
    return w.setup_s
