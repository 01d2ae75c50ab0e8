"""CUDA kernels the program launched in the traced window, per picture
(the harness's own digest kernels left out)."""


def read(tr):
    n = len(tr.program_kernels())
    return n / tr.pictures if n and tr.pictures else None
