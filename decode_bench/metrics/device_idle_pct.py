"""The share of the traced window in which no operation ran on the
device, in %: 100 less the union of kernel, copy and set intervals."""


def read(tr):
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s) if tr.window_s else None
