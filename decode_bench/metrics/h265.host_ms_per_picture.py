"""Host milliseconds per picture inside the H.265 batch entry
(``H265SeqPhaseB.run_async``): the harness's spans around each call,
over the pictures of the window."""


def read(tr):
    s = tr.span_s("h265.run")
    return 1e3 * s / tr.pictures if s and tr.pictures else None
