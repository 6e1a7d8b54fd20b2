"""``device_idle_pct.train``: the share of the traced window of whole K-step
train calls in which no kernel, copy or memset ran on the card
(``trace.Reduced.idle_pct``)."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
