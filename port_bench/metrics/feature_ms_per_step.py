"""``feature_ms_per_step``: the device time of the VGG19-54 feature loss's two
forwards in the traced window's last step: the program's device phase
``feature`` (the feature net on the HR, then on the SR, and the l1 between
them, inside G's loss), read after the window's sync (``phase_ms`` in the
traced window's record). Nothing is read where the program marks no such
phase."""


def read(run):
    return ((run.trace_record or {}).get("phase_ms") or {}).get("feature")
