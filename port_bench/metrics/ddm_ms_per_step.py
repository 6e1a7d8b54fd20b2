"""``ddm_ms_per_step``: the device time of the online domain-distance map in
the traced window's last step: the program's device phase ``ddm`` (the
patch D's forward through the resize of its map, before ``g_forward``),
read after the window's sync (``phase_ms`` in the traced window's record).
Nothing is read where the program marks no such phase."""


def read(run):
    return ((run.trace_record or {}).get("phase_ms") or {}).get("ddm")
