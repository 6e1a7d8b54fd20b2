"""``sft_branch_ms``: the device time of SFTNet's SFT branch for the traced
window's last image: the program's device phase ``sft_branch`` (the
image's cast, ``conv0``, the 16 SFT residual blocks, the last SFT layer and
its conv), read after the window's last readback (``phase_ms`` in the
traced window's record). Nothing is read where the program marks no such
phase."""


def read(run):
    return ((run.trace_record or {}).get("phase_ms") or {}).get("sft_branch")
