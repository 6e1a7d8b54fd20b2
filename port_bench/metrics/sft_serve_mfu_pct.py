"""``sft_serve_mfu_pct``: SFTNet's model FLOPs of the images served in the
measured window (``flop`` in its record: the reference's count from the
conv shapes, ``reference/sftgan.py:sftnet_flop``, at each image's own
pixels), over the window times the H100's bf16 peak. Nothing is read
where the record holds no such count."""

from port_bench.reference.costs import PEAK_FLOPS_BF16


def read(run):
    r = run.record
    if not r.get("flop"):
        return None
    return 100.0 * r["flop"] / (r["window_s"] * PEAK_FLOPS_BF16)
