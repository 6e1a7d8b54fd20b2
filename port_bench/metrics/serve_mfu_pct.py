"""``serve_mfu_pct``: the generator's model FLOPs of the images served in
the window (the benchmark's count from the conv shapes at each image's own
pixels; tile halos and padding are recomputation and not counted), over
the window times the H100's bf16 peak."""

from port_bench.reference.costs import PEAK_FLOPS_BF16, rrdbnet_flop_per_px


def read(run):
    r = run.record
    if not r.get("lr_pixels"):
        return None
    g = run.config["opt"]["network_G"]
    flop = rrdbnet_flop_per_px(nf=g["nf"], nb=g["nb"], gc=g["gc"]) * sum(r["lr_pixels"])
    return 100.0 * flop / (r["window_s"] * PEAK_FLOPS_BF16)
