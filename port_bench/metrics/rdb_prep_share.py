"""``rdb_prep_share``: the share of the bf16 RDB calls on the card under
autograd that took their network's prepared weights (the program's counters
``fused_rdb.prepared`` and ``fused_rdb.cast``, ``dasr_tpu_torch/utils/
trace.py``, which the step graph credits per replay), counted over the whole
run: set-up's checked calls and every window. 1.0 where one launch a
generator forward prepares every RDB's kernels and dgrad weight images;
nothing is read where the program keeps neither counter."""


def read(run):
    try:
        from dasr_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = trace.counters()
    prepared, cast = counts.get("fused_rdb.prepared", 0), counts.get("fused_rdb.cast", 0)
    if not prepared + cast:
        return None
    return prepared / (prepared + cast)
