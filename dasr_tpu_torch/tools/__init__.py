"""The port's experiment tools, each run as ``python -m
dasr_tpu_torch.tools.<name>``: ``make_synth_corpus`` (a synthetic
AIM2019-shaped corpus), ``ddm_ablation`` (the DDM-mechanism ablation
through the port's CLIs) and ``parity_dryrun`` (the parity procedure on a
stand-in checkpoint). Counterparts of the repository's ``tools/`` scripts,
which drive the JAX package."""
