"""Model 'sftgan' in bf16 on the card against the benchmark's plain
reference (``port_bench/reference/sftgan.py``): SFTNet at its published
16 blocks serves a uint8 LR image of 48x64 and its 8-class maps through
``test_async``; its relative RMS error against the f32 reference (TF32 off)
is held to the ``sr_rms_vs_bf16`` limit of the ``sftgan_serve`` cell, as a
multiple of the same network computed in plain bf16
(``nets.Bf16Conv``), and no RDB kernel runs.

Imports neither jax nor the JAX package, so it runs where only the port is
installed, without the suite's conftest:

    python3 -m pytest --noconftest tests/test_torch_sftgan_card.py

Every test is marked ``cuda`` and skips without a card."""

import json
from pathlib import Path

import pytest
import torch

from port_bench import compare, harness
from port_bench.reference import nets, sftgan
from port_bench.traffic import sft_closed_loop_serve

REPO = Path(__file__).resolve().parents[1]
H, W, SEED = 48, 64, 11


@pytest.mark.cuda
def test_bf16_facade_on_the_card_matches_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from dasr_tpu_torch.core.device import resolve_device
    from dasr_tpu_torch.models.registry import create_model
    from dasr_tpu_torch.ops.rdb import fused_rdb

    dev = resolve_device("cuda")
    cell = json.loads((REPO / "port_bench/workloads/sftgan_serve.json").read_text())
    opt = json.loads((REPO / "port_bench/configs/sftgan.json").read_text())["opt"]
    model = create_model(opt, dev)
    model.g.to(dev, memory_format=torch.channels_last).eval()
    weights = harness.draw_params(sftgan.sftnet_spec(), SEED, "G", dev)
    harness.load_params(model.g, weights, "G")
    lr = harness.images_u8((1, H, W, 3), SEED, "lr0", dev)[0]
    seg = sft_closed_loop_serve.seg_maps(H, W, cell["params"], SEED, "seg0", dev)
    launches = fused_rdb.launches
    served = model.test_async(lr.cpu().numpy(), seg.cpu().numpy()).cpu().numpy()
    assert fused_rdb.launches == launches
    with nets.f32_exact():
        ref, plain = (sftgan.sft_image(weights, lr, seg, conv).cpu().numpy()
                      for conv in (nets.conv_f32, nets.Bf16Conv()))
    rms = compare.serve_numbers([(served, ref, plain)])["sr_rms_vs_bf16"]
    assert rms <= cell["limits"]["sr_rms_vs_bf16"], rms
