"""Adversarial losses of the SRN trainers.

Counterpart of the SRN part of ``dasr_tpu.losses.gan`` (reference
``GANLoss``, codes/SRN/models/modules/loss.py:8-40): 'vanilla' is BCE with
logits against a 1/0 target, 'lsgan' MSE, 'wgan'/'wgan-gp' the signed mean;
plus the relativistic-average pairing of SRRaGAN/DASR
(DASR_model.py:240-244). Losses are taken in f32 whatever the logits'
dtype. The DSN losses wait for the DSN stage (ROADMAP A.7).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gan_loss(pred: torch.Tensor, target_is_real: bool, gan_type: str = "vanilla") -> torch.Tensor:
    """SRN GANLoss parity; ``pred`` are logits ('vanilla'/'lsgan') or raw ('wgan')."""
    p = pred.float()
    t = 1.0 if target_is_real else 0.0
    if gan_type == "vanilla":
        return F.binary_cross_entropy_with_logits(p, torch.full_like(p, t))
    if gan_type == "lsgan":
        return torch.mean((p - t) ** 2)
    if gan_type in ("wgan", "wgan-gp"):
        return -p.mean() if target_is_real else p.mean()
    raise NotImplementedError(f"GAN type [{gan_type}] is not found")


def ragan_pair_loss(pred_fake, pred_real_detached, gan_type: str = "vanilla") -> torch.Tensor:
    """Relativistic-average generator-side pair (DASR_model.py:240-244)."""
    rf = pred_fake - pred_real_detached.mean(0, keepdim=True)
    fr = pred_real_detached - pred_fake.mean(0, keepdim=True)
    return (gan_loss(rf, True, gan_type) + gan_loss(fr, False, gan_type)) / 2
