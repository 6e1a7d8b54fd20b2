"""Adversarial losses.

Counterpart of ``dasr_tpu.losses.gan``. SRN (reference ``GANLoss``,
codes/SRN/models/modules/loss.py:8-40): 'vanilla' is BCE with logits
against a 1/0 target, 'lsgan' MSE, 'wgan'/'wgan-gp' the signed mean; plus
the relativistic-average pairing of SRRaGAN/DASR (DASR_model.py:240-244).
DSN (codes/DSN/loss.py:11-41): the generator's and discriminator's losses
on sigmoided scores, or WGAN's signed means, and the WGAN-GP penalty.
Losses are taken in f32 whatever the scores' dtype. The RaGAN batch means
are the global batch's in a world of several ranks (``dist.batch_mean``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from dasr_tpu_torch.core.dist import batch_mean


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


def ragan_pair_loss(pred_a, pred_b, gan_type: str = "vanilla") -> torch.Tensor:
    """The relativistic-average pair (DASR_model.py:240-244): ``pred_a``
    against ``pred_b``'s batch mean as real, ``pred_b`` against ``pred_a``'s
    as fake, halved. G's loss is (fake, detached real); D's (real, fake).
    The batch means are the global batch's (``dist.batch_mean``)."""
    ab = pred_a - batch_mean(pred_b)
    ba = pred_b - batch_mean(pred_a)
    return (gan_loss(ab, True, gan_type) + gan_loss(ba, False, gan_type)) / 2


_EPS = 1e-8


def dsn_generator_adv_loss(fake_scores: torch.Tensor, wasserstein: bool = False) -> torch.Tensor:
    """DSN generator texture loss on sigmoided D outputs (DSN/loss.py:11-22)."""
    s = fake_scores.float()
    return -s.mean() if wasserstein else (-torch.log(s + _EPS)).mean()


def dsn_discriminator_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor,
                           wasserstein: bool = False, grad_penalty=0.0) -> torch.Tensor:
    """DSN discriminator loss on sigmoided outputs (DSN/loss.py:25-41)."""
    r, f = real_scores.float(), fake_scores.float()
    if wasserstein:
        return -r.mean() + f.mean() + grad_penalty
    return -torch.log(r + _EPS).mean() - torch.log(1 - f + _EPS).mean()


def gradient_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor], real: torch.Tensor,
                     fake: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """WGAN-GP penalty (codes/SRN/models/modules/loss.py:43-62): the mean of
    (||dD/dx|| - 1)^2 at x = real + alpha (fake - real), with ``alpha`` one
    uniform draw per sample, shape (B, 1, 1, 1). The gradient keeps its
    graph (a double backward), so the penalty trains D."""
    interp = (real + alpha.to(real.dtype) * (fake - real)).detach().requires_grad_()
    (grads,) = torch.autograd.grad(d_apply(interp).sum(), interp, create_graph=True)
    norms = torch.sqrt((grads.float() ** 2).sum(dim=(1, 2, 3)) + 1e-12)
    return ((norms - 1.0) ** 2).mean()
