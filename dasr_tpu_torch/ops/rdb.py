"""Residual Dense Block (RDB5C) forward: the hand-written CUDA kernel and its
plain PyTorch version.

What it computes: exactly ``dasr_tpu.ops.pallas_rdb._scatter_reference``.
For k = 1..4, x_k = lrelu_0.2(conv3x3_k([x, x_1..x_{k-1}]) + b_k), rounded
to the working type before the next conv; the output is
x + 0.2 * (conv3x3_5([x, x_1..x_4]) + b_5), accumulated in f32 and rounded
once. Every conv is SAME with zero padding.

Which TPU kernel it replaces: ``dasr_tpu/ops/pallas_rdb.py:_rdb_kernel``,
launched by ``_fused_rdb_impl`` (the one ``pl.pallas_call`` of the JAX
package), forward only. The backward comes with the training slice.

What bounds it on the H100: arithmetic. The 69 RDBs of the x4 RRDBNet
(23 RRDBs x 3) are 33.1 of its 35.9 MFLOP per LR pixel, about 2.2 TFLOP per
256x256 LR image. One level is an implicit GEMM with M = pixels,
N = cout (32 or 64), K = 9 * cin (cin 64..192): in bf16 the fifth level does
about 345 FLOP per byte it must move, above the card's ~295 FLOP/byte ridge,
the first level about 190, below it. So the design keeps the bytes near the
minimum and puts the FLOPs on the tensor cores:

* a preallocated NHWC growth buffer (B, H, W, 4 gc) takes x_1..x_4; level k
  reads channels [0, nc) of x and [0, (k-1) gc) of the buffer and writes its
  own gc-channel slice, so the dense concat is never copied;
* input pixels outside the image are staged as zeros, which is the SAME
  padding of every level, with no per-level masks (the Pallas kernel's
  ``_mask`` existed only because it kept a whole RDB in one VMEM tile);
* input channels are staged in shared memory in chunks of 32 and summed
  over the nine taps in f32. bf16 runs on tensor cores (WMMA 16x16x16):
  a 16 x 16 output tile per block, two output rows per warp so each weight
  fragment feeds two products, and the next chunk's window copied with
  ``cp.async`` while the current one is multiplied. f32 runs on CUDA cores
  (full f32, no TF32), an 8 x 16 tile per block.

Weights are HWIO, which read as (9 * cin, cout) matrices with rows ordered
(dy, dx, ci), the layout of ``_im2col_weights``; ``prepare_weights`` makes
them once per parameter version and the modules cache the result. Not done
yet, and left to later PRs: weights in shared memory, ``wgmma``/TMA,
fusing levels. The Pallas design (a whole RDB per tile) does not fit: five
on-chip activations of a 16x16 tile already take ~196 KiB of the 227 KB of
shared memory.

Tolerances, stated once here; the tests and ``chip_smoke.py`` import
``TOLERANCES``:

==================  ======  ======  ==================================================
check               atol    rtol    why
==================  ======  ======  ==================================================
kernel_f32          1e-4    0       f32 kernel vs f32 plain version on the card: the
                                    same f32 products summed in another order over
                                    K <= 1728 terms (TF32 is off on both sides).
kernel_bf16         3e-3    2^-7    bf16 kernel vs the plain version on the same bf16
                                    tensors, which rounds x_1..x_4 and the output
                                    where the kernel does: the f32 sums differ only
                                    in order, so the output's rounding can flip by
                                    one bf16 ulp (at most 2^-7 |y|), and flips in
                                    x_1..x_4 carry into it; on the H100, over the
                                    check's seven shapes, no element needed more
                                    than 1.4e-3 of atol beside that rtol.
bf16_vs_f32         3e-2    2e-2    a bf16 computation vs the f32 one on the same
                                    bf16-rounded inputs: x_1..x_4 and the output are
                                    rounded to bf16 (8 significant bits) in one and
                                    not in the other.
jax_rdb             1e-4    0       port's plain version vs JAX ``_scatter_reference``
                                    and the interpreted Pallas kernel, f32 on the CPU:
                                    two conv implementations, different sum orders.
jax_blocks          1e-5    0       nn modules (RDB5C, RRDB, upconv, conv_block) vs
                                    flax at f32 on the CPU: one or a few convs deep.
jax_network         1e-4    0       RRDBNet, forward_chop, tiled_apply vs JAX at f32
                                    on the CPU: 2 RRDBs plus stem and x4 tail.
network_f32         1e-4    0       the full nb 23 network with the kernel vs the same
                                    network on the plain version, f32 on the card; the
                                    JAX-vs-torch CPU check of the reference reached
                                    3.8e-5 at full size (PARITY.md).
psnr_db             1e-2    0       srn_test per-set PSNR (and PSNR_Y), port vs JAX:
                                    an f32 difference can flip a uint8 rounding.
ssim                1e-4    0       srn_test per-set SSIM (and SSIM_Y), same reason.
==================  ======  ======  ==================================================
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TOLERANCES = {
    "kernel_f32": (1e-4, 0.0),
    "kernel_bf16": (3e-3, 2.0**-7),
    "bf16_vs_f32": (3e-2, 2e-2),
    "jax_rdb": (1e-4, 0.0),
    "jax_blocks": (1e-5, 0.0),
    "jax_network": (1e-4, 0.0),
    "network_f32": (1e-4, 0.0),
    "psnr_db": (1e-2, 0.0),
    "ssim": (1e-4, 0.0),
}

LAUNCHES_PER_RDB = 5  # one kernel launch per level
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def prepare_weights(kernels, biases, dtype):
    """HWIO kernels in the working type and f32 biases, contiguous and
    detached: what ``fused_rdb`` takes on the card."""
    with torch.no_grad():
        ks = tuple(k.detach().to(dtype).contiguous() for k in kernels)
        bs = tuple(b.detach().to(torch.float32).contiguous() for b in biases)
    return ks, bs


def fused_rdb_reference(x, kernels, biases):
    """Plain PyTorch version: ``F.conv2d`` over the concatenated prefix.

    x (B, H, W, nc) NHWC; kernels HWIO; biases (cout,). Convs run in f32 on
    working-type-rounded inputs; returns NHWC in x's dtype."""
    dt = x.dtype
    feats = [x.permute(0, 3, 1, 2).float()]
    out = None
    for k in range(5):
        w = kernels[k].to(dt).float().permute(3, 2, 0, 1)
        v = F.conv2d(torch.cat(feats, 1), w, biases[k].float(), padding=1)
        if k < 4:
            feats.append(F.leaky_relu(v, 0.2).to(dt).float())
        else:
            out = (feats[0] + 0.2 * v).to(dt)
    return out.permute(0, 2, 3, 1)


def fused_rdb(x, kernels, biases, params=()):
    """One RDB5C forward: x (B, H, W, nc) NHWC -> (B, H, W, nc).

    ``kernels``: the five HWIO conv kernels (3, 3, nc + k gc, gc or nc);
    ``biases``: their (cout,) biases; ``params``: the parameters they were
    prepared from, if any, which must not ask for a gradient either. A CPU
    tensor goes to ``fused_rdb_reference``. A CUDA tensor launches the
    kernel, once per level, or raises on what the kernel does not take:
    there is no fallback.
    """
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *kernels, *biases, *params)
    ):
        raise NotImplementedError(
            "fused_rdb has no backward yet (ROADMAP B: the backward kernel "
            "comes with the training slice); call it under torch.no_grad()"
        )
    if x.device.type == "cpu":
        return fused_rdb_reference(x, kernels, biases)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rdb: no kernel for device {x.device}")
    return _launch(x, kernels, biases)


fused_rdb.launches = 0  # kernel launches on the card since the last reset


def _launch(x, kernels, biases):
    from dasr_tpu_torch.kernels import build

    if x.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_rdb: x must be 4-D f32 or bf16, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 32:
        raise ValueError("fused_rdb: x must be contiguous NHWC and 32-byte aligned")
    b, h, w, nc = x.shape
    gc = kernels[0].shape[-1]
    if len(kernels) != 5 or len(biases) != 5 or nc % 32 or gc % 32:
        raise ValueError(f"fused_rdb: takes 5 levels with nc, gc multiples of 32 (nc {nc}, gc {gc})")
    for k in range(5):
        cout = gc if k < 4 else nc
        kk, bk = kernels[k], biases[k]
        if (
            tuple(kk.shape) != (3, 3, nc + k * gc, cout)
            or kk.dtype != x.dtype
            or kk.device != x.device
            or not kk.is_contiguous()
            or kk.data_ptr() % 32
        ):
            raise ValueError(
                f"fused_rdb: kernel {k} must be contiguous HWIO "
                f"(3, 3, {nc + k * gc}, {cout}) {x.dtype} on {x.device}, got "
                f"{kk.dtype} {tuple(kk.shape)} on {kk.device}"
            )
        if (
            tuple(bk.shape) != (cout,)
            or bk.dtype != torch.float32
            or bk.device != x.device
            or not bk.is_contiguous()
        ):
            raise ValueError(f"fused_rdb: bias {k} must be contiguous f32 ({cout},) on {x.device}")

    lib = build.load()
    growth = torch.empty((b, h, w, 4 * gc), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    code = _DTYPE_CODE[x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for k in range(5):
            final = k == 4
            out, stride, off = (y, nc, 0) if final else (growth, 4 * gc, k * gc)
            rc = lib.dasr_rdb_level(
                code, x.data_ptr(), growth.data_ptr(), kernels[k].data_ptr(),
                biases[k].data_ptr(), out.data_ptr(), b, h, w, nc, 4 * gc,
                nc + k * gc, nc if final else gc, stride, off, int(final), stream,
            )
            build.check(lib, rc, f"fused_rdb level {k + 1}")
            fused_rdb.launches += 1
    return y
