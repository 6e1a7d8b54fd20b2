"""The port's CUDA RDB kernel on the card against its plain version.

Imports neither jax nor the JAX package, so it also runs where only the
port is installed, without the suite's conftest:

    python3 -m pytest --noconftest tests/test_torch_rdb_card.py

Every test is marked ``cuda`` and skips without a card."""

import numpy as np
import pytest
import torch

from dasr_tpu_torch.core.device import resolve_device
from dasr_tpu_torch.ops.rdb import (
    TILES,
    TOLERANCES,
    fused_rdb,
    fused_rdb_reference,
    prepare_weights,
    tile_plan,
)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _params(rng, nc=64, gc=32):
    kernels = [
        rng.normal(0, 0.05, (3, 3, nc + k * gc, gc if k < 4 else nc)).astype(np.float32)
        for k in range(5)
    ]
    biases = [rng.normal(0, 0.01, (gc if k < 4 else nc,)).astype(np.float32) for k in range(5)]
    return kernels, biases


@pytest.mark.cuda
@pytest.mark.parametrize("shape, tile", [((2, 37, 53), (8, 8)), ((4, 100, 90), (16, 16))])
def test_kernel_matches_plain_on_card(rng, shape, tile):
    """Each bf16 tile, with H and W not multiples of it and B > 1, and the
    f32 kernel, against the plain version on the same tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    assert TILES[tile_plan(*shape)] == tile
    kernels, biases = _params(rng)
    x = torch.from_numpy(rng.random(shape + (64,), dtype=np.float32)).cuda()
    ks = [torch.from_numpy(k).cuda() for k in kernels]
    bs = [torch.from_numpy(b).cuda() for b in biases]
    resolve_device("cuda")  # the port's f32 rule: TF32 off
    for dt, tol in ((torch.float32, "kernel_f32"), (torch.bfloat16, "kernel_bf16")):
        kd, bd = prepare_weights(ks, bs, dt)
        with torch.no_grad():
            before = fused_rdb.launches
            got = fused_rdb(x.to(dt), kd, bd)
            assert fused_rdb.launches - before == 5
            # the plain version on the same tensors rounds where the kernel does
            want = fused_rdb_reference(x.to(dt), kd, bd).float()
        atol, rtol = TOLERANCES[tol]
        torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [32, 64])
@pytest.mark.parametrize("tile", [0, 1])
def test_compiled_plan_matches_wgmma_plan(cout, tile):
    """The shared-memory plan compiled into the bf16 kernel is the one the
    CPU tests emulate (tests/test_torch_rdb_plan.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from dasr_tpu_torch.ops.rdb import WgmmaPlan, kernel_plan

    assert kernel_plan(cout, tile) == WgmmaPlan(cout, tile).vector()


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [32, 64])
@pytest.mark.parametrize("tile", [0, 1])
def test_compiled_plan_matches_f32_plan(cout, tile):
    """The shared-memory plan compiled into the f32 kernel is the one the
    CPU tests emulate (tests/test_torch_rdb_f32_plan.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from dasr_tpu_torch.ops.rdb import F32Plan, kernel_plan

    assert kernel_plan(cout, tile, torch.float32) == F32Plan(cout, tile).vector()


@pytest.mark.cuda
@pytest.mark.parametrize("shape, tile", [((2, 37, 53), (8, 8)), ((4, 100, 90), (16, 16))])
def test_f32_kernel_within_twice_the_plain_error_against_f64(rng, shape, tile):
    """The f32 kernel's split-TF32 products and per-chunk f32 sums against
    the RDB computed in f64 on the card: at most ``kernel_f32_f64`` (2x) the
    plain f32 version's max error on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    assert TILES[tile_plan(*shape)] == tile
    kernels, biases = _params(rng)
    x = torch.from_numpy(rng.random(shape + (64,), dtype=np.float32)).cuda()
    ks = [torch.from_numpy(k).cuda() for k in kernels]
    bs = [torch.from_numpy(b).cuda() for b in biases]
    resolve_device("cuda")  # the port's f32 rule: TF32 off
    kd, bd = prepare_weights(ks, bs, torch.float32)
    with torch.no_grad():
        got = fused_rdb(x, kd, bd)
        plain = fused_rdb_reference(x, kd, bd)
        want = fused_rdb_reference(x.double(), [k.double() for k in ks],
                                   [b.double() for b in bs])
    _, ratio = TOLERANCES["kernel_f32_f64"]
    e_kernel = (got.double() - want).abs().max().item()
    e_plain = (plain.double() - want).abs().max().item()
    assert e_kernel <= ratio * e_plain, (e_kernel, e_plain)
