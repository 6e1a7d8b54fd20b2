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
    BACKWARD_LAUNCHES,
    LAUNCHES_PER_RDB,
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape, tile", [((12, 32, 32), (8, 8)), ((4, 100, 90), (16, 16))])
def test_backward_kernels_match_autograd_through_plain(rng, shape, tile):
    """bf16, the train step's shape and a ragged one: the Function's
    backward (the kernels, on f32 kernel leaves as RDB5C hands them)
    against autograd through the plain version on the same tensors (cuDNN
    off), dL/dx and the ten parameter gradients each within ``grad_bf16``
    in the Frobenius norm; a second run gives the same bits; one forward
    and backward count the forward's five launches, the backward's eight
    and one backward through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    assert TILES[tile_plan(*shape)] == tile
    kernels, biases = _params(rng)
    resolve_device("cuda")
    base = ([torch.from_numpy(rng.random(shape + (64,), dtype=np.float32)).cuda().bfloat16()]
            + [torch.from_numpy(k).cuda() for k in kernels]
            + [torch.from_numpy(b).cuda() for b in biases])
    g = torch.from_numpy(rng.normal(0, 1, shape + (64,)).astype(np.float32)).cuda().bfloat16()

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in base]
        return torch.autograd.grad(fn(leaves[0], leaves[1:6], leaves[6:]), leaves, g)

    names = ("launches", "backward_launches", "bwd_kernel", "bwd_chain")
    before = [getattr(fused_rdb, n) for n in names]
    got = run(fused_rdb)
    torch.cuda.synchronize()
    counts = [getattr(fused_rdb, n) - c for n, c in zip(names, before)]
    assert counts == [LAUNCHES_PER_RDB, BACKWARD_LAUNCHES, 1, 0]
    again = run(fused_rdb)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    with torch.backends.cudnn.flags(enabled=False):
        want = run(fused_rdb_reference)
    _, rtol = TOLERANCES["grad_bf16"]
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == w.dtype and a.shape == w.shape, i
        rel = ((a.float() - w.float()).norm() / w.float().norm()).item()
        assert rel <= rtol, (i, rel)
