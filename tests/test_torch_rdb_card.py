"""The port's CUDA RDB kernel on the card against its plain version, and
the weight plan's one launch (``rdb_prep_weights``) against the per-call
casts and dgrad weight images it replaces.

Imports neither jax nor the JAX package, so it also runs where only the
port is installed, without the suite's conftest:

    python3 -m pytest --noconftest tests/test_torch_rdb_card.py

Every test is marked ``cuda`` and skips without a card."""

import numpy as np
import pytest
import torch

from dasr_tpu_torch.core.device import resolve_device
from dasr_tpu_torch.nn.blocks import fused_rdbs
from dasr_tpu_torch.nn.generators import RRDBNet, RRDBNetResidualConv
from dasr_tpu_torch.ops.rdb import (
    BACKWARD_LAUNCHES,
    IMAGE_LAUNCHES,
    LAUNCHES_PER_RDB,
    TILES,
    TOLERANCES,
    RDBWeightPlan,
    dgrad_weights,
    fused_rdb,
    fused_rdb_reference,
    launch_images,
    prepare_weights,
    tile_plan,
)
from dasr_tpu_torch.utils import trace


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
@pytest.mark.parametrize("shape, tile, nc", [((12, 32, 32), (8, 8), 64), ((4, 100, 90), (16, 16), 64),
                                             ((4, 48, 48), (8, 8), 64), ((8, 48, 48), (16, 16), 64),
                                             ((3, 20, 28), (8, 8), 32)])
def test_backward_kernels_match_autograd_through_plain(rng, shape, tile, nc):
    """bf16, the three train cells' shapes, a ragged one, and a ragged one
    at nc 32: the Function's backward (the kernels, on f32 kernel leaves as
    RDB5C hands them) against autograd through the plain version on the
    same tensors (cuDNN off), dL/dx and the ten parameter gradients each
    within ``grad_bf16`` in the Frobenius norm; a second run gives the same
    bits; one forward and backward, a bare call with no weight plan, count
    the forward's five launches, the backward's BACKWARD_LAUNCHES and its
    weight images' one, one backward through the kernels and one call that
    cast its own kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    assert TILES[tile_plan(*shape)] == tile
    kernels, biases = _params(rng, nc)
    resolve_device("cuda")
    base = ([torch.from_numpy(rng.random(shape + (nc,), dtype=np.float32)).cuda().bfloat16()]
            + [torch.from_numpy(k).cuda() for k in kernels]
            + [torch.from_numpy(b).cuda() for b in biases])
    g = torch.from_numpy(rng.normal(0, 1, shape + (nc,)).astype(np.float32)).cuda().bfloat16()

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in base]
        return torch.autograd.grad(fn(leaves[0], leaves[1:6], leaves[6:]), leaves, g)

    names = ("launches", "backward_launches", "bwd_kernel", "bwd_chain", "cast", "prepared")
    before = [getattr(fused_rdb, n) for n in names]
    got = run(fused_rdb)
    torch.cuda.synchronize()
    counts = [getattr(fused_rdb, n) - c for n, c in zip(names, before)]
    assert counts == [LAUNCHES_PER_RDB, BACKWARD_LAUNCHES + IMAGE_LAUNCHES, 1, 0, 1, 0]
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 32, 32), (8, 128, 128)])
def test_wgrad_two_launches_give_the_same_bits(rng, shape):
    """The weight gradient at shapes that the plan cuts into more than one
    pixel split (added over the cluster's shared memory in rank order): two
    backward launches on the same inputs give the same bits, every kernel
    and bias gradient, and the kernel's units are those of
    ``wgrad_units``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from dasr_tpu_torch.ops import rdb

    assert rdb.wgrad_plan(*shape)[1] > 1
    assert rdb.kernel_wgrad_units(64, 32) == rdb.wgrad_units(64, 32)
    assert rdb.kernel_wgrad_units(32, 32) == rdb.wgrad_units(32, 32)
    kernels, biases = _params(rng)
    x = torch.from_numpy(rng.random(shape + (64,), dtype=np.float32)).cuda().bfloat16()
    ks = [torch.from_numpy(k).cuda().bfloat16() for k in kernels]
    bs = [torch.from_numpy(b).cuda() for b in biases]
    dy = torch.from_numpy(rng.normal(0, 1, shape + (64,)).astype(np.float32)).cuda().bfloat16()
    with torch.no_grad():
        _, growth = rdb._launch(x, ks, bs)
    images = rdb.launch_images(ks)
    first = rdb._launch_backward(x, growth, ks, images, dy)
    first = [t.clone() for t in (*first[1], *first[2])]
    second = rdb._launch_backward(x, growth, ks, images, dy)
    torch.cuda.synchronize()
    for a, b in zip(first, (*second[1], *second[2])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _bits(t):
    return t.view(torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_prep_kernel_equals_per_call_casts_and_images(layout):
    """One launch of rdb_prep_weights over an Adaptive generator's 6 RDBs
    (nf 64), its parameters channels_last or OIHW-contiguous: every RDB's
    bf16 HWIO kernels equal the per-call casts, and its dgrad weight images
    rdb_dgrad_weights on those casts and the plain version, bit for bit;
    one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    resolve_device("cuda")
    torch.manual_seed(0)
    net = RRDBNetResidualConv(nf=64, nb=1, gc=32, nb_ada=1)
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(0, 0.05)
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    net = net.to("cuda", memory_format=fmt)
    plan = RDBWeightPlan([tuple(c.weight for c in m.convs()) for m in fused_rdbs(net)])
    before = trace.counters().get("rdb_prep.launches", 0)
    plan.prepare()
    torch.cuda.synchronize()
    assert trace.counters()["rdb_prep.launches"] - before == 1
    for ws, (ks, img) in zip(plan.weights, plan.slots):
        cast = [torch.empty((3, 3) + tuple(w.shape[1::-1]), dtype=torch.bfloat16,
                            device="cuda").copy_(w.permute(2, 3, 1, 0)) for w in ws]
        for a, b in zip(ks, cast):
            assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(_bits(img), _bits(launch_images(cast)))
        plain = torch.cat([m.flatten() for m in dgrad_weights([c.cpu() for c in cast])])
        assert torch.equal(_bits(img.cpu()), _bits(plain))


@pytest.mark.cuda
def test_rrdbnet_step_gradients_equal_with_and_without_the_plan():
    """One bf16 forward and backward of RRDBNet (nf 64, nb 2: 6 RDBs) on
    the card: through the generator's forward (its weight plan, one prep
    launch, 6 RDB calls that took it and 7 backward launches each) and
    through its module tree alone (every RDB casts its own kernels and its
    backward makes its images, 8 launches each) give the same output and
    parameter gradients bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    resolve_device("cuda")
    torch.manual_seed(0)
    net = RRDBNet(nf=64, nb=2, gc=32, dtype=torch.bfloat16)
    net.init_weights(torch.Generator().manual_seed(0))
    net = net.to("cuda", memory_format=torch.channels_last)
    x = torch.rand(3, 3, 24, 20, device="cuda")
    g = torch.randn(3, 3, 96, 80, device="cuda").bfloat16()
    params = list(net.parameters())
    names = ("fused_rdb.prepared", "fused_rdb.cast", "rdb_prep.launches",
             "fused_rdb.backward_launches")

    def run(fn):
        before = trace.counters()
        out = fn()
        grads = torch.autograd.grad(out, params, g)
        torch.cuda.synchronize()
        after = trace.counters()
        return out, grads, [after.get(n, 0) - before.get(n, 0) for n in names]

    planned = run(lambda: net(x))
    bare = run(lambda: net.model(x.bfloat16().contiguous(memory_format=torch.channels_last)))
    assert planned[2] == [6, 0, 1, 6 * BACKWARD_LAUNCHES]
    assert bare[2] == [0, 6, 0, 6 * (BACKWARD_LAUNCHES + IMAGE_LAUNCHES)]
    assert torch.equal(planned[0], bare[0])
    for a, b in zip(planned[1], bare[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_second_forward_before_the_backward_raises():
    """The weight plan's buffers hold one preparation: a second bf16 forward
    of RRDBNet (nf 64, nb 1) before the first one's backward makes that
    backward raise instead of running on the second preparation, and the
    second forward's backward runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    resolve_device("cuda")
    net = RRDBNet(nf=64, nb=1, gc=32, dtype=torch.bfloat16)
    net.init_weights(torch.Generator().manual_seed(0))
    net = net.to("cuda", memory_format=torch.channels_last)
    x = torch.rand(3, 3, 24, 20, device="cuda")
    params = list(net.parameters())
    first, second = net(x), net(x)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        torch.autograd.grad(first.float().sum(), params)
    grads = torch.autograd.grad(second.float().sum(), params)
    assert all(torch.isfinite(g).all() for g in grads)
