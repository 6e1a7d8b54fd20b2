"""The backward of the port's fused RDB against the JAX package's custom VJP
(``jax.vjp`` of ``_scatter_reference``), f32 on the CPU, and the routing of
``RDB5C``'s gradients to its OIHW parameters.

On the CPU the Function's forward is the kernel's plain version and its
backward the VJP of ``rdb_chain``. The bf16 backward kernels' plain
version, the reverse dense chain ``rdb_backward_reference``, is held here
against both; the card's checks of the kernels under autograd are in
tests/test_torch_rdb_card.py and chip_smoke.py (phase ``grad``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.ops.pallas_rdb import _scatter_reference
from dasr_tpu_torch.nn.blocks import RDB5C
from dasr_tpu_torch.ops.rdb import (
    TOLERANCES,
    fused_rdb,
    fused_rdb_reference,
    rdb_backward_reference,
    rdb_chain,
    reference_levels,
)

ATOL, _ = TOLERANCES["jax_rdb"]
# the three shapes of test_torch_rdb.py
SHAPES = [(1, 24, 40, 64), (2, 9, 13, 64), (1, 32, 32, 64)]


def _params(rng, nc=64, gc=32):
    kernels = [
        rng.normal(0, 0.05, (3, 3, nc + k * gc, gc if k < 4 else nc)).astype(np.float32)
        for k in range(5)
    ]
    biases = [rng.normal(0, 0.01, (gc if k < 4 else nc,)).astype(np.float32) for k in range(5)]
    return kernels, biases


@pytest.mark.parametrize("shape", SHAPES)
def test_grads_match_jax_vjp_of_scatter_reference(rng, shape):
    kernels, biases = _params(rng, nc=shape[-1])
    x = rng.random(shape, dtype=np.float32)
    g = rng.normal(0, 1, shape).astype(np.float32)
    want_out, vjp = jax.vjp(
        _scatter_reference, jnp.asarray(x), tuple(map(jnp.asarray, kernels)),
        tuple(map(jnp.asarray, biases)),
    )
    gx, gks, gbs = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_()
    tks = [torch.from_numpy(k).requires_grad_() for k in kernels]
    tbs = [torch.from_numpy(b).requires_grad_() for b in biases]
    out = fused_rdb(tx, tks, tbs)
    got = torch.autograd.grad(out, [tx, *tks, *tbs], torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=ATOL, rtol=0)
    for name, a, b in zip(["x"] + [f"k{k}" for k in range(5)] + [f"b{k}" for k in range(5)],
                          got, [gx, *gks, *gbs]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES + [(2, 32, 32, 64)])
def test_reverse_chain_matches_chain_vjp_and_jax_vjp(rng, shape):
    """The bf16 backward's plain version, the reverse dense chain over
    x_1..x_4 from the plain forward, against the VJP of ``rdb_chain`` and
    JAX's ``jax.vjp`` of ``_scatter_reference``: dx and the ten parameter
    gradients, f32."""
    kernels, biases = _params(rng, nc=shape[-1])
    x = rng.random(shape, dtype=np.float32)
    g = rng.normal(0, 1, shape).astype(np.float32)
    _, vjp = jax.vjp(_scatter_reference, jnp.asarray(x), tuple(map(jnp.asarray, kernels)),
                     tuple(map(jnp.asarray, biases)))
    jx, jks, jbs = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_()
    tks = [torch.from_numpy(k).requires_grad_() for k in kernels]
    tbs = [torch.from_numpy(b).requires_grad_() for b in biases]
    chain = torch.autograd.grad(rdb_chain(tx, tks, tbs), [tx, *tks, *tbs], torch.from_numpy(g))

    with torch.no_grad():
        _, growth = reference_levels(tx, tks, tbs)
        dx, dks, dbs = rdb_backward_reference(tx, growth, tks, torch.from_numpy(g))
    names = ["x"] + [f"k{k}" for k in range(5)] + [f"b{k}" for k in range(5)]
    for name, got, want, jwant in zip(names, [dx, *dks, *dbs], chain, [jx, *jks, *jbs]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=ATOL, rtol=0,
                                   err_msg=name)


def test_chain_matches_plain_version_forward(rng):
    """``rdb_chain`` (what the backward differentiates) computes the
    forward the kernel computes, at f32 and, rounding where it rounds, at
    bf16."""
    kernels, biases = _params(rng, nc=32, gc=32)
    x = torch.from_numpy(rng.random((2, 11, 7, 32), dtype=np.float32))
    ks = [torch.from_numpy(k) for k in kernels]
    bs = [torch.from_numpy(b) for b in biases]
    torch.testing.assert_close(rdb_chain(x, ks, bs), fused_rdb_reference(x, ks, bs),
                               atol=ATOL, rtol=0)
    xd, kd = x.bfloat16(), [k.bfloat16() for k in ks]
    got = rdb_chain(xd, kd, bs)
    assert got.dtype == torch.bfloat16
    atol, rtol = TOLERANCES["kernel_bf16"]
    torch.testing.assert_close(got.float(), fused_rdb_reference(xd, kd, bs).float(),
                               atol=atol, rtol=rtol)


def test_backward_takes_a_permuted_gradient(rng):
    """RDB5C returns a permuted view, so the gradient reaching the Function
    is one too."""
    kernels, biases = _params(rng, nc=32, gc=32)
    x = torch.from_numpy(rng.random((1, 6, 5, 32), dtype=np.float32)).requires_grad_()
    ks = [torch.from_numpy(k) for k in kernels]
    bs = [torch.from_numpy(b) for b in biases]
    g = torch.from_numpy(rng.normal(0, 1, (1, 32, 6, 5)).astype(np.float32))
    (gx,) = torch.autograd.grad(fused_rdb(x, ks, bs).permute(0, 3, 1, 2), [x], g)
    (want,) = torch.autograd.grad(fused_rdb_reference(x, ks, bs).permute(0, 3, 1, 2), [x], g)
    torch.testing.assert_close(gx, want, atol=ATOL, rtol=0)


def test_rdb5c_gradients_reach_its_parameters(rng):
    """Under grad mode RDB5C hands the Function HWIO views of its OIHW
    parameters: their gradients equal those of the literal dense chain of
    nn layers, and the no_grad weight cache sees the optimizer's step."""
    torch.manual_seed(0)
    fused = RDB5C(nc=32, gc=16)
    literal = RDB5C(nc=32, gc=16)
    literal.load_state_dict(fused.state_dict())
    literal.fused = False
    x = torch.from_numpy(rng.random((2, 32, 9, 7), dtype=np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (2, 32, 9, 7)).astype(np.float32))
    (fused(x) * g).sum().backward()
    (literal(x) * g).sum().backward()
    for (name, a), b in zip(fused.named_parameters(), literal.parameters()):
        assert a.grad is not None, name
        torch.testing.assert_close(a.grad, b.grad, atol=ATOL, rtol=0, msg=name)

    with torch.no_grad():
        before = fused.kernel_weights(torch.float32)[0][0].clone()
    torch.optim.SGD(fused.parameters(), lr=0.1).step()
    with torch.no_grad():
        after = fused.kernel_weights(torch.float32)[0][0]
    torch.testing.assert_close(after, fused.conv1[0].weight.permute(2, 3, 1, 0))
    assert not torch.equal(before, after)
