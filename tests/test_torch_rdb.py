"""The port's fused RDB (dasr_tpu_torch.ops.rdb) against the JAX package's
RDB kernel: its XLA formulation and the Pallas kernel in interpret mode.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel is
checked on the card by the ``cuda``-marked test and by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.ops.pallas_rdb import _fused_rdb_impl, _scatter_reference
from dasr_tpu_torch.core.device import resolve_device
from dasr_tpu_torch.ops.rdb import (
    TOLERANCES,
    fused_rdb,
    fused_rdb_reference,
    prepare_weights,
)

ATOL, _ = TOLERANCES["jax_rdb"]


def _params(rng, nc=64, gc=32):
    kernels = [
        rng.normal(0, 0.05, (3, 3, nc + k * gc, gc if k < 4 else nc)).astype(np.float32)
        for k in range(5)
    ]
    biases = [rng.normal(0, 0.01, (gc if k < 4 else nc,)).astype(np.float32) for k in range(5)]
    return kernels, biases


def _port(x, kernels, biases):
    with torch.no_grad():
        out = fused_rdb(
            torch.from_numpy(x), [torch.from_numpy(k) for k in kernels],
            [torch.from_numpy(b) for b in biases],
        )
    return out.numpy()


@pytest.mark.parametrize("shape", [(1, 24, 40, 64), (2, 9, 13, 64)])
def test_plain_matches_jax_scatter_reference(rng, shape):
    kernels, biases = _params(rng, nc=shape[-1])
    x = rng.random(shape, dtype=np.float32)
    want = np.asarray(_scatter_reference(
        jnp.asarray(x), tuple(map(jnp.asarray, kernels)), tuple(map(jnp.asarray, biases))
    ))
    got = _port(x, kernels, biases)
    assert got.shape == shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_plain_matches_interpreted_pallas_kernel(rng):
    """Interior and the 5-px border band, where SAME padding matters."""
    kernels, biases = _params(rng)
    x = rng.random((1, 32, 32, 64), dtype=np.float32)
    want = np.asarray(_fused_rdb_impl(
        jnp.asarray(x), tuple(map(jnp.asarray, kernels)), tuple(map(jnp.asarray, biases)),
        tile=32, interpret=True,
    ))
    got = _port(x, kernels, biases)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for band in (np.s_[:, :5], np.s_[:, -5:], np.s_[:, :, :5], np.s_[:, :, -5:]):
        np.testing.assert_allclose(got[band], want[band], atol=ATOL, rtol=0)


def test_bf16_rounds_levels_and_output(rng):
    """bf16 input: x1..x4 and the output are rounded to bf16, the sums are f32,
    so the result stays within the bf16 tolerance of the f32 computation."""
    kernels, biases = _params(rng, nc=32, gc=32)
    x = torch.from_numpy(rng.random((1, 12, 10, 32), dtype=np.float32)).bfloat16()
    ks = [torch.from_numpy(k) for k in kernels]
    bs = [torch.from_numpy(b) for b in biases]
    kd, bd = prepare_weights(ks, bs, torch.bfloat16)
    got = fused_rdb(x, kd, bd)
    want = fused_rdb_reference(x.float(), [k.float() for k in kd], bd)
    assert got.dtype == torch.bfloat16
    atol, rtol = TOLERANCES["bf16_vs_f32"]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


def test_cpu_path_launches_no_kernel(rng):
    kernels, biases = _params(rng, nc=32, gc=32)
    before = fused_rdb.launches
    _port(rng.random((1, 8, 8, 32), dtype=np.float32), kernels, biases)
    assert fused_rdb.launches == before


def test_grad_mode_raises(rng):
    kernels, biases = _params(rng, nc=32, gc=32)
    x = torch.zeros((1, 8, 8, 32), requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        fused_rdb(x, [torch.from_numpy(k) for k in kernels], [torch.from_numpy(b) for b in biases])


def test_grad_mode_raises_for_module_params(rng):
    """RDB5C hands the kernel detached weights, so fused_rdb checks the
    parameters they came from."""
    from dasr_tpu_torch.nn.blocks import RDB5C

    block = RDB5C(nc=32, gc=32)
    x = torch.from_numpy(rng.random((1, 32, 8, 8), dtype=np.float32))
    with pytest.raises(NotImplementedError, match="backward"):
        block(x)
    with torch.no_grad():
        assert block(x).shape == x.shape


def test_unsupported_device_raises(rng):
    kernels, biases = _params(rng, nc=32, gc=32)
    x = torch.zeros((1, 8, 8, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        with torch.no_grad():
            fused_rdb(x, [torch.from_numpy(k) for k in kernels],
                      [torch.from_numpy(b) for b in biases])


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    kernels, biases = _params(rng)
    x = torch.from_numpy(rng.random((2, 37, 53, 64), dtype=np.float32)).cuda()
    ks = [torch.from_numpy(k).cuda() for k in kernels]
    bs = [torch.from_numpy(b).cuda() for b in biases]
    torch.backends.cudnn.allow_tf32 = False
    for dt, tol in ((torch.float32, "kernel_f32"), (torch.bfloat16, "kernel_bf16")):
        kd, bd = prepare_weights(ks, bs, dt)
        with torch.no_grad():
            got = fused_rdb(x.to(dt), kd, bd)
            # the plain version on the same tensors rounds where the kernel does
            want = fused_rdb_reference(x.to(dt), kd, bd).float()
        atol, rtol = TOLERANCES[tol]
        torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
