"""The port's frequency-separation ops and bilinear resize against the JAX
package's, f32 on the CPU, on the same numpy inputs (NHWC for JAX, NCHW
for the port)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.ops import dwt as jdwt
from dasr_tpu.ops import filters as jfilters
from dasr_tpu.ops.resize import bilinear_resize as jbilinear
from dasr_tpu_torch.ops import dwt, filters
from dasr_tpu_torch.ops.resize import bilinear_resize

ATOL = 1e-6  # a few f32 adds/multiplies, or short sums, per element


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("hw", [(8, 10), (9, 7)])
@pytest.mark.parametrize("norm,cs", [(True, "cat"), (False, "sum")])
def test_haar_bands_matches_jax(rng, hw, norm, cs):
    x = rng.random((2, *hw, 3), dtype=np.float32)
    ll, high = dwt.haar_bands(_nchw(x), norm=norm, cs=cs)
    jll, jhigh = jdwt.haar_bands(jnp.asarray(x), norm=norm, cs=cs)
    _close(ll, jll)
    _close(high, jhigh)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_dwt_init_matches_jax(rng, hw):
    x = rng.random((1, *hw, 3), dtype=np.float32)
    for got, want in zip(dwt.dwt_init(_nchw(x)), jdwt.dwt_init(jnp.asarray(x))):
        _close(got, want)


@pytest.mark.parametrize("gaussian", [True, False])
@pytest.mark.parametrize("kernel_size,include_pad", [(5, True), (9, False), (3, False)])
def test_filters_match_jax(rng, gaussian, kernel_size, include_pad):
    x = rng.random((2, 13, 11, 3), dtype=np.float32)
    kw = dict(kernel_size=kernel_size, include_pad=include_pad, gaussian=gaussian)
    _close(filters.filter_low(_nchw(x), **kw), jfilters.filter_low(jnp.asarray(x), **kw))
    _close(filters.filter_low(_nchw(x), padding=False, **kw),
           jfilters.filter_low(jnp.asarray(x), padding=False, **kw))
    _close(filters.filter_high(_nchw(x), normalize=False, **kw),
           jfilters.filter_high(jnp.asarray(x), normalize=False, **kw))
    _close(filters.filter_high(_nchw(x), recursions=2, **kw),
           jfilters.filter_high(jnp.asarray(x), recursions=2, **kw))


def test_wavelet_helpers_match_jax(rng):
    x = rng.random((1, 6, 8, 3), dtype=np.float32)
    _close(filters.wavelet_high_cat(_nchw(x)), jfilters.wavelet_high_cat(jnp.asarray(x)))
    _close(filters.wavelet_ll(_nchw(x)), jfilters.wavelet_ll(jnp.asarray(x)))
    np.testing.assert_allclose(filters.gaussian_kernel(9), jfilters.gaussian_kernel(9))


@pytest.mark.parametrize("src,dst", [((8, 8), (32, 32)), ((5, 7), (20, 13)), ((1, 4), (3, 8))])
def test_bilinear_resize_matches_jax_and_interpolate(rng, src, dst):
    x = rng.random((2, *src, 1), dtype=np.float32)
    got = bilinear_resize(_nchw(x), *dst)
    _close(got, jbilinear(jnp.asarray(x), *dst))
    want = torch.nn.functional.interpolate(_nchw(x), size=dst, mode="bilinear",
                                           align_corners=False)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
