"""The port's RRDBNet against dasr_tpu's, f32 on the CPU, on the same JAX
parameters and numpy inputs; reference-named .pth interop; the init law."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.nn.generators import RRDBNet as JRRDBNet
from dasr_tpu.train.checkpoints import export_params_to_state_dict, rrdbnet_key_map
from dasr_tpu_torch.nn.generators import RRDBNet
from dasr_tpu_torch.ops.rdb import TOLERANCES
from dasr_tpu_torch.train import checkpoints

ATOL, _ = TOLERANCES["jax_network"]
NB = 2


def _jax_net(nf, gc, x):
    net = JRRDBNet(nf=nf, nb=NB, gc=gc)
    variables = net.init(jax.random.key(3), jnp.asarray(x))
    return variables, np.asarray(net.apply(variables, jnp.asarray(x)))


def _port_out(net, x):
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("nf,gc", [(16, 8), (64, 32)])
def test_rrdbnet_matches_jax(rng, nf, gc):
    x = rng.random((1, 16, 16, 3), dtype=np.float32)
    variables, want = _jax_net(nf, gc, x)
    params_np = jax.tree_util.tree_map(np.asarray, variables)
    net = RRDBNet(nf=nf, nb=NB, gc=gc)
    net.load_state_dict(checkpoints.rrdbnet_state_dict_from_jax(params_np, NB), strict=True)
    got = _port_out(net, x)
    assert got.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_pth_round_trip_matches_jax(rng, tmp_path):
    """JAX params -> dasr_tpu's reference exporter -> torch.save -> the port's
    loader gives the JAX output."""
    x = rng.random((1, 12, 16, 3), dtype=np.float32)
    variables, want = _jax_net(16, 8, x)
    path = tmp_path / "net_G.pth"
    torch.save(export_params_to_state_dict(variables, rrdbnet_key_map(NB)), path)
    net = checkpoints.load_rrdbnet_pth(RRDBNet(nf=16, nb=NB, gc=8), str(path))
    np.testing.assert_allclose(_port_out(net, x), want, atol=ATOL, rtol=0)


def test_state_dict_names_are_the_reference_names():
    names = set(RRDBNet(nf=16, nb=3, gc=8).state_dict())
    want = {f"{t}.{leaf}" for t, _, _ in checkpoints.rrdbnet_key_map(3) for leaf in ("weight", "bias")}
    assert names == want
    assert checkpoints.rrdbnet_key_map(3) == rrdbnet_key_map(3)


def test_init_law_is_the_jax_one():
    """kaiming fan-in x 0.1 for RDB convs, truncated lecun-normal elsewhere,
    zero biases, reproducible from the generator's seed."""
    net = RRDBNet(nf=64, nb=1, gc=32).init_weights(torch.Generator().manual_seed(0))
    again = RRDBNet(nf=64, nb=1, gc=32).init_weights(torch.Generator().manual_seed(0))
    for (name, p), q in zip(net.state_dict().items(), again.state_dict().values()):
        assert torch.equal(p, q), name
    w5 = net.model[1].sub[0].RDB1.conv5[0].weight
    fan_in = 9 * (64 + 4 * 32)
    assert abs(w5.std().item() / (0.1 * np.sqrt(2.0 / fan_in)) - 1) < 0.02
    stem = net.model[0].weight
    assert abs(stem.std().item() / np.sqrt(1.0 / 27) - 1) < 0.15
    assert stem.abs().max().item() <= 2 * np.sqrt(1.0 / 27) / 0.87962566103423978 + 1e-6
    assert all(torch.count_nonzero(b) == 0 for n, b in net.named_parameters() if n.endswith("bias"))


def test_bf16_compute_keeps_f32_params(rng):
    net = RRDBNet(nf=16, nb=1, gc=8, dtype=torch.bfloat16)
    net.init_weights(torch.Generator().manual_seed(1))
    ref = RRDBNet(nf=16, nb=1, gc=8)
    ref.load_state_dict(net.state_dict())
    x = rng.random((1, 10, 12, 3), dtype=np.float32)
    with torch.no_grad():
        assert net(torch.from_numpy(x).permute(0, 3, 1, 2)).dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in net.parameters())
    atol, rtol = TOLERANCES["bf16_vs_f32"]
    np.testing.assert_allclose(_port_out(net, x), _port_out(ref, x), atol=atol, rtol=rtol)


def test_fused_tail_and_scan_blocks_are_ignored(rng, caplog):
    x = rng.random((1, 8, 8, 3), dtype=np.float32)
    plain = RRDBNet(nf=16, nb=1, gc=8).init_weights(torch.Generator().manual_seed(2))
    with caplog.at_level("INFO", logger="base"):
        flagged = RRDBNet(nf=16, nb=1, gc=8, fused_tail=True, scan_blocks=True)
    assert "fused_tail ignored" in caplog.text and "scan_blocks ignored" in caplog.text
    flagged.load_state_dict(plain.state_dict())
    np.testing.assert_array_equal(_port_out(flagged, x), _port_out(plain, x))
