"""srn_train's ``val_batch`` in the port (CPU, f32): validation with runs
of up to K same-shape images in one forward (``test_batch_async``) against
one image a forward (1e-6 on the averages, equal SR PNGs), and against the
JAX CLI's batched validation on the same weights and images (0.01 dB and
1e-4 SSIM, the serve limits); the JAX CLI's gate (no chop, no
``pad_bucket``) and precedence (the host f64 metrics even with
``val_device_metrics``, with its log line; the bucketed device metrics
where ``val_metrics_pad_bucket`` is set too)."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.cli import srn_train as jax_srn_train
from dasr_tpu.core.config import dict_to_nonedict as jax_nonedict
from dasr_tpu.data.datasets import create_dataset as jax_create_dataset
from dasr_tpu.models.registry import create_model as jax_create_model
from dasr_tpu.nn.generators import RRDBNet as JRRDBNet
from dasr_tpu.train.checkpoints import export_params_to_state_dict, rrdbnet_key_map
from dasr_tpu_torch.cli import srn_train
from dasr_tpu_torch.core.config import dict_to_nonedict
from dasr_tpu_torch.data.datasets import create_dataset
from dasr_tpu_torch.data.io import read_img_u8, save_img
from dasr_tpu_torch.models.registry import create_model
from dasr_tpu_torch.ops.rdb import TOLERANCES

NET = {"which_model_G": "RRDB_net", "nf": 16, "nb": 1, "gc": 8, "norm_type": None}
# three 10x12 images, then one 9x14: with val_batch 2, forwards of 2, 1, 1
LR_SIZES = ((10, 12), (10, 12), (10, 12), (9, 14))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Writer:
    def __init__(self):
        self.records = []

    def write(self, step, values, **_):
        self.records.append((step, dict(values)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("val_batch")
    rng = np.random.default_rng(6)
    for d in ("hr", "lr"):
        os.makedirs(root / d)
    for i, (h, w) in enumerate(LR_SIZES):
        lr = rng.random((h, w, 3)).astype(np.float32)
        hr = np.clip(np.kron(lr, np.ones((4, 4, 1))) + rng.normal(0, 0.05, (4 * h, 4 * w, 3)),
                     0, 1)
        save_img(lr, str(root / "lr" / f"v{i}.png"))
        save_img(hr, str(root / "hr" / f"v{i}.png"))
    variables = JRRDBNet(nf=16, nb=1, gc=8).init(jax.random.key(5), jnp.zeros((1, 16, 16, 3)))
    torch.save(export_params_to_state_dict(variables, rrdbnet_key_map(1)), root / "G.pth")
    return root


def _opt(root, name, make=dict_to_nonedict, **extra):
    return make({"model": "DASR", "scale": 4, "bf16": False, "network_G": NET, **extra,
                 "path": {"pretrain_model_G": str(root / "G.pth"),
                          "val_images": str(root / name / "val_images")}})


def _val_set(root, create=create_dataset, make=dict_to_nonedict):
    return create(make({"name": "val", "mode": "LRHR", "phase": "val", "scale": 4,
                        "data_type": "img", "dataroot_HR": str(root / "hr"),
                        "dataroot_LR": str(root / "lr")}))


def _port_validate(root, name, **extra):
    """The port's validation with ``extra`` options: (averages, the batch
    sizes of test_batch_async's calls, the log)."""
    opt = _opt(root, name, **extra)
    model = create_model(opt, torch.device("cpu")).init().load()
    calls = []
    batched = model.test_batch_async
    model.test_batch_async = lambda imgs: calls.append(len(imgs)) or batched(imgs)
    logger = logging.getLogger("base")
    avg = srn_train._validate(model, _val_set(root), opt, 3, logger, Writer(), None)
    return avg, calls


def _pngs(root, name):
    d = root / name / "val_images" / "3"
    return {f: read_img_u8(str(d / f)) for f in sorted(os.listdir(d))}


def test_val_batch_2_equals_one_image_a_forward(corpus):
    single, calls1 = _port_validate(corpus, "vb1")
    batched, calls2 = _port_validate(corpus, "vb2", val_batch=2)
    assert calls1 == [] and calls2 == [2, 1, 1]
    assert list(batched) == list(single) == ["psnr", "ssim", "psnr_y", "ssim_y"]
    for k, v in single.items():
        assert abs(batched[k] - v) <= 1e-6, (k, batched[k], v)
    a, b = _pngs(corpus, "vb1"), _pngs(corpus, "vb2")
    assert list(a) == list(b) == [f"v{i}_3.png" for i in range(4)]
    for f in a:
        assert np.array_equal(a[f], b[f]), f


def test_val_batch_matches_the_jax_cli(corpus):
    opt = _opt(corpus, "jax", make=jax_nonedict, val_batch=2)
    model = jax_create_model(opt)
    model.init()
    model.load()
    writer = Writer()
    jax_srn_train._validate(model, _val_set(corpus, jax_create_dataset, jax_nonedict), opt, 3,
                            logging.getLogger("base"), writer, None)
    (step, want), = writer.records
    got, _ = _port_validate(corpus, "port", val_batch=2)
    assert step == 3
    psnr_tol, _ = TOLERANCES["psnr_db"]
    ssim_tol, _ = TOLERANCES["ssim"]
    for k, v in got.items():
        tol = psnr_tol if k.startswith("psnr") else ssim_tol
        assert abs(v - want[f"val/{k}"]) <= tol, (k, v, want[f"val/{k}"])


def test_val_batch_takes_precedence_over_device_metrics(corpus, caplog, monkeypatch):
    """As in the JAX CLI: with val_batch > 1 the metrics run on the host f64
    path even with val_device_metrics, and the log says so; with
    val_metrics_pad_bucket too they run on the bucketed device path."""
    from dasr_tpu_torch.eval import evaluate

    host, _ = _port_validate(corpus, "host", val_batch=2)
    calls = []
    monkeypatch.setattr(evaluate, "sr_metrics",
                        lambda *a, f=evaluate.sr_metrics: calls.append(1) or f(*a))
    with caplog.at_level("INFO", logger="base"):
        got, _ = _port_validate(corpus, "dev", val_batch=2, val_device_metrics=True)
    assert "val_batch > 1 takes precedence over val_device_metrics" in caplog.text
    assert len(calls) == 4 and got == host
    calls.clear()
    bucketed, _ = _port_validate(corpus, "bucket", val_batch=2, val_device_metrics=True,
                                 val_metrics_pad_bucket=32)
    assert calls == []
    for k, v in host.items():
        assert abs(bucketed[k] - v) < (1e-3 if k.startswith("psnr") else 1e-4), k


@pytest.mark.parametrize("gate", [{"chop": True}, {"pad_bucket": 8}])
def test_chop_and_pad_bucket_validate_one_image_a_forward(corpus, gate):
    avg, calls = _port_validate(corpus, "gated", val_batch=2, **gate)
    assert calls == [] and np.isfinite(avg["psnr"])
