"""The benchmark's frozen reference against the port's plain path on the
CPU, at a tiny width and in float32: networks, image ops, the batch
sampling, the train steps, and the cost arithmetic. The test imports both;
the reference imports nothing of the port."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.reference import costs, nets, ops, sampling, steps

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _close(a, b, tol=2e-5):
    a, b = a.detach().float(), b.detach().float()
    assert (a - b).abs().max().item() <= tol * max(1.0, b.abs().max().item())


def test_rrdbnet_matches_the_port():
    from dasr_tpu_torch.nn.generators import RRDBNet

    net = RRDBNet(nf=32, nb=2, gc=16)
    p = harness.draw_params(nets.rrdbnet_spec(32, 2, 16), 3, "G", CPU)
    harness.load_params(net, p, "G")
    x = torch.rand(2, 3, 12, 10)
    with torch.no_grad():
        _close(nets.rrdbnet(p, x, nb=2), net(x))


def test_discriminators_lpips_and_deresnet_match_the_port():
    from dasr_tpu_torch.losses.lpips import LPIPS
    from dasr_tpu_torch.nn.discriminators import FSDiscriminator, NLayerDiscriminator
    from dasr_tpu_torch.nn.generators import DeResnet

    d = NLayerDiscriminator(in_ch=9, ndf=8, n_layers=2, norm_layer="Instance", stride=2,
                            use_bias_middle=False)
    pd = harness.draw_params(nets.nlayer_spec(9, 8, 2), 4, "D", CPU)
    harness.load_params(d, pd, "D")
    x = torch.rand(2, 9, 32, 32)
    lp = LPIPS("alex")
    pl = harness.draw_params(nets.lpips_spec(), 5, "L", CPU)
    harness.load_params(lp, pl, "LPIPS")
    a, b = torch.rand(2, 3, 40, 40), torch.rand(2, 3, 40, 40)
    g = DeResnet(1, 4)
    pg = harness.draw_params(nets.deresnet_spec(1), 6, "G", CPU)
    harness.load_params(g, pg, "G")
    f = FSDiscriminator(d_arch="FSD", filter_type="avg_pool", kernel_size=5,
                        norm_layer="Instance")
    pf = harness.draw_params(nets.fsd_spec(), 7, "F", CPU)
    harness.load_params(f, pf, "FSD")
    hr = torch.rand(2, 3, 32, 32)
    with torch.no_grad():
        _close(nets.nlayer(pd, x), d(x))
        _close(nets.lpips(pl, a, b), lp(a, b, normalize=True).flatten())
        _close(nets.deresnet(pg, hr, nb=1), g(hr))
        _close(nets.fsd(pf, hr[:, :, :8, :8]), f(hr[:, :, :8, :8]))


def test_image_ops_match_the_port():
    from dasr_tpu_torch.ops.dwt import haar_bands
    from dasr_tpu_torch.ops.resize import imresize
    from dasr_tpu_torch.ops.tiled import tiled_apply

    x = torch.rand(2, 3, 20, 24)
    for mine, theirs in zip(nets.haar_bands(x), haar_bands(x)):
        _close(mine, theirs)
    _close(ops.bicubic(x, 0.25), imresize(x, 0.25))
    img = torch.rand(1, 3, 150, 290)

    def model(t):
        up = torch.nn.functional.interpolate(t, scale_factor=4, mode="nearest")
        return up * 0.5 + t.mean(dim=(1, 2, 3), keepdim=True)

    assert ops.tile_plan(150, 290) == (2, 3, 160)
    _close(ops.tiled(img, model, chunk=4), tiled_apply(img, model, scale=4, tile=128, halo=16))


def test_sampling_matches_the_port_gathers():
    from dasr_tpu_torch.data import device_bank as db

    g = torch.Generator().manual_seed(0)
    banks = {"fake": (torch.randint(0, 256, (5, 20, 24, 3), generator=g, dtype=torch.uint8),
                      torch.tensor([[20, 24]] * 5, dtype=torch.int32)),
             "hr": (torch.randint(0, 256, (5, 80, 96, 3), generator=g, dtype=torch.uint8),
                    torch.tensor([[80, 96]] * 5, dtype=torch.int32)),
             "real": (torch.randint(0, 256, (7, 20, 24, 3), generator=g, dtype=torch.uint8),
                      torch.tensor([[20, 24]] * 7, dtype=torch.int32)),
             "ddm": (torch.rand(5, 20, 24, 1, generator=g),
                     torch.tensor([[20, 24]] * 5, dtype=torch.int32))}
    srn = db.SrnBanks(*(db.ImageBank(*banks[n]) for n in ("fake", "hr", "real", "ddm")))
    row = torch.tensor([3, 0, 4])
    mine = sampling.dasr_batch(banks, row, sampling.window_generator(9, 2, CPU), 32, 4, True, True)
    gen = db.window_generator(9, 2, CPU)
    theirs = db.gather_dasr(srn, row, db.draw_dasr(gen, 3, 7, 5), 32, 4, True, True)
    for k in mine:
        torch.testing.assert_close(mine[k], theirs[k].permute(0, 3, 1, 2), rtol=0, atol=0)
    clean, noisy = banks["hr"], banks["real"]
    mine = sampling.dsn_batch(clean, noisy, row, sampling.window_generator(9, 3, CPU), 32, 4,
                              False, False)
    d = db.draw_dsn(db.window_generator(9, 3, CPU), 3, 5)
    theirs = db.gather_dsn(db.ImageBank(*clean), db.ImageBank(*noisy), row, d, 32, 4)
    for k in mine:
        torch.testing.assert_close(mine[k], theirs[k].permute(0, 3, 1, 2).float() / 255,
                                   rtol=0, atol=0)
    assert [r.tolist() for r in sampling.epoch_rows(4, 1, 10, 3)] == \
        [r.tolist() for r in db.epoch_rows(4, 1, 10, 3)]


def test_a_calls_steps_draw_from_its_generator_in_turn():
    """A call of K rows draws each row's crops from the call's one generator
    in turn, as the program's window does; the next call reseeds."""
    from dasr_tpu_torch.data import device_bank as db

    g = torch.Generator().manual_seed(1)
    clean = (torch.randint(0, 256, (5, 80, 96, 3), generator=g, dtype=torch.uint8),
             torch.tensor([[80, 96]] * 5, dtype=torch.int32))
    noisy = (torch.randint(0, 256, (7, 20, 24, 3), generator=g, dtype=torch.uint8),
             torch.tensor([[20, 24]] * 7, dtype=torch.int32))
    rows = [torch.tensor(r) for r in ([3, 0], [4, 1], [6, 2], [5, 3])]
    gens = sampling.call_generators(11, [(0, 1), (1, 3)], CPU)
    mine = [sampling.dsn_batch(clean, noisy, r, next(gens), 32, 4, True, True) for r in rows]
    theirs = []
    for start, part in ((0, rows[:1]), (1, rows[1:])):
        gen = db.window_generator(11, start, CPU)
        for r in part:
            d = db.draw_dsn(gen, 2, 5)
            theirs.append(db.gather_dsn(db.ImageBank(*clean), db.ImageBank(*noisy), r, d, 32, 4,
                                        True, True))
    for m, t in zip(mine, theirs):
        for k in m:
            torch.testing.assert_close(m[k], t[k].permute(0, 3, 1, 2).float() / 255,
                                       rtol=0, atol=0)
    assert not torch.equal(mine[1]["input"], mine[2]["input"])


def _held(ref, losses, st, w, beta1_g, beta1_d):
    """The f32 program after three steps against the reference, by the
    benchmark's own comparison: far inside any limit."""
    from port_bench import compare, trainloop

    prog = {"losses": [{k: float(v) for k, v in m.items()} for m in losses],
            "grad": {"G": trainloop.first_grad_norms(st.g, beta1_g),
                     "D": trainloop.first_grad_norms(st.d_target, beta1_d)},
            "change": {"G": trainloop.change_norms(st.g.net, w["G"]),
                       "D": trainloop.change_norms(st.d_target.net, w["D"])}}
    numbers = compare.train_numbers(prog, ref)
    assert max(max(g.values()) for g in compare.loss_gaps(prog, ref)) < 1e-4
    assert numbers["change_gap_median"] < 1e-3, numbers


def _tiny_srn_opt():
    opt = json.loads((Path(__file__).resolve().parents[1] / "configs/dasr_srn.json")
                     .read_text())["opt"]
    opt["network_G"].update(nf=32, nb=1, gc=16)
    opt["network_D"].update(nf=8)
    return opt


def test_dasr_steps_match_the_port_trainer():
    from dasr_tpu_torch.losses.lpips import LPIPS
    from dasr_tpu_torch.models.registry import srn_config
    from dasr_tpu_torch.train.srn_trainer import SRNTrainer

    opt = _tiny_srn_opt()
    opt["bf16"] = False
    tr = SRNTrainer(srn_config(opt), CPU, lpips=LPIPS("alex").requires_grad_(False))
    st = tr.init_state(0)
    ng, nd = opt["network_G"], opt["network_D"]
    w = {"G": harness.draw_params(nets.rrdbnet_spec(32, 1, 16), 1, "G", CPU),
         "D": harness.draw_params(nets.nlayer_spec(9, 8, 2), 1, "D", CPU),
         "LPIPS": harness.draw_params(nets.lpips_spec(), 1, "L", CPU)}
    harness.load_params(st.g.net, w["G"], "G")
    harness.load_params(st.d_target.net, w["D"], "D")
    harness.load_params(tr.lpips, w["LPIPS"], "LPIPS")
    g = torch.Generator().manual_seed(2)
    batches = [{"LR_fake": torch.rand(2, 3, 8, 8, generator=g),
                "LR_real": torch.rand(2, 3, 8, 8, generator=g),
                "HR": torch.rand(2, 3, 32, 32, generator=g),
                "HR_unpair": torch.rand(2, 3, 32, 32, generator=g),
                "fake_w": torch.rand(2, 1, 8, 8, generator=g)} for _ in range(3)]
    ref = steps.dasr_steps(w, lambda i: batches[i], 3, opt)
    losses = [tr.train_step(b) for b in batches]
    for mine, theirs in zip(ref["losses"], losses):
        for k, v in mine.items():
            assert v == pytest.approx(float(theirs[k]), rel=1e-4, abs=1e-6)
    _held(ref, losses, st, w, opt["train"]["beta1_G"], opt["train"]["beta1_D"])
    assert ng["nb"] == 1 and nd["n_layers"] == 2


def test_dsn_steps_match_the_port_trainer():
    from dasr_tpu_torch.losses.lpips import LPIPS
    from dasr_tpu_torch.train.dsn_trainer import DSNConfig, DSNTrainer

    args = json.loads((Path(__file__).resolve().parents[1] / "configs/dasr_dsn.json")
                      .read_text())["args"]
    args.update(num_res_blocks=1)
    cfg = DSNConfig(generator="DeResnet", discriminator="FSD", filter="avg_pool",
                    num_res_blocks=1, w_tex=args["w_tex"], w_col=args["w_col"],
                    w_per=args["w_per"], learning_rate=args["learning_rate"],
                    adam_beta_1=args["adam_beta_1"])
    tr = DSNTrainer(cfg, CPU, lpips=LPIPS("alex").requires_grad_(False))
    st = tr.init_state(0)
    w = {"G": harness.draw_params(nets.deresnet_spec(1), 1, "G", CPU),
         "D": harness.draw_params(nets.fsd_spec(), 1, "D", CPU),
         "LPIPS": harness.draw_params(nets.lpips_spec(), 1, "L", CPU)}
    harness.load_params(st.g.net, w["G"], "G")
    harness.load_params(st.d_target.net, w["D"], "D")
    harness.load_params(tr.lpips, w["LPIPS"], "LPIPS")
    g = torch.Generator().manual_seed(3)
    batches = [{"input": torch.rand(2, 3, 128, 128, generator=g),
                "disc": torch.rand(2, 3, 32, 32, generator=g)} for _ in range(3)]
    ref = steps.dsn_steps(w, lambda i: batches[i], 3, args)
    losses = [tr.train_step(b) for b in batches]
    for mine, theirs in zip(ref["losses"], losses):
        for k, v in mine.items():
            assert v == pytest.approx(float(theirs[k]), rel=1e-4, abs=1e-6)
    _held(ref, losses, st, w, args["adam_beta_1"], args["adam_beta_1"])


def test_costs_match_the_port_and_the_published_count():
    from dasr_tpu_torch.ops.rdb import level_costs

    assert costs.rdb_level_costs(8, 128, 128) == level_costs(8, 128, 128)
    assert abs(costs.rrdbnet_flop_per_px() / 1e6 - 35.86) < 0.01
    assert costs.rrdbnet_flop_per_px() == 35_853_696
    # the trunk: 69 RDBs at 479,232 FLOP a pixel
    assert sum(c.flop for c in costs.rrdbnet_convs(1, 1)[1:-5]) == 69 * 479_232
    assert costs.rdb_bound_s(8, 128, 128) == pytest.approx(
        sum(max(f / 989e12, b / 3.35e12) for f, b in level_costs(8, 128, 128)))


def test_reference_imports_nothing_of_the_program():
    from port_bench import run

    assert run.reference_imports_program(run.ROOT) == []
    assert np.isfinite(costs.PEAK_FLOPS_BF16)
