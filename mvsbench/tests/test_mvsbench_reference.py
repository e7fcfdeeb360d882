"""The plain references against the port's plain path (the exact f32
gather on the CPU) at a tiny size, with the same seeded weights. This
test imports both; the references themselves import nothing of the
port."""
import numpy as np
import pytest
import torch

from mvsbench import check, files, traffic, weights
from mvsbench.reference.common import Adam
from mvsbench.serve import request_tensors
from mvsbench.train import sample_tensors

CPU = torch.device("cpu")
H, W = 128, 160


def setup(config, seed=5, n=3):
    cfg = files.config(config)
    ref_mod = files.reference(cfg["architecture"])
    rig_spec = dict(files.workload("mvsnet_d192.serve_512x640_n3")["rig"],
                    focal={f"{H}x{W}": 1156.8 * W / 640})
    r = traffic.dtu_rig(rig_spec, H, W)
    imgs = traffic.images(seed, r.cameras, H, W, CPU)
    probe = request_tensors(traffic.request(r, imgs, 24, n), CPU)
    state, _ = weights.cell_weights(ref_mod, cfg, seed, CPU, probe)
    model = ref_mod.build(cfg)
    model.load_state_dict(state)
    x = request_tensors(traffic.request(r, imgs, 10, n), CPU)
    return cfg, ref_mod, model, state, x, r, imgs


def port_model(name, state, **kw):
    from wildmvs_torch.models import build_model
    m = build_model(name, device="cpu", **kw)
    m.load_state_dict(state)
    return m


def test_seeded_weights_load_strictly_into_the_port():
    for config, arch in (("mvsnet_d192", "mvsnet"),
                         ("vis_mvsnet_64_32_16", "vis_mvsnet")):
        _, _, _, state, _, _, _ = setup(config)
        port_model(arch, state)                  # strict: the same keys


def hooked(port, stage_modules, score_modules):
    """Forward hooks as the serving cells' (serve.Capture)."""
    seen = {}
    mods = dict(port.named_modules())
    for k in stage_modules:
        mods[k].register_forward_hook(
            lambda _m, _a, o, k=k: seen.__setitem__(k, o[0][0].numpy()))
    for k in score_modules:
        mods[k].register_forward_hook(
            lambda _m, _a, o, k=k: seen.__setitem__(k, o[0, ..., 0]))
    return seen


@torch.no_grad()
def test_mvsnet_eval_matches_the_port():
    cfg, ref_mod, model, state, x, _, _ = setup("mvsnet_d192")
    port = port_model("mvsnet", state, num_depth=cfg["num_depth"]).eval()
    seen = hooked(port, [], cfg["score_modules"])
    out = port(x["imgs"], x["K"], x["R"], x["t"], x["depth_min"],
               x["depth_max"])
    prog = {"depths": [out["depth"][0].numpy()],
            "confidence": out["photometric_confidence"][0].numpy(),
            "scores": [seen[k] for k in cfg["score_modules"]]}
    mine = ref_mod.serve(model.eval(), x)
    itv = ref_mod.intervals(cfg, 425.0, 935.0)[0]
    e = np.abs(out["depth"][0].numpy() - mine["depths"][0]) / itv
    assert e.max() < 1e-2, e.max()
    own = ref_mod.regress_scores(cfg, x, prog["scores"])
    nums = check.serve_numbers([(prog, mine, own)],
                               ref_mod.intervals(cfg, 425.0, 935.0))
    assert nums["conf_mean_abs"] < 1e-4, nums
    assert nums["score_err"] < 1e-4, nums
    assert nums["depth_regress_itv"] < 1e-3, nums
    assert nums["conf_regress_abs"] < 1e-4, nums


@torch.no_grad()
def test_vis_mvsnet_eval_matches_the_port_stage_by_stage():
    cfg, ref_mod, model, state, x, _, _ = setup("vis_mvsnet_64_32_16")
    port = port_model("vis_mvsnet", state, depth_nums=cfg["depth_nums"],
                      interval_scales=cfg["interval_scales"]).eval()
    seen = hooked(port, cfg["stage_modules"], cfg["score_modules"])
    out = port(x["imgs"], x["K"], x["R"], x["t"], x["depth_min"],
               x["depth_max"])
    prog = {"depths": [seen["stage1"], seen["stage2"],
                       out["depth"][0].numpy()],
            "confidence": out["photometric_confidence"][0].numpy(),
            "scores": [seen[k] for k in cfg["score_modules"]]}
    centres = prog["depths"][:2]
    mine = ref_mod.serve(model.eval(), x, centres=centres)
    own = ref_mod.regress_scores(cfg, x, prog["scores"], centres)
    ref_own = ref_mod.serve(model, x)        # its own cascade agrees too
    nums = check.serve_numbers(
        [(prog, mine, own),
         (prog, ref_own, ref_mod.regress_scores(
             cfg, x, ref_own["scores"], ref_own["depths"][:2]))],
        ref_mod.intervals(cfg, 425.0, 935.0))
    assert nums["depth_mean_itv"] < 1e-3, nums
    assert nums["depth_p99_itv"] < 1e-2, nums
    assert nums["conf_mean_abs"] < 1e-4, nums
    for k in (1, 2, 3):
        assert nums[f"score_err_stage{k}"] < 1e-4, nums
    assert nums["depth_regress_itv"] < 1e-3, nums
    assert nums["conf_regress_abs"] < 1e-4, nums


@torch.no_grad()
@pytest.mark.parametrize("config", ["mvsnet_d192", "vis_mvsnet_64_32_16"])
def test_bf16_regression_is_far_from_f32(config):
    """The control's soft-argmin in bf16 reads far above the f32
    reference's own regression of the same scores (which reads 0)."""
    cfg, ref_mod, model, _, x, _, _ = setup(config)
    got = ref_mod.serve(model.eval(), x)
    centres = got["depths"][:-1]
    f32 = ref_mod.regress_scores(cfg, x, got["scores"], centres)
    b16 = ref_mod.regress_scores(cfg, x, got["scores"], centres,
                                 dtype=torch.bfloat16)
    nums = check.serve_numbers([(dict(b16, scores=got["scores"]), got, f32)],
                               ref_mod.intervals(cfg, 425.0, 935.0))
    same = check.serve_numbers([(got, got, f32)],
                               ref_mod.intervals(cfg, 425.0, 935.0))
    assert same["depth_regress_itv"] < 1e-5, same
    assert nums["depth_regress_itv"] > 0.02, nums
    assert nums["conf_regress_abs"] > 1e-3, nums


def test_mvsnet_train_step_matches_the_port():
    """Three f32 steps of the port's trainer against the reference's loss,
    autograd and Adam: the first loss and gradient closely; the later
    losses as far as three Adam steps keep them (one ulp moves a leaf's
    Adam update by its sign)."""
    from wildmvs_torch.train.config import TrainConfig
    from wildmvs_torch.train.trainer import (batch_to_device,
                                             create_train_state, train_step)

    cfg, ref_mod, model, state, _, r, imgs = setup("mvsnet_d192")
    spec = dict(files.workload("mvsnet_d192.train_512x640_n3"),
                height=H, width=W, pool=3)
    pool = traffic.training_pool(5, r, imgs, spec)
    config = TrainConfig(architecture="mvsnet", num_depth=cfg["num_depth"],
                         lr=cfg["lr"], num_im_train=3)
    st = create_train_state(config, CPU,
                            model=port_model("mvsnet", state,
                                             num_depth=cfg["num_depth"]))
    model.train()
    opt = Adam(model.parameters(), lr=cfg["lr"])
    named = dict(model.named_parameters())
    for i, sample in enumerate(pool):
        st, out = train_step(st, batch_to_device(sample, CPU), config)
        for p in named.values():
            p.grad = None
        loss, _ = ref_mod.loss(model, sample_tensors(sample, CPU))
        loss.backward()
        ref_loss = float(loss.detach())
        if i == 0:
            assert float(out["train_loss"]) == pytest.approx(ref_loss,
                                                             rel=1e-5)
            med = float(torch.stack([p.grad.norm() for p in
                                     named.values()]).median())
            for n, p in st.model.named_parameters():
                g, gr = p.grad, named[n].grad
                if float(gr.norm()) < 1e-3 * med:
                    continue        # nought to rounding (a bias under softmax)
                assert float((g - gr).norm() / gr.norm()) < 0.02, n
        else:
            assert float(out["train_loss"]) == pytest.approx(ref_loss,
                                                             rel=2e-2)
        opt.step()


# ---------------------------------------------------------------------------
# CVP-MVSNet (configuration inline: tests/inline_cvp.py)
# ---------------------------------------------------------------------------

def cvp_setup(seed=5, hw=(64, 96), n=3):
    from inline_cvp import CVP_CONFIG
    cfg = dict(CVP_CONFIG)
    ref_mod = files.reference(cfg["architecture"])
    rig_spec = dict(files.workload("mvsnet_d192.serve_512x640_n3")["rig"],
                    focal={f"{hw[0]}x{hw[1]}": 1156.8 * hw[1] / 640})
    r = traffic.dtu_rig(rig_spec, *hw)
    imgs = traffic.images(seed, r.cameras, *hw, CPU)
    probe = request_tensors(traffic.request(r, imgs, 24, n), CPU)
    state, _ = weights.cell_weights(ref_mod, cfg, seed, CPU, probe)
    model = ref_mod.build(cfg)
    model.load_state_dict(state)
    x = request_tensors(traffic.request(r, imgs, 10, n), CPU)
    port = port_model("cvp_mvsnet", state,
                      nscale=cfg["predictor"]["cvp_nscale"],
                      sweep_method="gather")
    return cfg, ref_mod, model, port, x


@torch.no_grad()
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_cvp_mvsnet_matches_the_port_level_by_level(mode):
    """The f32 port (exact gather) against the reference re-centred on the
    port's own coarser depths, each level: eval (96 coarse hypotheses,
    epipolar steps) and train mode (48, fixed halved steps; BatchNorm on
    the batch's statistics). Both are f32 and sum in other orders (the
    variance, the 96-way softmax), so a level's depth agrees to a hundredth
    of its interval, its score volume to 1e-4 and the confidence to 1e-4;
    the reference's regression of the port's own volumes gives the port's
    depths to f32 rounding (1e-3 mm at 425-935 mm)."""
    cfg, ref_mod, model, port, x = cvp_setup()
    getattr(port, mode)()
    getattr(model, mode)()
    seen = []
    port.cost_reg_refine.register_forward_hook(
        lambda _m, _a, o: seen.append(o[0]))
    out = port(x["imgs"], x["K"], x["R"], x["t"], x["depth_min"],
               x["depth_max"])
    depths = [d[0].numpy() for d in reversed(out["depth_est_list"])]
    nscale = cfg["predictor"]["cvp_nscale"]
    assert len(depths) == len(seen) == nscale
    mine = ref_mod.serve(model, x, centres=depths[:-1])
    assert len(mine["intervals"]) == nscale
    for k in range(nscale):
        e = np.abs(depths[k] - mine["depths"][k]) / mine["intervals"][k]
        assert e.max() < 1e-2, (k, e.max())
        assert check.score_err(seen[k], mine["scores"][k]) < 1e-4, k
    conf = out["photometric_confidence"][0].numpy()
    assert np.abs(conf - mine["confidence"]).max() < 1e-4
    if mode == "eval":
        own = ref_mod.stage_depths(cfg, x, seen)
        for k in range(nscale):
            assert np.abs(own[k] - depths[k]).max() < 1e-3, k
        steps = mine["intervals"]
        assert steps[0] == pytest.approx((935.0 - 425.0) / 96)
    else:
        steps = mine["intervals"]
        assert steps == pytest.approx(ref_mod.intervals(cfg, 425.0, 935.0))


@torch.no_grad()
def test_cvp_forward_runs_on_the_meta_device():
    """trace_extras counts a request's flops there: no Python branch on a
    tensor's value."""
    from mvsbench import work
    cfg, ref_mod, _, _, x = cvp_setup()
    with torch.device("meta"):
        model = ref_mod.build(cfg).eval()
    meta = {k: v.to("meta") for k, v in x.items()}
    flops = work.count_flops(lambda: model(
        meta["imgs"], meta["K"], meta["R"], meta["t"], meta["depth_min"],
        meta["depth_max"]))
    assert flops > 0


@torch.no_grad()
def test_cvp_fused_jobs_at_the_dtu_eval_size():
    """One fused launch a level at 1184x1600, nscale 5: the coarsest
    level's operations bind (its live samples counted), every finer
    level's bytes even with every sample live."""
    from mvsbench import work
    from mvsbench.reference import cvp_mvsnet
    cell = files.workload("vis_mvsnet_64_32_16.serve_1184x1600_n5")
    r = traffic.dtu_rig(cell["rig"], 1184, 1600)
    imgs = [np.zeros((1184, 1600, 3), np.float32)] * r.cameras
    x = request_tensors(traffic.request(r, imgs, 24, 5), CPU)
    jobs = cvp_mvsnet.serve_jobs({"predictor": {"cvp_nscale": 5}}, x)
    launches = jobs["fused_cost_volume"]
    assert len(launches) == 5
    coarse, *fine = launches
    assert (coarse.operations / work.F32_FLOPS
            > coarse.bytes / work.HBM_BYTES_PER_S)
    full = 4 * 96 * 74 * 100
    assert 0 < coarse.operations - 74 * 100 * 96 * 16 * 16 < full * 16 * 8
    for job in fine:
        assert job.bytes / work.HBM_BYTES_PER_S >= (job.operations
                                                    / work.F32_FLOPS)
    assert launches.bound_s() == pytest.approx(sum(j.bound_s()
                                                   for j in launches))
