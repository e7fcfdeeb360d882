"""CasMVSNet on the card (`gpu`): one `Predictor` request of the benchmark
cell's size (1184x1600, N5, the DTU rig) in bf16 on the exact "fused"
sweep, with the cell's seeded weights, against the plain f32 reference
(mvsbench/reference/cas_mvsnet.py) re-centred on the program's stages,
held to the cell's own limits; and the launches a request makes: one
`fused_cost_volume` and one `conv3d_head` a stage, no other kernel. The
reference runs whole: at this size its largest stage (32 x 592 x 800 at 16
channels in f32) takes a few GB of the card's 80.

Imports neither jax nor the JAX package, so it runs on the card without
the repo's test configuration:
`python -m pytest tests/test_torch_cas_mvsnet_gpu.py -q -m gpu -p no:cacheprovider --noconftest`.
"""
import pytest
import torch

from mvsbench import check, files, traffic, weights
from mvsbench.reference import cas_mvsnet as ref_cas
from mvsbench.reference.common import f32_flags
from mvsbench.serve import PROBE_CAMERA, request_tensors

CELL = "cas_mvsnet_48_32_8.serve_1184x1600_n5"
SEED = 2**31 + 24
CAMERA = 17


@pytest.mark.gpu
def test_a_dtu_request_within_the_cell_limits_and_its_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run on the card "
                    "only")
    from wildmvs_torch.infer import Predictor
    from wildmvs_torch.ops import sweep_kernels as sk

    dev = torch.device("cuda")
    cell = files.workload(CELL)
    cfg = files.config(cell["config"])
    h, w, n = cell["height"], cell["width"], cell["views"]
    rig = traffic.dtu_rig(cell["rig"], h, w)
    imgs = traffic.images(SEED, rig.cameras, h, w, dev)
    probe = traffic.request(rig, imgs, PROBE_CAMERA, n)
    state, _ = weights.cell_weights(ref_cas, cfg, SEED, dev,
                                    request_tensors(probe, dev))
    pred = Predictor(architecture=cfg["architecture"], device=dev,
                     **cfg.get("predictor", {}))
    pred.model.load_state_dict(state)
    scores = []
    for name in cfg["score_modules"]:
        pred.model.get_submodule(name).register_forward_hook(
            lambda _m, _a, out: scores.append(out[0, ..., 0].float()))
    req = traffic.request(rig, imgs, CAMERA, n)
    args = [req[k] for k in ("imgs", "K", "R", "t", "depth_min",
                             "depth_max")]
    pred(*args)                                   # builds the kernels
    scores.clear()
    sk.reset_launch_counts()
    out = pred(*args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in sk.launch_counts().items() if v}
    assert launches == {"fused_cost_volume": 3, "conv3d_head": 3}
    assert [tuple(s.shape) for s in scores] == [
        (48, h // 4, w // 4), (32, h // 2, w // 2), (8, h, w)]
    assert out["depth"].shape == out["confidence"].shape == (h, w)

    x = request_tensors(req, dev)
    with f32_flags():
        ref = ref_cas.build(cfg).to(dev)
        ref.load_state_dict(state)
        ref.eval()
        stages = ref_cas.stage_depths(cfg, x, scores)
        prog = {"depths": stages[:-1] + [out["depth"]],
                "confidence": out["confidence"], "scores": scores}
        mine = ref_cas.serve(ref, x, centres=prog["depths"][:-1])
        own = ref_cas.regress_scores(cfg, x, scores, prog["depths"][:-1])
    numbers = check.serve_numbers([(prog, mine, own)], ref_cas.intervals(
        cfg, *rig.depth_range))
    assert check.verdict(numbers, cell["limits"]), check.report(
        numbers, cell["limits"])
