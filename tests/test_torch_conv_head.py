"""The regularizers' score head (ops/conv_head.py, nn.blocks.ScoreConv3d):
the plain version against F.conv3d, the heads of the three served nets
bit-identical to nn.Conv3d on the CPU with their state_dict keys and the
benchmark's `logit_gain` names unchanged, the wrapper's refusals, its
place among the port's kernels and its bound; on the card (`gpu`), the kernel (csrc/conv3d_head.cu) against its
plain version and the launches a request and a training step make.

Imports neither jax nor the JAX package, so it runs on the card without
the repo's test configuration:
`python -m pytest tests/test_torch_conv_head.py -q -m gpu -p no:cacheprovider --noconftest`.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from wildmvs_torch.models.api import build_model
from wildmvs_torch.models.cvp_mvsnet import CVPCostRegNet
from wildmvs_torch.models.mvsnet import CostRegNet
from wildmvs_torch.models.vis_mvsnet import RegFuse, RegPair
from wildmvs_torch.nn.blocks import ScoreConv3d, cast_convs
from wildmvs_torch.ops import conv_head as ch
from wildmvs_torch.ops import sweep_kernels as sk

CONFIGS = Path(__file__).resolve().parent.parent / "mvsbench" / "configs"


def volume(shape, dtype=torch.float32, seed=0, device="cpu"):
    """[B, C, D, H, W] noise in channels_last_3d memory, as the nets hold
    their volumes."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(device=device, dtype=dtype)
    return x.contiguous(memory_format=torch.channels_last_3d)


def head_params(c, bias, dtype=torch.float32, seed=1, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn((1, c, 3, 3, 3), generator=g) / (27 * c) ** 0.5)
    b = torch.randn((1,), generator=g) if bias else None
    return (w.to(device=device, dtype=dtype),
            None if b is None else b.to(device=device, dtype=dtype))


# --- the plain version ------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 8, 6, 9, 11), (2, 16, 5, 7, 10),
                                   (1, 8, 1, 5, 7), (1, 16, 8, 33, 70),
                                   (1, 8, 3, 1, 1)])
@pytest.mark.parametrize("bias", [True, False])
def test_plain_matches_conv3d_in_f32(shape, bias):
    """27 shifted slices summed in f32 are F.conv3d's function: the same f32
    products in another order, so within f32 rounding of the sums. Ragged
    shapes: D of 1, planes that no 32 x 64 tile divides, a 1x1 plane."""
    x = volume(shape)
    w, b = head_params(shape[1], bias)
    want = F.conv3d(x, w, b, padding=1)
    got = ch.conv3d_head(x, w, b)      # the CPU route: the plain version
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ch.conv3d_head_plain(x, w, b), got,
                               rtol=0, atol=0)


def test_plain_rounds_once_in_bf16():
    """bf16 in, bf16 out: the f32 sum (and bias) rounded once, so it equals
    the f32 function of the widened inputs rounded to bf16."""
    x = volume((1, 8, 4, 6, 9), torch.bfloat16)
    w, b = head_params(8, True, torch.bfloat16)
    got = ch.conv3d_head_plain(x, w, b)
    want = F.conv3d(x.float(), w.float(), b.float(), padding=1)
    assert got.dtype == torch.bfloat16
    assert bool(within_one_ulp(got, want).all())


# --- the heads of the three nets --------------------------------------------

def regularizer(case: int, dtype):
    """(name, regularizer module computing in dtype, its head, its input
    [B, D, H, W, C])."""
    return [("mvsnet", CostRegNet(32, dtype), "prob", (1, 8, 16, 16, 32)),
            ("vis_pair", RegPair(dtype), "final_conv", (1, 4, 6, 10, 8)),
            ("vis_fuse", RegFuse(dtype), "final_conv", (1, 8, 16, 16, 8)),
            ("cvp", CVPCostRegNet(dtype), "prob0", (1, 4, 8, 12, 16))][case]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(4))
def test_heads_bit_identical_to_conv3d_on_cpu(case, dtype):
    """Each net's head is a ScoreConv3d that computes on the CPU exactly what
    the nn.Conv3d it replaced computes: the whole regularizer's output,
    bit for bit, in f32 and in bf16."""
    torch.manual_seed(case)
    name, net, head, shape = regularizer(case, dtype)
    net = cast_convs(net, dtype).eval()
    assert type(getattr(net, head)) is ScoreConv3d, name
    x = torch.randn(shape).to(dtype)
    with torch.no_grad():
        got = net(x)
        old = getattr(net, head)
        plain = nn.Conv3d(old.in_channels, 1, 3, 1, 1,
                          bias=old.bias is not None).to(dtype)
        plain.load_state_dict(old.state_dict())
        setattr(net, head, plain)
        want = net(x)
    assert torch.equal(got, want), name


@pytest.mark.parametrize("arch,heads", [
    ("mvsnet", ["cost_regularization.prob"]),
    ("vis_mvsnet", [f"stage{k}.{m}.final_conv" for k in (1, 2, 3)
                    for m in ("reg_pair", "reg_fuse")]),
    ("cvp_mvsnet", ["cost_reg_refine.prob0"])])
def test_state_dict_keys_and_logit_gain_names(arch, heads):
    """The heads keep their module names, `.weight` and `.bias`: the
    state_dict keys are those of the nn.Conv3d heads, and every name in the
    benchmark's `logit_gain` is a head's."""
    model = build_model(arch, device="cpu")
    keys = list(model.state_dict())
    found = [n for n, m in model.named_modules() if isinstance(m, ScoreConv3d)]
    assert found == heads
    for n in heads:
        m = model.get_submodule(n)
        assert [k for k in keys if k.startswith(n + ".")] == (
            [f"{n}.weight", f"{n}.bias"] if m.bias is not None
            else [f"{n}.weight"])
        assert tuple(m.weight.shape) == (1, m.in_channels, 3, 3, 3)
    # the same model with nn.Conv3d heads has the same keys and shapes
    for n in heads:
        parent, _, attr = n.rpartition(".")
        old = model.get_submodule(n)
        setattr(model.get_submodule(parent), attr,
                nn.Conv3d(old.in_channels, 1, 3, 1, 1,
                          bias=old.bias is not None))
    assert list(model.state_dict()) == keys
    gains = {}
    for cfg in CONFIGS.glob("*.json"):
        c = json.loads(cfg.read_text())
        if c.get("architecture", arch) == arch or cfg.stem.startswith(arch):
            gains.update(c.get("logit_gain", {}))
    scored = [n for n in gains if n.endswith(("prob", "prob0", "final_conv"))]
    assert scored and set(scored) <= set(heads)


# --- the wrapper ------------------------------------------------------------

def _bad_cases():
    x = volume((1, 8, 4, 5, 6))
    w, b = head_params(8, True)
    return {
        "4 channels": ((volume((1, 4, 4, 5, 6)), w[:, :4], b), "channels"),
        "32 channels": ((volume((1, 32, 4, 5, 6)),
                         w.repeat(1, 4, 1, 1, 1), b), "channels"),
        "float16": ((x.half(), w.half(), b.half()), "bfloat16 or float32"),
        "weight dtype": ((x, w.to(torch.bfloat16), b), "weight and bias"),
        "bias dtype": ((x, w, b.double()), "weight and bias"),
        "weight shape": ((x, w[..., :2], b), "weight must be"),
        "two outputs": ((x, w.repeat(2, 1, 1, 1, 1), b), "weight must be"),
        "bias shape": ((x, w, b.repeat(2)), "bias must be"),
        "4-d input": ((x[0], w, b), r"\[B, C, D, H, W\]"),
        "NCDHW memory": ((x.contiguous(), w, b), "channels_last_3d"),
        "empty": ((volume((1, 8, 0, 5, 6)), w, b), "empty"),
        "grad": ((x.requires_grad_(), w, b), "no backward"),
    }


@pytest.mark.parametrize("name", list(_bad_cases()))
def test_wrapper_refuses(name):
    args, match = _bad_cases()[name]
    with pytest.raises(ValueError, match=match):
        ch.conv3d_head(*args)


def test_wrapper_refuses_other_devices():
    x = volume((1, 8, 2, 3, 4), device="meta")
    w, b = head_params(8, False, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ch.conv3d_head(x, w, b)


def test_head_takes_nn_conv3d_on_the_cpu_and_with_grad():
    """ScoreConv3d leaves the CPU, and any call that autograd records, to
    nn.Conv3d: the kernel never launches there, and gradients flow."""
    head = ScoreConv3d(8, bias=True)
    x = volume((1, 8, 3, 4, 5)).requires_grad_()
    n0 = ch.conv3d_head.launches
    head(x).sum().backward()
    assert x.grad is not None and head.weight.grad is not None
    with torch.no_grad():
        torch.testing.assert_close(head(x), F.conv3d(x, head.weight,
                                                     head.bias, padding=1),
                                   rtol=0, atol=0)
    assert ch.conv3d_head.launches == n0


# --- the launch machinery and the bound --------------------------------------

#: the main path's head shapes [B, C, D, H, W]: MVSNet at 1184x1600 and
#: 512x640, Vis-MVSNet's three stages, CVP-MVSNet's coarsest and finest
MAIN_SHAPES = [(1, 8, 192, 296, 400), (1, 8, 192, 128, 160),
               (1, 8, 64, 148, 200), (1, 8, 32, 296, 400),
               (1, 8, 16, 592, 800), (1, 16, 96, 74, 100),
               (1, 16, 8, 1184, 1600)]


@pytest.mark.parametrize("table,want", [
    ("KERNELS", ch.conv3d_head), ("PLAIN", ch.conv3d_head_plain)])
def test_registered_with_the_launch_machinery(table, want):
    """The head is one of the port's kernels: its wrapper and plain
    version sit beside the sweep kernels', so launch counts and
    `on_launch` hooks (chip_smoke's checks) cover it."""
    assert getattr(sk, table)["conv3d_head"] is want


@pytest.mark.parametrize("name", sorted(sk.KERNELS))
def test_launch_counts_cover_every_kernel(name):
    """launch_counts reads each kernel's count, the head's among them, and
    reset_launch_counts zeroes it."""
    wrapper = sk.KERNELS[name]
    saved = wrapper.launches
    try:
        wrapper.launches = 3
        assert sk.launch_counts()[name] == 3
        sk.reset_launch_counts()
        assert wrapper.launches == 0
        assert sk.launch_counts()[name] == 0
    finally:
        wrapper.launches = saved


def test_work_counts_the_bound():
    """MVSNet's head at 1184x1600: 364 MB read, 45 MB written, 9.8 GFLOP;
    the weight and bias are read once."""
    x = torch.empty((1, 8, 192, 296, 400), dtype=torch.bfloat16,
                    device="meta")
    w, b = head_params(8, True, dtype=torch.bfloat16, device="meta")
    work = ch.conv3d_head_work(x, w, b)
    voxels = 192 * 296 * 400
    assert work.bytes == voxels * 8 * 2 + voxels * 2 + (27 * 8 + 1) * 2
    assert work.operations == voxels * (27 * 8 * 2 + 1)


@pytest.mark.parametrize("shape", MAIN_SHAPES)
def test_bf16_heads_are_bound_by_their_bytes(shape):
    """At the bf16 tensor-core rate every main-path head is bound by its
    bytes: MVSNet's 1184x1600 head by 0.122 ms."""
    x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    w, b = head_params(shape[1], True, dtype=torch.bfloat16, device="meta")
    ms, by = ch.conv3d_head_bound(x, w, b)
    assert by == "bytes"
    assert ms == pytest.approx(sk.nbytes(x, w, b, x[:, :1])
                               / sk.HBM_BYTES_PER_S * 1e3)
    if shape == MAIN_SHAPES[0]:
        assert ms == pytest.approx(0.122, abs=5e-4)


def test_f32_heads_are_bound_by_their_bytes_at_the_f32_rate():
    """In f32 (4C + 4 bytes a voxel, about 13 operations a byte) the bytes
    bound the head even at the CUDA cores' rate, which the bound takes
    there (no tensor-core product keeps f32 operands)."""
    x = torch.empty((1, 16, 8, 1184, 1600), device="meta")
    w, _ = head_params(16, False, device="meta")
    ms, by = ch.conv3d_head_bound(x, w)
    work = ch.conv3d_head_work(x, w)
    assert by == "bytes"
    assert ms == pytest.approx(work.bytes / sk.HBM_BYTES_PER_S * 1e3)
    assert work.operations / sk.F32_FLOPS * 1e3 > 0.6 * ms


# --- on the card ------------------------------------------------------------

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs on the card only")
    return torch.device("cuda")


def within_one_ulp(got, want):
    """Kernel against plain, element by element: both sum the same f32
    products (in another order: the kernel by kd, kh, channel, kw; the plain
    version by tap, then channel) and round once, so the f32 sums differ by
    about 1e-6 of the sum of the terms' magnitudes and a value may cross one
    rounding boundary: one bf16 ulp of the value. Near zero that f32
    difference is set by the terms, not the value: the floor is one ulp at
    1/64 of the output's largest magnitude. f32 outputs: 1e-5 of the
    largest (no rounding to bf16)."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    mag = want.abs().clamp(min=scale / 64)
    _, exp = torch.frexp(mag)
    return (got - want).abs() <= torch.ldexp(torch.ones_like(mag), exp - 8)


#: the main path's classes: MVSNet's head (D = 192, C = 8), a wide plane
#: (Vis stage 3, D = 16), CVP's finest (D = 8, C = 16) and coarsest
#: (D = 96, C = 16)
CARD_SHAPES = [(1, 8, 192, 296, 400, True), (1, 8, 16, 592, 800, False),
               (1, 16, 8, 1184, 1600, True), (1, 16, 96, 74, 100, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ch.DTYPES)
@pytest.mark.parametrize("case", range(len(CARD_SHAPES)))
def test_kernel_matches_plain(case, dtype):
    dev = card()
    *shape, bias = CARD_SHAPES[case]
    x = volume(shape, dtype, seed=case, device=dev)
    w, b = head_params(shape[1], bias, dtype, device=dev)
    with torch.inference_mode():
        n0 = ch.conv3d_head.launches
        got = ch.conv3d_head(x, w, b)
        assert ch.conv3d_head.launches == n0 + 1
        want = ch.conv3d_head_plain(x, w, b)
        again = ch.conv3d_head(x, w, b)
    torch.cuda.synchronize()
    assert got.shape == (shape[0], 1, *shape[2:]) and got.dtype == dtype
    if dtype == torch.bfloat16:
        ok = within_one_ulp(got, want)
    else:
        scale = want.abs().max()
        ok = (got - want).abs() <= 1e-5 * scale
    assert bool(ok.all()), f"{int((~ok).sum())} voxels off"
    assert torch.equal(got, again)      # no atomics: the same bits


def dtu_request(n: int, h: int, w: int):
    from wildmvs_torch.bench import scene_dtu
    imgs, K, R, t, dmin, dmax = (a.numpy()[0] for a in
                                 scene_dtu(1, n, h, w, 625.3))
    return imgs, K, R, t, dmin, dmax


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kwargs,n,launches", [
    ("mvsnet", {}, 3, 1),
    ("vis_mvsnet", {}, 5, 15),
    ("cvp_mvsnet", {"cvp_nscale": 5, "sweep_method": "fused"}, 5, 5)])
def test_launches_a_request(arch, kwargs, n, launches):
    """One Predictor request runs every head on the kernel: MVSNet 1,
    Vis-MVSNet 15 (3 stages of 4 pairs and the fused volume), CVP-MVSNet
    5 (one a level)."""
    card()
    from wildmvs_torch.infer import Predictor
    pred = Predictor(architecture=arch, **kwargs)
    req = dtu_request(n, 256, 320)
    pred(*req)
    n0 = ch.conv3d_head.launches
    out = pred(*req)
    assert ch.conv3d_head.launches - n0 == launches
    assert np.isfinite(out["depth"]).all()


@pytest.mark.gpu
def test_no_launch_in_a_training_step():
    """A training step records the head's gradient: nn.Conv3d (cuDNN)."""
    dev = card()
    from wildmvs_torch.data.synthetic import SyntheticMVSDataset, collate
    from wildmvs_torch.train import trainer as T
    from wildmvs_torch.train.config import TrainConfig
    cfg = TrainConfig(architecture="mvsnet", dataset="synthetic",
                      num_depth=48, lr=1e-3, train_dtype="bfloat16")
    ds = SyntheticMVSDataset(num_samples=1, num_views=3, height=128,
                             width=160)
    batch = T.batch_to_device(collate([ds[0]]), dev)
    state = T.create_train_state(cfg, dev)
    n0 = ch.conv3d_head.launches
    state, m = T.train_step(state, batch, cfg)
    assert np.isfinite(m["train_loss"].item())
    assert ch.conv3d_head.launches == n0
    assert state.model.cost_regularization.prob.weight.grad is not None
