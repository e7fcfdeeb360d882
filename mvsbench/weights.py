"""Seeded weights, made on the device in one draw.

Every floating-point tensor of the reference model's state dict (sorted
by key) takes its slice of one `torch.randn` call from a generator on the
device seeded with `--seed`:
  conv weights   He-normal, std sqrt(2 / fan_in) (fan_in: input channels
                 times taps), times `logit_gain` for the configuration's
                 last convs, so that the softmax over depth is peaked
  conv biases    0.1 n
  BN weight      1 + 0.1 n; bias 0.1 n; running_mean 0.1 n;
                 running_var exp(0.2 n)
Then the BatchNorm running statistics are set to what they are on one
probe request or sample of the cell (`calibrate_bn`: the plain reference
in train mode, a cumulative average over its calls), so that every layer
normalizes as a trained network's would and the logits' spread over
depth is set by `logit_gain` alone, on every seed alike. The same dict is
loaded into the program (`load_state_dict`) and into the reference,
unchanged.
"""
from __future__ import annotations

import time

import torch
from torch import nn

from .reference.common import CONVS, f32_flags


def _fan_in(m: nn.Module) -> int:
    w = m.weight
    deconv = isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d))
    return w.shape[0] * w[0, 0].numel() if deconv else w[0].numel()


@torch.no_grad()
def seeded_state_dict(model: nn.Module, seed: int, device: torch.device,
                      gains: dict) -> dict:
    """The state dict of `model`'s keys, drawn on `device` from `seed`;
    `gains` maps a conv's module name to the factor on its weight."""
    kinds = {}
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, CONVS):
            g = gains.get(name, 1.0)
            kinds[prefix + "weight"] = (g * (2.0 / _fan_in(m)) ** 0.5, 0.0)
            if m.bias is not None:
                kinds[prefix + "bias"] = (0.1, 0.0)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            kinds[prefix + "weight"] = (0.1, 1.0)
            kinds[prefix + "bias"] = (0.1, 0.0)
            kinds[prefix + "running_mean"] = (0.1, 0.0)
            kinds[prefix + "running_var"] = "exp"
    template = model.state_dict()
    missing = set(gains) - {n for n, _ in model.named_modules()}
    if missing:
        raise KeyError(f"logit_gain names no module: {sorted(missing)}")
    floats = sorted(k for k, v in template.items() if v.is_floating_point())
    total = sum(template[k].numel() for k in floats)
    g = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=g, device=device)
    out, offset = {}, 0
    for k in floats:
        v = template[k]
        x = draw[offset:offset + v.numel()].reshape(v.shape)
        offset += v.numel()
        kind = kinds[k]
        out[k] = torch.exp(0.2 * x) if kind == "exp" else x * kind[0] + kind[1]
    for k, v in template.items():
        if not v.is_floating_point():
            out[k] = torch.zeros_like(v, device=device)
    return out


@torch.no_grad()
def calibrate_bn(model: nn.Module, run) -> dict:
    """The state dict of `model` (a reference holding the seeded weights)
    with each BatchNorm's running mean and variance averaged over what
    `run(model)` feeds it in train mode."""
    bns = [m for m in model.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None                   # a cumulative average
    model.train()
    with f32_flags():
        run(model)
    for m in bns:
        m.momentum = 0.1
        m.num_batches_tracked.zero_()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def cell_weights(ref_mod, cfg: dict, seed: int, device, probe: dict):
    """The cell's weights: drawn from `seed` (`seeded_state_dict`), the
    BatchNorm statistics set on `probe` (batched f32 tensors of one
    request or sample) by the plain reference. The reference's memory is
    returned to the card and the peak statistic reset. Returns (the state
    dict, the seconds the reference took), since the reference's time is
    not the program's set-up."""
    with torch.device("meta"):
        template = ref_mod.build(cfg)
    state = seeded_state_dict(template, seed, device, cfg["logit_gain"])
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.device(device):
        model = ref_mod.build(cfg)
    model.load_state_dict(state)
    state = calibrate_bn(model, lambda m: m(
        probe["imgs"], probe["K"], probe["R"], probe["t"],
        probe["depth_min"], probe["depth_max"]))
    del model
    if on_card:
        torch.cuda.synchronize(device)
    reference_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return state, reference_s
