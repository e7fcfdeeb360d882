"""Training core: model and optimizer set-up, loss assembly, train/eval/test
steps.

Counterpart of wildmvs/train/trainer.py:35-301 (reference models/trainer.py
and train.py:176-250). The JAX package's pure jitted steps over an explicit
TrainState become eager steps over a `TrainState` holding the model, its
optimizer and the step count; the model keeps its BatchNorm statistics as
buffers, updated by the train-mode forward.

Precision: parameters, BatchNorm statistics, optimizer state and the loss
are f32. With train_dtype="bfloat16" the model is built with bf16 compute
and f32 parameters (models/mvsnet.py `param_dtype`): the convolutions run in
bf16 under autocast, the parameters themselves stay f32.

Model-output contract (models/api.py): depth_est_list entries are [B, h, w]
(finest first); depth_pair_list entries are lists of
(depth [B, h, w], (uncertainty [B, h, w],)) per source pair.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.projective import scale_K
from ..losses.supervised import (bayesian_loss, downsample_gt,
                                 masked_l1_interval, resize_bilinear)
from ..models import build_model
from .config import TrainConfig
from .metrics import depth_metrics

ARCHITECTURES = ("mvsnet", "mvsnet-s")


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_model(config: TrainConfig, device=None) -> torch.nn.Module:
    """The training model of `config` with seeded random weights (seed
    `config.seed`), on `device` ("cuda" unless "cpu" is asked for)."""
    if config.architecture not in ARCHITECTURES:
        raise NotImplementedError(
            f"{config.architecture}: the port trains mvsnet and mvsnet-s "
            f"only (vis_mvsnet and cvp_mvsnet are ROADMAP Queue 1 #9, #10)")
    for flag in ("remat", "remat_levels", "packed_training"):
        if getattr(config, flag):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP Queue 1 #8)")
    if config.hyp_axis is not None:
        raise NotImplementedError(
            "hyp_axis (depth-slab sharding) is not ported yet (ROADMAP "
            "Queue 1 #12)")
    kwargs = {"num_depth": config.num_depth, "batched_bn": config.batched_bn}
    if config.train_dtype == "bfloat16":
        kwargs.update(dtype=torch.bfloat16, param_dtype=torch.float32)
    elif config.train_dtype != "float32":
        raise ValueError(f"train_dtype {config.train_dtype!r}")
    return build_model(config.architecture, device=device, seed=config.seed,
                       **kwargs)


def make_optimizer(config: TrainConfig,
                   model: torch.nn.Module) -> torch.optim.Optimizer:
    """Adam (betas 0.9/0.999, eps 1e-8) with coupled L2 weight decay, as
    torch.optim.Adam's weight_decay (reference train.py:139; the JAX
    package's add_decayed_weights ahead of scale_by_adam)."""
    return torch.optim.Adam(model.parameters(), lr=config.lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=config.weight_decay)


def create_train_state(config: TrainConfig, device=None,
                       model: torch.nn.Module | None = None) -> TrainState:
    """A fresh TrainState; `model` (already on its device) replaces the
    seeded one, e.g. weights carried from the JAX package."""
    if model is None:
        model = create_model(config, resolve_device(device))
    return TrainState(model=model, optimizer=make_optimizer(config, model))


def set_epoch_lr(state: TrainState, config: TrainConfig,
                 epoch: int) -> TrainState:
    """Apply the MultiStepLR value of `epoch` (reference train.py:170-173)."""
    for group in state.optimizer.param_groups:
        group["lr"] = config.lr_at_epoch(epoch)
    return state


def batch_to_device(batch: dict, device) -> dict:
    """A collated numpy batch -> f32 tensors on `device` (the file names
    stay behind)."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in batch.items() if k != "filename"}


def forward_args(batch: dict, config: TrainConfig):
    """The model's positional inputs, downsampled by `input_down` with K
    scaled to match (reference models/trainer.py:61-76)."""
    imgs = batch["imgs"]
    b, n, h, w, c = imgs.shape
    down = config.input_down
    K = batch["K"]
    if down != 1:
        flat = resize_bilinear(imgs.reshape(b * n, h, w, c),
                               (h // down, w // down))
        imgs = flat.reshape(b, n, h // down, w // down, c)
        K = scale_K(K, 1.0 / down)
    return (imgs, K, batch["R"], batch["t"], batch["depth_min"],
            batch["depth_max"])


def loss_from_outputs(outputs: dict, batch: dict, config: TrainConfig,
                      ref_idx: int = 0) -> torch.Tensor:
    """The supervised training loss of one reference view's outputs
    (reference models/trainer.py:106-206, supervised branch): the masked
    interval-L1 of every depth estimate against the downsampled GT, and the
    Bayesian loss of every pair estimate, each weighted by its scale's
    factor (vis_mvsnet only; 1 otherwise)."""
    if not config.supervised:
        raise NotImplementedError(
            "unsupervised (photometric) training is not ported yet "
            "(ROADMAP Queue 1 #12)")
    n = batch["imgs"].shape[1]
    loss = batch["imgs"].new_zeros(())

    def factor_at(i):
        return (config.factors_loss[i]
                if config.architecture == "vis_mvsnet" else 1.0)

    depth_interval = (batch["depth_max"] - batch["depth_min"])[:, 0] / 128.0
    for i, d in enumerate(outputs["depth_est_list"]):
        if d is None:
            continue
        gt_d, mask_d = downsample_gt(batch["depth"], batch["mask"],
                                     tuple(d.shape[1:3]))
        loss = loss + factor_at(i) * masked_l1_interval(d, gt_d, mask_d,
                                                        depth_interval)
    for i, pairs in enumerate(outputs["depth_pair_list"]):
        factor = factor_at(i) / (n - 1)
        for dp, (unc,) in pairs:
            if dp is None:
                continue
            gt_d, mask_d = downsample_gt(batch["depth"], batch["mask"],
                                         tuple(dp.shape[1:3]))
            l1 = (dp - gt_d).abs() / depth_interval[:, None, None]
            loss = loss + factor * bayesian_loss(l1, unc, mask_d)
    return loss


def train_step(state: TrainState, batch: dict, config: TrainConfig):
    """One optimizer step on reference view 0 (train-mode BatchNorm, whose
    running statistics the forward updates). The gradients stay on the
    parameters until the next step. Returns (state, {"train_loss",
    "depth_est"}) as device tensors."""
    if config.occ_masking:
        raise NotImplementedError(
            "occ_masking is not ported yet (ROADMAP Queue 1 #12)")
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    out = model(*forward_args(batch, config), reference_frame=0)
    loss = loss_from_outputs(out, batch, config, 0)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state, {"train_loss": loss.detach(),
                   "depth_est": out["depth"].detach()}


@torch.no_grad()
def eval_step(state: TrainState, batch: dict, config: TrainConfig) -> dict:
    """Validation loss: the training loss with running BatchNorm statistics
    and no gradient (reference train.py:217-230)."""
    model = state.model
    model.eval()
    out = model(*forward_args(batch, config), reference_frame=0)
    return {"val_loss": loss_from_outputs(out, batch, config, 0)}


@torch.no_grad()
def test_step(state: TrainState, batch: dict, config: TrainConfig) -> dict:
    """Depth metrics against GT at full resolution (reference
    models/trainer.py:280-321); mvsnet has no test-time override."""
    model = state.model
    model.eval()
    out = model(batch["imgs"], batch["K"], batch["R"], batch["t"],
                batch["depth_min"], batch["depth_max"])
    gt = batch["depth"]
    est = resize_bilinear(out["depth"].float(), tuple(gt.shape[1:3]))
    return depth_metrics(est, gt, batch["mask"], batch["depth_min"][:, 0],
                         batch["depth_max"][:, 0])
