"""Training core: model and optimizer set-up, loss assembly, train/eval/test
steps.

Counterpart of wildmvs/train/trainer.py:35-301 (reference models/trainer.py
and train.py:176-250). The JAX package's pure jitted steps over an explicit
TrainState become eager steps over a `TrainState` holding the model, its
optimizer and the step count; the model keeps its BatchNorm statistics as
buffers, updated by the train-mode forward.

Architectures: mvsnet, mvsnet-s (num_depth hypotheses), vis_mvsnet (the
JAX defaults: depth_nums (32, 16, 8), interval_scales (4, 2, 1)) and
cvp_mvsnet (2 pyramid levels in training, 4 at test off DTU).

Precision: parameters, BatchNorm statistics, optimizer state and the loss
are f32. With train_dtype="bfloat16" the model is built with bf16 compute
and f32 parameters (`param_dtype`): the convolutions run in bf16 under
autocast, the parameters themselves stay f32.

With occ_masking (unsupervised only) a step runs every view as the
reference in turn and averages the N occlusion-masked losses; each view's
loss sees the other views' depths detached, as the JAX package's does
(wildmvs/train/trainer.py:224-243; the reference's N ranks and their
all_gather). The forwards for reference views 1..N-1 leave the BatchNorm
running statistics as view 0's forward set them (`frozen_running_stats`),
as the JAX step keeps view 0's.

Model-output contract (models/api.py): depth_est_list entries are [B, h, w]
(finest first); depth_pair_list entries are lists of
(depth [B, h, w], (uncertainty [B, h, w],)) per source pair.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.projective import build_proj_matrices, scale_K
from ..losses.photometric import (masked_mean, masked_photometric_loss,
                                  photometric_loss)
from ..losses.supervised import (bayesian_loss, downsample_gt,
                                 masked_l1_interval, resize_bilinear)
from ..models import build_model
from ..nn.blocks import frozen_running_stats
from .config import TrainConfig
from .metrics import depth_metrics

ARCHITECTURES = ("mvsnet", "mvsnet-s", "vis_mvsnet", "cvp_mvsnet")
#: vis_mvsnet's test-time sweep (reference models/trainer.py:290-296),
#: passed as forward kwargs
VIS_TEST_KWARGS = {"depth_nums": (64, 32, 16),
                   "interval_scales": (2.0, 1.0, 0.5)}


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
        raise ValueError(f"unknown architecture: {config.architecture}")
    if config.remat:
        raise NotImplementedError(
            "remat is not ported yet (ROADMAP Queue 1, item 7)")
    if config.hyp_axis is not None:
        raise NotImplementedError(
            "hyp_axis (depth-slab sharding) is not ported yet (ROADMAP "
            "Queue 1, item 5)")
    kwargs = {"batched_bn": config.batched_bn}
    if config.architecture.startswith("mvsnet"):
        kwargs["num_depth"] = config.num_depth
    if config.architecture == "cvp_mvsnet":
        kwargs.update(remat_levels=config.remat_levels,
                      packed_training=config.packed_training)
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
                      ref_idx: int = 0, all_depthmaps=None) -> torch.Tensor:
    """The training loss of one reference view's outputs (reference
    models/trainer.py:106-206), each scale weighted by its factor
    (vis_mvsnet only; 1 otherwise).

    Supervised: the masked interval-L1 of every depth estimate against the
    downsampled GT, and the Bayesian loss of every pair estimate.
    Unsupervised: the DSSIM of the source views warped by every depth
    estimate, at loss resolution (input / output_down), and the Bayesian
    DSSIM of every pair estimate (never occlusion-masked). `all_depthmaps`
    (one [B, N, H', W'] a scale at loss resolution, every view's depth
    detached) turns on the occlusion-masked loss: this view's own live
    depth replaces its slice."""
    imgs = batch["imgs"]
    b, n, h, w, c = imgs.shape
    src_idx = [i for i in range(n) if i != ref_idx]
    loss = imgs.new_zeros(())

    def factor_at(i):
        return (config.factors_loss[i]
                if config.architecture == "vis_mvsnet" else 1.0)

    if config.supervised:
        depth_interval = (batch["depth_max"]
                          - batch["depth_min"])[:, 0] / 128.0
        for i, d in enumerate(outputs["depth_est_list"]):
            if d is None:
                continue
            gt_d, mask_d = downsample_gt(batch["depth"], batch["mask"],
                                         tuple(d.shape[1:3]))
            loss = loss + factor_at(i) * masked_l1_interval(
                d, gt_d, mask_d, depth_interval)
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

    # unsupervised: the photometric DSSIM at loss resolution, in f32
    lh, lw = h // config.output_down, w // config.output_down
    loss_imgs = (resize_bilinear(imgs.reshape(b * n, h, w, c),
                                 (lh, lw)).reshape(b, n, lh, lw, c)
                 if (lh, lw) != (h, w) else imgs)
    proj = build_proj_matrices(scale_K(batch["K"], 1.0 / config.output_down),
                               batch["R"], batch["t"])
    for i, d in enumerate(outputs["depth_est_list"]):
        if d is None:
            continue
        d_up = resize_bilinear(d.float(), (lh, lw))
        if config.occ_masking and all_depthmaps is not None:
            # a fresh stack around this view's live depth: the shared
            # detached stack is never written
            others = all_depthmaps[i]
            all_d = torch.cat([others[:, :ref_idx], d_up[:, None],
                               others[:, ref_idx + 1:]], dim=1)
            ssim, mask = masked_photometric_loss(
                loss_imgs, all_d, proj, ref_idx, config.geom_clamping)
        else:
            perm = [ref_idx] + src_idx
            ssim, mask = photometric_loss(loss_imgs[:, perm], d_up,
                                          proj[:, perm])
        loss = loss + factor_at(i) * masked_mean(ssim, mask.to(ssim.dtype))
    for i, pairs in enumerate(outputs["depth_pair_list"]):
        factor = factor_at(i) / (n - 1)
        for pair_id, (dp, (unc,)) in enumerate(pairs):
            if dp is None:
                continue
            dp_up = resize_bilinear(dp.float(), (lh, lw))
            pair_idx = [ref_idx, src_idx[pair_id]]
            ssim, mask = photometric_loss(loss_imgs[:, pair_idx], dp_up,
                                          proj[:, pair_idx])
            u = resize_bilinear(unc.float(), (lh, lw))[:, None]
            loss = loss + factor * bayesian_loss(ssim, u,
                                                 mask.to(ssim.dtype))
    return loss


def _per_scale_gather(outs: list, hw: tuple[int, int]) -> list:
    """[B, N, H', W'] of every view's depth at loss resolution, detached,
    one a scale: the reference's per-scale all_gather (models/trainer.py:
    246-247)."""
    n_scales = len(outs[0]["depth_est_list"])
    return [torch.stack([resize_bilinear(o["depth_est_list"][i].detach()
                                         .float(), hw) for o in outs], dim=1)
            for i in range(n_scales)]


def _occ_masked(config: TrainConfig) -> bool:
    return config.occ_masking and not config.supervised


def _all_views_loss(model, batch: dict, config: TrainConfig):
    """The occlusion-masked loss averaged over every reference view, and
    view 0's outputs. In train mode the forwards after view 0's leave the
    BatchNorm running statistics as view 0's set them."""
    args = forward_args(batch, config)
    n, h, w = batch["imgs"].shape[1:4]
    outs = []
    for r in range(n):
        frozen = (frozen_running_stats(model) if r and model.training
                  else contextlib.nullcontext())
        with frozen:
            outs.append(model(*args, reference_frame=r))
    all_d = _per_scale_gather(outs, (h // config.output_down,
                                     w // config.output_down))
    total = sum(loss_from_outputs(outs[r], batch, config, r,
                                  all_depthmaps=all_d) for r in range(n))
    return total / n, outs[0]


def train_step(state: TrainState, batch: dict, config: TrainConfig):
    """One optimizer step (train-mode BatchNorm, whose running statistics
    the forward updates): on reference view 0, or with occ_masking on
    every view, the loss averaged over them. The gradients stay on the
    parameters until the next step. Returns (state, {"train_loss",
    "depth_est"}) as device tensors."""
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    if _occ_masked(config):
        loss, out = _all_views_loss(model, batch, config)
    else:
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
    and no gradient (reference train.py:217-230), over every reference view
    with occ_masking."""
    model = state.model
    model.eval()
    if _occ_masked(config):
        return {"val_loss": _all_views_loss(model, batch, config)[0]}
    out = model(*forward_args(batch, config), reference_frame=0)
    return {"val_loss": loss_from_outputs(out, batch, config, 0)}


@torch.no_grad()
def test_step(state: TrainState, batch: dict, config: TrainConfig) -> dict:
    """Depth metrics against GT at full resolution (reference
    models/trainer.py:280-321). vis_mvsnet sweeps VIS_TEST_KWARGS, given
    as forward kwargs as the JAX trainer gives them (trainer.py:290-296),
    so its slabs re-centre with the module's interval_scales; cvp_mvsnet
    takes 4 pyramid levels off DTU (trainer.py:292-293); mvsnet has no
    test-time override."""
    model = state.model
    model.eval()
    kwargs = {}
    if config.architecture == "vis_mvsnet":
        kwargs = VIS_TEST_KWARGS
    elif config.architecture == "cvp_mvsnet" and config.dataset != "dtu":
        kwargs = {"nscale": 4}
    out = model(batch["imgs"], batch["K"], batch["R"], batch["t"],
                batch["depth_min"], batch["depth_max"], **kwargs)
    gt = batch["depth"]
    est = resize_bilinear(out["depth"].float(), tuple(gt.shape[1:3]))
    return depth_metrics(est, gt, batch["mask"], batch["depth_min"][:, 0],
                         batch["depth_max"][:, 0])
