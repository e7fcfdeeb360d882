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
as the JAX step keeps view 0's. Over a mesh the same step spreads the
reference views over the ranks (`train_step`, dist/view_parallel.py).

`remat` recomputes each forward's activations in the backward (`forward`).
`train_step(..., mesh)` is the data-parallel step (with the hypotheses
over "hyp" where the model was built so) or, with occ_masking, the
view-parallel step, over the ranks of a dist/mesh.py mesh.

The gradient over a mesh, and why it is the single program's: every
rank back-propagates loss / copies, where copies is the number of ranks
that hold the same loss (its view x hyp ranks in the data-parallel step,
every rank in the view-parallel one), and the parameters' gradients are
then summed over every rank. Each collective on the way is differentiated
by its adjoint: `all_reduce_sum` by the all_reduce of the cotangent,
`gather_slabs` by the all_reduce of the cotangent cut to this rank's slab,
`fetch_range` (a partitioned conv's halo) by returning each borrowed
plane's cotangent to its owner, and the detached MAX of the softmax by
nothing. So the step is one program's backward spread over the ranks:
  * a replicated part (FeatureNet, UncertNet, the loss) computed alike by
    the copies holds 1/copies of its share on each; the sum counts it
    once;
  * each hyp rank's slab of a depth-partitioned regularizer receives its
    whole cotangent (the reductions over depth add the copies' 1/copies
    shares back up), so the rank holds its slab's share of the
    regularizer's gradient, and the sum over the hyp ranks is the whole;
  * no reduction needs a backward that does not re-sum: a rank that
    back-propagated its whole loss, not loss / copies, would count a
    replicated loss copies times through those all_reduces.
Train-mode BatchNorm follows the same split: FeatureNet's and UncertNet's
are synced over `data` alone (each hyp rank holds the same rows: summing
over hyp would count a sample hyp times), a partitioned regularizer's
over its slabs on every rank of the data x hyp plane
(dist/depth_parallel.py), so every rank keeps the same running
statistics, which take the unbiased variance of the whole batch.

Model-output contract (models/api.py): depth_est_list entries are [B, h, w]
(finest first); depth_pair_list entries are lists of
(depth [B, h, w], (uncertainty [B, h, w],)) per source pair.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..geometry.projective import build_proj_matrices, scale_K
from ..losses.photometric import (masked_mean, masked_photometric_loss,
                                  photometric_loss)
from ..losses.supervised import (bayesian_loss, downsample_gt,
                                 masked_l1_interval, resize_bilinear)
from ..dist.mesh import (Mesh, all_reduce, gather_slabs, my_slab,
                         sum_gradients, use_mesh)
from ..models import build_model
from ..nn.blocks import (frozen_running_stats, lecun_normal_init,
                         synced_batch_norm)
from ..utils.monitor import span
from .config import TrainConfig
from .metrics import depth_metrics

SPAN = "wildmvs_torch.train_step"

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
    kwargs = {"batched_bn": config.batched_bn, "hyp_axis": config.hyp_axis}
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
    seeded one, e.g. weights carried from the JAX package.

    A fresh model trains from the JAX trainer's distribution: its kernels
    are drawn again as flax's `lecun_normal` draws them, from a generator
    seeded with `config.seed` (nn/blocks.lecun_normal_init). The
    constructor's He-normal weights are for seeded random-weight serving,
    where eval-mode BatchNorm at its initial statistics would shrink
    lecun-scale activations by sqrt(2) a layer; a trainer normalizes by
    the batch and has no such reason."""
    if model is None:
        model = create_model(config, resolve_device(device))
        lecun_normal_init(model, torch.Generator().manual_seed(config.seed))
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
    with span("wildmvs_torch.batch_to_device"):
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
                      ref_idx: int = 0, all_depthmaps=None,
                      data_axis=None) -> torch.Tensor:
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
    depth replaces its slice. With `data_axis` (a dist/mesh.py axis over
    which the batch's rows are split) every masked mean counts its mask
    over the whole batch (losses/supervised.masked_mean): the loss is this
    rank's share of the whole batch's."""
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
                d, gt_d, mask_d, depth_interval, data_axis)
        for i, pairs in enumerate(outputs["depth_pair_list"]):
            factor = factor_at(i) / (n - 1)
            for dp, (unc,) in pairs:
                if dp is None:
                    continue
                gt_d, mask_d = downsample_gt(batch["depth"], batch["mask"],
                                             tuple(dp.shape[1:3]))
                l1 = (dp - gt_d).abs() / depth_interval[:, None, None]
                loss = loss + factor * bayesian_loss(l1, unc, mask_d,
                                                     data_axis)
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
        loss = loss + factor_at(i) * masked_mean(
            ssim, mask.to(ssim.dtype), data_axis)
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
                                                 mask.to(ssim.dtype),
                                                 data_axis)
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


def forward(model, args, reference_frame: int, config: TrainConfig):
    """The model's forward on reference view `reference_frame`; with
    config.remat in train mode its activations are recomputed in the
    backward instead of kept (torch.utils.checkpoint, non-reentrant; the
    JAX package's jax.checkpoint over the forward, trainer.py:212-219).
    The recomputation leaves the BatchNorm running statistics alone
    (`frozen_running_stats`): the forward updated them once already."""
    if not (config.remat and model.training):
        return model(*args, reference_frame=reference_frame)
    calls = []

    def run(*args):
        ctx = (frozen_running_stats(model) if calls
               else contextlib.nullcontext())
        calls.append(1)
        with ctx:
            return model(*args, reference_frame=reference_frame)
    return checkpoint(run, *args, use_reentrant=False)


def _all_views_loss(model, batch: dict, config: TrainConfig, view=None):
    """The occlusion-masked loss averaged over this rank's reference views
    (every view without a `view` axis; over one, view rank v's contiguous
    slab of them), and its first view's outputs. The depths at loss
    resolution are gathered over `view`, detached. In train mode the
    forwards after this rank's first leave the BatchNorm running
    statistics as the first set them."""
    args = forward_args(batch, config)
    n, h, w = batch["imgs"].shape[1:4]
    refs = range(*my_slab(n, view))
    outs = []
    for k, r in enumerate(refs):
        frozen = (frozen_running_stats(model) if k and model.training
                  else contextlib.nullcontext())
        with frozen:
            outs.append(forward(model, args, r, config))
    all_d = [gather_slabs(d, view, 1, n) for d in _per_scale_gather(
        outs, (h // config.output_down, w // config.output_down))]
    total = sum(loss_from_outputs(out, batch, config, r, all_depthmaps=all_d)
                for out, r in zip(outs, refs))
    return total / len(refs), outs[0]


@torch.no_grad()
def _share_running_stats(model: torch.nn.Module, mesh: Mesh) -> None:
    """Every rank takes view rank 0's BatchNorm running statistics, averaged
    over `data` (JAX: pmean over data of the psum over view of the stats
    masked to view shard 0, wildmvs/dist/view_parallel.py:97-109)."""
    data, view = mesh.axis("data"), mesh.axis("view")
    if data.group is None and view.group is None:
        return
    stats = [t for m in model.modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
             for t in (m.running_mean, m.running_var)]
    flat = torch.cat([t.reshape(-1) for t in stats])
    flat = all_reduce(flat, data) / data.size
    if view.group is not None:
        dist.broadcast(flat, src=view.ranks[0], group=view.group)
    offset = 0
    for t in stats:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def train_step(state: TrainState, batch: dict, config: TrainConfig,
               mesh: Mesh | None = None):
    """One optimizer step (train-mode BatchNorm, whose running statistics
    the forward updates): on reference view 0, or with occ_masking on
    every view, the loss averaged over them. The gradients stay on the
    parameters until the next step. Returns (state, {"train_loss",
    "depth_est"}) as device tensors.

    With a `mesh` (dist/mesh.py) the step runs on every rank of it, each
    on its rows of the batch (`shard_batch` over "data"); the gradients
    are summed over every rank, each having back-propagated its share, and
    the loss returned is the whole step's. Two steps, as in the JAX
    package:

      * without occ_masking, JAX's step on a data-sharded batch: BatchNorm
        normalizes over the whole batch (`synced_batch_norm` over
        "data"), every masked mean counts its mask over the whole batch
        (loss_from_outputs' data_axis), and a model built with hyp_axis
        sweeps its slab of the hypotheses and keeps it through its
        depth-partitioned regularizer. The gradient is the whole batch's.
      * with occ_masking, the view-parallel step (dist/view_parallel.py,
        JAX's make_view_parallel_train_step): view rank v takes its slab
        of the reference views, the depths are gathered over "view", each
        data rank normalizes and takes the loss over its own rows, and
        the gradient and loss are the mean over the ranks (DDP's). The
        running statistics kept are reference view 0's, averaged over
        "data". With data 1 it is the single-program step.

    Under a profiler the step records the span `wildmvs_torch.train_step`
    and, inside it, `.forward`, `.loss` (with occ_masking the views'
    forwards and losses are one `.forward`), `.backward` (with the
    gradient sum over the ranks) and `.optimizer` (Adam's step)."""
    with span(SPAN):
        return _train_step(state, batch, config, mesh)


def _train_step(state: TrainState, batch: dict, config: TrainConfig,
                mesh: Mesh | None):
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    # each rank back-propagates its loss / copies, and the gradients are
    # summed (module docstring): view-parallel, the mean over the ranks;
    # otherwise each data rank's share of the whole batch's loss, held
    # alike by its view x hyp ranks
    view = data = None
    copies = 1
    if mesh is not None and _occ_masked(config):
        view, copies = mesh.axis("view"), mesh.size
    elif mesh is not None:
        data, copies = mesh.axis("data"), mesh.size // mesh.shape["data"]
    with use_mesh(mesh), synced_batch_norm(model, data):
        if _occ_masked(config):
            with span(f"{SPAN}.forward"):
                loss, out = _all_views_loss(model, batch, config, view)
        else:
            with span(f"{SPAN}.forward"):
                out = forward(model, forward_args(batch, config), 0, config)
            with span(f"{SPAN}.loss"):
                loss = loss_from_outputs(out, batch, config, 0,
                                         data_axis=data)
        with span(f"{SPAN}.backward"):
            (loss / copies).backward()
            if mesh is not None and mesh.size > 1:
                sum_gradients(model, mesh.axis("all"))
                loss = all_reduce(loss.detach(), mesh.axis("all")) / copies
    with span(f"{SPAN}.optimizer"):
        state.optimizer.step()
    if view is not None:
        _share_running_stats(model, mesh)
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
