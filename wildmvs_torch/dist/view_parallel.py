"""View-parallel occlusion-masked training: the reference views spread over
the ranks of the mesh's `view` axis.

Counterpart of wildmvs/dist/view_parallel.py:41-152 (the reference's
distributed mode, train.py:311-312 and models/trainer.py:240-278: with
--occ_masking, one rank per reference view on an identical batch, the
depthmaps exchanged by all_gather to occlusion-mask each rank's
photometric loss, DDP's gradient mean). One process a rank instead of
JAX's shard_map; the step is trainer.train_step over the mesh under
occlusion masking:

  * the batch is whole on every `view` rank and split over `data`
    (`mesh.shard_batch`); view rank v owns the reference views
    {v * per_shard + k}, runs their train-mode forwards (recomputed in the
    backward under config.remat) and averages their `loss_from_outputs`;
  * each scale's depthmaps at loss resolution are gathered over `view`,
    detached, into the [B, N, h, w] stack that the single-program step
    builds (trainer._per_scale_gather); each view's loss puts its own live
    depth back into it;
  * the gradients are the mean over every rank (data x view), as DDP's;
    the loss returned is the mean of the ranks' losses;
  * BatchNorm is not synced: each data rank normalizes over its own rows,
    as inside JAX's shard_map. The running statistics kept are reference
    view 0's forward's (on view rank 0 the later forwards run inside
    `frozen_running_stats`, as in the single-program step), averaged over
    `data`, then broadcast over `view`.

With data 1 the step equals trainer.train_step without a mesh: the same
forwards and losses, each view's gradient computed by the same operations
and scale (1 / N), summed in another order.
"""
from __future__ import annotations

from ..train import trainer as T
from ..train.config import TrainConfig
from .mesh import Mesh


def make_view_parallel_train_step(mesh: Mesh, config: TrainConfig):
    """The view-parallel train step over `mesh`: step(state, batch) ->
    (state, {"train_loss", "depth_est"}), run by every rank of the mesh
    with its rows of the batch over `data` (all N views). depth_est is
    this rank's first reference view's depth.

    Requires occlusion masking and num_im_train % view == 0."""
    assert config.occ_masking and not config.supervised
    assert config.num_im_train % mesh.shape["view"] == 0, (
        config.num_im_train, mesh.shape["view"])
    return lambda state, batch: T.train_step(state, batch, config, mesh)
