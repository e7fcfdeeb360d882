"""Typed training configuration: the port's own copy of the JAX package's
TrainConfig (wildmvs/train/config.py; reference train.py:255-315 and
models/trainer.py:26-51). Same fields, defaults and derived constants.

Fields the port does not serve yet are kept so a configuration reads the
same in both packages; they raise where they are used (train/trainer.py,
train/cli.py), not here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    architecture: str = "mvsnet"       # mvsnet | mvsnet-s | vis_mvsnet |
                                       # cvp_mvsnet
    dataset: str = "dtu"               # dtu | md | blended | synthetic
    supervised: bool = True
    occ_masking: bool = False
    upsample_training: bool = False
    num_im_train: int = 3
    batch_size: int = 1
    epochs: int = 15
    lr: float = 1e-3
    lrepochs: str = "13:10"            # "m1,m2:gamma_inv" MultiStepLR spec
    weight_decay: float = 0.0
    geom_clamping: float = 0.05        # occlusion-mask gate (train.py:278)
    seed: int = 1
    save_freq: int = 1
    print_every: int = 20
    logdir: str = "trained_models/debug"
    data_path: "str | None" = None
    debug: bool = False
    num_workers: int = 4
    # network compute dtype; parameters, BatchNorm statistics, optimizer
    # state and the loss stay f32
    train_dtype: str = "float32"       # float32 | bfloat16
    remat: bool = False
    # featurize all views in one call in train mode (BatchNorm statistics
    # across views instead of the reference's per-view calls)
    batched_bn: bool = False
    remat_levels: bool = False         # cvp_mvsnet only
    packed_training: bool = False      # cvp_mvsnet only
    num_depth: int = 192               # mvsnet hypothesis count
    hyp_axis: "str | None" = None      # depth partitioning (JAX mesh axis)

    def __post_init__(self):
        # constraint propagation, reference train.py:305-309
        if self.supervised and self.occ_masking:
            object.__setattr__(self, "occ_masking", False)

    @property
    def factors_loss(self) -> Tuple[float, ...]:
        """Multi-scale loss weights, finest first (vis_mvsnet only)."""
        return (2.0, 1.0, 0.5)

    @property
    def input_down(self) -> int:
        """Downsampling applied to the network input (upsample training)."""
        if self.upsample_training:
            if self.architecture == "cvp_mvsnet":
                return 4
            if self.architecture == "vis_mvsnet":
                return 2
        return 1

    @property
    def output_down(self) -> int:
        """Loss resolution = input resolution / output_down."""
        if not self.upsample_training:
            if self.architecture.startswith("mvsnet"):
                return 4
            if self.architecture == "vis_mvsnet":
                return 2
        return 1

    @property
    def lr_milestones(self) -> Tuple[int, ...]:
        return tuple(int(e) for e in self.lrepochs.split(":")[0].split(","))

    @property
    def lr_gamma(self) -> float:
        return 1.0 / float(self.lrepochs.split(":")[1])

    def lr_at_epoch(self, epoch: int) -> float:
        """MultiStepLR value at `epoch` (reference train.py:170-173)."""
        passed = sum(1 for m in self.lr_milestones if epoch >= m)
        return self.lr * (self.lr_gamma ** passed)
