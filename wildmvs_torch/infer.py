"""One-call inference API: load a model once, predict depthmaps.

Counterpart of wildmvs/infer.py:30-157. The architecture comes from the
checkpoint (or is given), eval-time overrides are applied, and inputs are
cropped from the top-left to the /32 multiple the network needs (a
top-left crop leaves K unchanged).

    from wildmvs_torch.infer import Predictor
    pred = Predictor("weights.npz")                 # or architecture="mvsnet"
    out = pred(imgs, K, R, t, depth_min, depth_max) # imgs [N, H, W, 3]
    out["depth"], out["confidence"]                 # numpy, f32

Runs on the card ("cuda") unless constructed with device="cpu". With a
`mesh` (dist/mesh.py), every rank of it builds the predictor and calls it
with the same request, which is sharded over the ranks: over "hyp" each
rank sweeps its slab of the depth hypotheses and keeps it through the
depth-partitioned 3D regularizer (dist/depth_parallel.py), over "view"
Vis-MVSNet's source pairs; every rank returns the whole result.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .device import resolve_device
from .dist.mesh import use_mesh
from .models import build_model
from .pipeline.depthmaps import eval_model_kwargs
from .train.checkpoint import resolve_checkpoint
from .train.jax_import import load_weights
from .utils.monitor import span

SPAN = "wildmvs_torch.Predictor"


class Predictor:
    """A loaded eval network with input normalization.

    Args:
      model_path: an npz (JAX `save_params_npz`) or torch checkpoint
        file, a JAX orbax checkpoint directory, or a logdir (its newest
        checkpoint); None for seeded random weights (seed 0; smoke and
        performance runs).
      architecture: mvsnet | mvsnet-s | vis_mvsnet | cvp_mvsnet; read
        from the checkpoint if None.
      bf16: run the networks in bf16 (default) or f32.
      cvp_nscale: cvp_mvsnet's pyramid levels (default 4; the reference
        evaluates DTU at 5 and other scenes at 4, pipeline_utils.py:133-139).
      sweep_method: cost-volume backend (models/mvsnet.py,
        models/vis_mvsnet.py, models/cvp_mvsnet.py); "auto" is each
        architecture's eval default (`eval_model_kwargs`: the rectified
        sweep "rect" for cvp_mvsnet).
      device: "cuda" (default; raises without a card) or "cpu".
      mesh: a dist.mesh.Mesh to shard each request over (module
        docstring), or None.
    """

    def __init__(self, model_path: str | Path | None = None,
                 architecture: str | None = None, bf16: bool = True,
                 cvp_nscale: int | None = None, sweep_method: str = "auto",
                 device: str | torch.device | None = None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        state_dict = None
        if model_path is not None:
            state_dict, ckpt_arch = load_weights(
                resolve_checkpoint(model_path))
            architecture = architecture or ckpt_arch
        if architecture is None:
            raise ValueError("need model_path or architecture")
        self.architecture = architecture
        cfg = eval_model_kwargs(architecture, bf16=bf16,
                                sweep_method=sweep_method)
        kwargs = dict(cfg["kwargs"])
        if mesh is not None:
            kwargs["hyp_axis"] = "hyp"
            if architecture == "vis_mvsnet":
                kwargs["view_axis"] = "view"
        self.model = build_model(architecture, device=self.device, **kwargs)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.eval()
        #: output resolution = input resolution / downscale
        self.downscale = cfg["downscale"]
        #: forward kwargs of the architecture's eval configuration
        self.forward_kwargs = {}
        if architecture == "cvp_mvsnet":
            self.forward_kwargs["nscale"] = (4 if cvp_nscale is None
                                             else cvp_nscale)

    @staticmethod
    def _crop32(imgs: np.ndarray) -> np.ndarray:
        """Top-left crop of [..., H, W, 3] to /32 multiples."""
        h, w = imgs.shape[-3:-1]
        nh, nw = (h // 32) * 32, (w // 32) * 32
        if nh == 0 or nw == 0:
            raise ValueError(f"images too small: {h}x{w} (need >= 32x32)")
        return imgs[..., :nh, :nw, :]

    def _tensor(self, x) -> torch.Tensor:
        """`x` copied to a new f32 host array (span `.prepare`), then
        uploaded (span `.upload`)."""
        with span(f"{SPAN}.prepare"):
            a = np.array(x, np.float32)
        with span(f"{SPAN}.upload"):
            return torch.as_tensor(a, device=self.device)

    def __call__(self, imgs, K, R, t, depth_min, depth_max,
                 reference_frame: int = 0) -> dict:
        """imgs [N, H, W, 3] or [B, N, H, W, 3] float in [0, 1], or a list
        of per-view [Hi, Wi, 3] / [B, Hi, Wi, 3] arrays of different sizes
        (each cropped on its own); K/R [., N, 3, 3], t [., N, 3, 1],
        depth_min/max [., N] or scalars. Returns numpy f32 {depth,
        confidence} (vis_mvsnet: one confidence per stage, [3, h, w]),
        without the batch axis when the input had none.

        Under a profiler a call records the span
        `wildmvs_torch.Predictor.request` and, inside it, `.prepare` (the
        views' stack and crop, then each f32 copy made for an upload),
        `.upload` (each copy's upload), `.forward` and `.fetch`."""
        with span(f"{SPAN}.request"):
            with span(f"{SPAN}.prepare"):
                ragged = (isinstance(imgs, (list, tuple))
                          and len({tuple(np.asarray(v).shape[-3:-1])
                                   for v in imgs}) > 1)
                if ragged:
                    views = [np.asarray(v, np.float32) for v in imgs]
                    batched = views[0].ndim == 4
                    views = [self._crop32(v if batched else v[None])
                             for v in views]
                    n, nb = len(views), views[0].shape[0]
                else:
                    if isinstance(imgs, (list, tuple)):
                        imgs = np.stack([np.asarray(v) for v in imgs],
                                        axis=1 if np.asarray(imgs[0]).ndim
                                        == 4 else 0)
                    imgs = np.asarray(imgs, np.float32)
                    batched = imgs.ndim == 5
                    imgs = self._crop32(imgs if batched else imgs[None])
                    nb, n = imgs.shape[:2]
            x = ([self._tensor(v) for v in views] if ragged
                 else self._tensor(imgs))

            def prep(a):                 # [., N, r, c] -> [B, N, r, c]
                a = np.asarray(a, np.float32)
                while a.ndim < 4:
                    a = a[None]
                return self._tensor(a)

            def prep_range(a):
                a = np.asarray(a, np.float32)
                if a.ndim < 2:
                    a = np.broadcast_to(a, (nb, n))
                return self._tensor(a)

            with torch.inference_mode(), use_mesh(self.mesh):
                cams = [prep(K), prep(R), prep(t), prep_range(depth_min),
                        prep_range(depth_max)]
                with span(f"{SPAN}.forward"):
                    out = self.model(x, *cams,
                                     reference_frame=reference_frame,
                                     **self.forward_kwargs)
                with span(f"{SPAN}.fetch"):
                    depth = out["depth"].float().cpu().numpy()
                    conf = out["photometric_confidence"].float().cpu().numpy()
        if not batched:
            depth, conf = depth[0], conf[0]
        return {"depth": depth, "confidence": conf}
