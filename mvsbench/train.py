"""A training cell: `train_step` over a seeded pool of samples, batch 1,
the batch copied from host numpy each step and the loss read on the host
every step, as the port's CLI does.

Set-up builds one training state from the seeded weights and drives it
through its first three steps on three different samples, through the
window's own call and feed; those steps are the warm-up and the ones the
reference follows (check.py). The window continues the same state
through the pool.
"""
from __future__ import annotations

import sys
import time
import traceback

import torch

from . import check, traffic, work
from .trace import span
from .reference.common import Adam, f32_flags, fp8_control, plain_name

CHECKED_STEPS = 3


def sample_tensors(sample: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in sample.items()}


class TrainCell:
    def __init__(self, cell: dict, cfg: dict, ref_mod, seed: int, device):
        from wildmvs_torch.train.config import TrainConfig
        from wildmvs_torch.train.trainer import (batch_to_device,
                                                 create_model,
                                                 create_train_state)

        from .weights import cell_weights

        self.cell, self.cfg, self.ref_mod = cell, cfg, ref_mod
        self.seed, self.device = seed, device
        h, w = cell["height"], cell["width"]
        rig = traffic.dtu_rig(cell["rig"], h, w)
        imgs = traffic.images(seed, rig.cameras, h, w, device)
        self.pool = traffic.training_pool(seed, rig, imgs, cell)
        self.state0, self.reference_s = cell_weights(
            ref_mod, cfg, seed, device, sample_tensors(self.pool[0], device))
        self.config = TrainConfig(
            architecture=cfg["architecture"], num_depth=cfg["num_depth"],
            train_dtype=cfg["train_dtype"], lr=cfg["lr"], batch_size=1,
            num_im_train=cell["views"])
        model = create_model(self.config, device)
        model.load_state_dict(self.state0)
        self.state = create_train_state(self.config, device, model=model)
        self._feed = batch_to_device
        self.steps = 0
        self.losses = []
        self.tracing = False

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def step(self):
        """One optimizer step on the next sample of the pool; the loss is
        read on the host."""
        from wildmvs_torch.train.trainer import train_step

        with span("batch_to_device", self.tracing):
            batch = self._feed(self.pool[self.steps % len(self.pool)],
                               self.device)
        with span("train_step", self.tracing):
            self.state, out = train_step(self.state, batch, self.config)
        with span("loss.item", self.tracing):
            self.losses.append(float(out["train_loss"].item()))
        self.steps += 1
        return out

    def warm(self):
        """The first three steps, with what the check compares: the
        losses, the first gradient from Adam's first moment after step 1,
        the parameters' change after step 3."""
        model, opt = self.state.model, self.state.optimizer
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        beta1 = opt.param_groups[0]["betas"][0]
        for i in range(CHECKED_STEPS):
            out = self.step()
            if i == 0:
                self.depth1 = out["depth_est"][0].float().cpu().numpy()
                # a leaf that Adam holds no moment for has not moved
                self.grad1 = {n: opt.state[p]["exp_avg"] / (1 - beta1)
                              if "exp_avg" in opt.state.get(p, {})
                              else torch.zeros_like(p)
                              for n, p in model.named_parameters()}
        self.change = {n: p.detach() - p0[n]
                       for n, p in model.named_parameters()}
        self.checked_losses = list(self.losses)
        self.sync()

    def window(self, seconds: float, trace_units: int):
        from .trace import profile

        tr, failed, attempted = None, 0, 0
        first = self.steps
        t_start = time.perf_counter()
        while True:
            attempted += 1
            try:
                if trace_units and tr is None and attempted > 2:
                    attempted += trace_units - 1
                    self.traced_from = self.steps
                    self.tracing = True
                    tr = profile(lambda: [self.step() for _ in
                                          range(trace_units)],
                                 trace_units, self.sync)
                    self.tracing = False
                else:
                    self.step()
            except Exception:               # a failed step, counted
                traceback.print_exc(file=sys.stderr)
                failed += 1
            if time.perf_counter() - t_start >= seconds:
                break
        self.attempted, self.failed = attempted, failed
        self.done = self.steps - first
        return time.perf_counter() - t_start, tr

    def free_program(self):
        del self.state

    # -- after the window --------------------------------------------------

    def trace_extras(self, tr):
        """The flops of one step (forward and backward) by the reference on
        the meta device, and the sweep kernels' bound over the traced
        steps (the pool's samples in order)."""
        with torch.device("meta"):
            model = self.ref_mod.build(self.cfg).train()
        meta = {k: torch.empty(v.shape, device="meta")
                for k, v in self.pool[0].items()}
        tr.flops_per_unit = work.count_flops(
            lambda: self.ref_mod.loss(model, meta)[0].backward())
        totals = {}
        for i in range(tr.units):
            x = sample_tensors(self.pool[(self.traced_from + i)
                                         % len(self.pool)], self.device)
            for name, job in self.ref_mod.train_jobs(self.cfg, x).items():
                totals[name] = totals.get(name, 0.0) + job.bound_s()
        tr.jobs = totals

    def reference_steps(self, control: bool = False):
        """The reference (or its fp8 control) through the checked steps
        from the same weights on the same samples: (losses, first
        gradient, change), leaves by name."""
        with torch.device(self.device):
            model = self.ref_mod.build(self.cfg)
        model.load_state_dict(self.state0)
        model.train()
        if control:
            model = fp8_control(model)
        named = [(plain_name(n), p) for n, p in model.named_parameters()]
        p0 = {n: p.detach().clone() for n, p in named}
        opt = Adam([p for _, p in named], lr=self.cfg["lr"])
        losses, grad1, depth1 = [], None, None
        with f32_flags():
            for i in range(CHECKED_STEPS):
                for _, p in named:
                    p.grad = None
                x = sample_tensors(self.pool[i], self.device)
                loss, depth = self.ref_mod.loss(model, x)
                loss.backward()
                losses.append(float(loss.detach()))
                if i == 0:
                    depth1 = depth[0].detach().cpu().numpy()
                    grad1 = {n: p.grad.detach().clone() for n, p in named
                             if p.grad is not None}
                opt.step()
        change = {n: p.detach() - p0[n] for n, p in named}
        return losses, grad1, change, depth1

    def numbers(self, control: bool = False) -> dict:
        """The check's numbers: the program's three steps (with `control`
        the fp8 reference's) against the reference's."""
        ref = self.reference_steps()
        prog = (self.reference_steps(control=True) if control else
                (self.checked_losses, self.grad1, self.change, self.depth1))
        lo, hi = self.cell["rig"]["depth_range_mm"]
        itv = self.ref_mod.intervals(self.cfg, lo, hi)[0]
        return {**check.train_numbers(*prog[:3], *ref[:3]),
                **check.depth_numbers(prog[3], ref[3], itv)}
