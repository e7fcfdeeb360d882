"""A serving cell: one client in a closed loop of `Predictor` requests.

Set-up makes the images and weights from the seed, builds the predictor
with those weights and warms the cell's one request shape. The window
sends one request after another, each a reference camera (in the seed's
order) with its N - 1 nearest, and times each from the call into
`Predictor` to the numpy arrays it returns. A traced run profiles
`trace_units` requests inside the window. The outputs of a sample of the
finished requests, `check_requests` of them drawn from the seed, are
kept (a reservoir: uniform over all that finish, whatever their number,
and no other output held); after the window they are run through the
plain reference (see check.py).
"""
from __future__ import annotations

import contextlib
import math
import sys
import time
import traceback

import numpy as np
import torch

from . import check, traffic, work
from .trace import span
from .reference.common import crop32, f32_flags, fp8_control


#: the camera whose request sets the BatchNorm statistics (the grid's centre)
PROBE_CAMERA = 24


class Capture:
    """Forward hooks on the program's modules, kept for each request as
    device tensors, one a call in call order, cleared by `reset` at the
    start of a request: the stage depths (`stage_modules`, output[0]) and
    the score volumes (`score_modules`, the output of batch 0, without its
    trailing channel axis unless the configuration's `score_channel_axis`
    is false); and, only while `timing_regularizers` is entered, CUDA
    events around each call of the `regularizer_modules`."""

    def __init__(self, model, stage_modules, score_modules,
                 regularizer_modules, score_channel_axis: bool = True):
        self.mods = dict(model.named_modules())
        self.calls = {}
        self.events = []
        self.timing = False
        self.stage_modules = list(stage_modules)
        self.score_modules = list(score_modules)
        self.regularizer_modules = list(regularizer_modules)
        self.handles = [self.mods[name].register_forward_hook(
            lambda _m, _a, out, name=name: self._keep(name, out[0]))
            for name in self.stage_modules]
        self.handles += [self.mods[name].register_forward_hook(
            lambda _m, _a, out, name=name: self._keep(
                name, out[0, ..., 0] if score_channel_axis else out[0]))
            for name in self.score_modules]

    def _keep(self, name: str, value):
        self.calls.setdefault(name, []).append(value)

    def reset(self):
        self.calls = {}

    def _mark(self, start: bool):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if start:
            self.events.append([ev, None])
        else:
            self.events[-1][1] = ev

    @contextlib.contextmanager
    def timing_regularizers(self):
        on_card = torch.cuda.is_available()
        hooks = []
        for name in self.regularizer_modules if on_card else ():
            hooks.append(self.mods[name].register_forward_pre_hook(
                lambda _m, _a: self._mark(True)))
            hooks.append(self.mods[name].register_forward_hook(
                lambda _m, _a, _o: self._mark(False)))
        self.timing = True
        try:
            yield
        finally:
            self.timing = False
            for h in hooks:
                h.remove()

    def _kept(self, names) -> list:
        return [v for n in names for v in self.calls[n]]

    def stages(self) -> list:
        return self._kept(self.stage_modules)

    def scores(self) -> list:
        """Each score module's volumes in call order, the modules in the
        configuration's order: one a stage."""
        return self._kept(self.score_modules)

    def regularizer_s(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events) * 1e-3

    def remove(self):
        for h in self.handles:
            h.remove()
        self.calls = {}


def request_tensors(req: dict, device) -> dict:
    """A request as the reference takes it: batched f32 tensors, the
    images cropped as the program crops them."""
    x = {"imgs": crop32(torch.as_tensor(np.stack(req["imgs"]))[None])}
    for k in ("K", "R", "t", "depth_min", "depth_max"):
        x[k] = torch.as_tensor(req[k])[None]
    return {k: v.to(device) for k, v in x.items()}


class ServeCell:
    def __init__(self, cell: dict, cfg: dict, ref_mod, seed: int, device):
        from wildmvs_torch.infer import Predictor

        from .weights import cell_weights

        self.cell, self.cfg, self.ref_mod = cell, cfg, ref_mod
        self.seed, self.device = seed, device
        h, w, self.n = cell["height"], cell["width"], cell["views"]
        self.rig = traffic.dtu_rig(cell["rig"], h, w)
        self.imgs = traffic.images(seed, self.rig.cameras, h, w, device)
        probe = traffic.request(self.rig, self.imgs, PROBE_CAMERA, self.n)
        self.state, self.reference_s = cell_weights(
            ref_mod, cfg, seed, device, request_tensors(probe, device))
        self.pred = Predictor(architecture=cfg["architecture"],
                              device=device, **cfg.get("predictor", {}))
        self.pred.model.load_state_dict(self.state)
        self.capture = Capture(self.pred.model, cfg["stage_modules"],
                               cfg["score_modules"],
                               cfg["regularizer_modules"],
                               cfg.get("score_channel_axis", True))
        self.order = traffic.request_order(seed, self.rig.cameras)
        self.latency = []          # s a request of the window, inf: failed
        self.views = []            # the cameras of each request
        self.kept = []             # (request index, output) of the sample
        self.finished = 0
        self.draw = np.random.default_rng([seed, 1])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def one(self, keep: bool = True):
        """One request of the loop; with `keep` it counts, and its output
        may enter the sample."""
        req = traffic.request(self.rig, self.imgs, next(self.order), self.n)
        self.capture.reset()
        t0 = time.perf_counter()
        try:
            with span("Predictor.__call__", self.capture.timing):
                out = self.pred(req["imgs"], req["K"], req["R"], req["t"],
                                req["depth_min"], req["depth_max"])
            out["stages"] = self.capture.stages()
            out["scores"] = self.capture.scores()
            dt = time.perf_counter() - t0
        except Exception:                   # a failed request, counted
            traceback.print_exc(file=sys.stderr)
            out, dt = None, math.inf
        if keep:
            self.latency.append(dt)
            self.views.append(req["views"])
            if out is not None:
                self._sample(len(self.latency) - 1, out)

    def _sample(self, index: int, out: dict):
        """Reservoir sampling (Algorithm R) of the finished requests."""
        k, i = self.cell["check_requests"], self.finished
        self.finished += 1
        if i < k:
            self.kept.append((index, out))
            return
        j = int(self.draw.integers(0, i + 1))
        if j < k:
            self.kept[j] = (index, out)

    def warm(self):
        for _ in range(self.cell["warmup_requests"]):
            self.one(keep=False)
        self.sync()

    def window(self, seconds: float, trace_units: int):
        """Requests until `seconds` have passed; returns (window_s, the
        Trace of the profiled requests or None)."""
        from .trace import profile

        tr = None
        t_start = time.perf_counter()
        while True:
            if trace_units and tr is None and len(self.latency) >= 2:
                first = len(self.latency)
                with self.capture.timing_regularizers():
                    tr = profile(lambda: [self.one() for _ in
                                          range(trace_units)],
                                 trace_units, self.sync)
                tr.regularizer_s = self.capture.regularizer_s()
                self.traced = self.views[first:first + trace_units]
            else:
                self.one()
            if time.perf_counter() - t_start >= seconds:
                break
        return time.perf_counter() - t_start, tr

    def latencies(self) -> list:
        return list(self.latency)

    def free_program(self):
        self.capture.remove()
        del self.pred, self.capture

    # -- after the window --------------------------------------------------

    def trace_extras(self, tr):
        """The flops of one request by the reference on the meta device,
        and the sweep kernels' bound over the traced requests."""
        meta = request_tensors(traffic.request(
            self.rig, self.imgs, PROBE_CAMERA, self.n), torch.device("meta"))
        with torch.device("meta"):
            model = self.ref_mod.build(self.cfg).eval()
        with torch.no_grad():
            tr.flops_per_unit = work.count_flops(lambda: model(
                meta["imgs"], meta["K"], meta["R"], meta["t"],
                meta["depth_min"], meta["depth_max"]))
        totals = {}
        for views in self.traced:
            req = traffic.request(self.rig, self.imgs, views[0], self.n)
            x = request_tensors(req, self.device)
            for name, job in self.ref_mod.serve_jobs(self.cfg, x).items():
                totals[name] = totals.get(name, 0.0) + job.bound_s()
        tr.jobs = totals

    def reference_model(self, control: bool = False):
        """The f32 reference with the cell's weights; with `control`, the
        lower-precision control: its convolutions in fp8
        (`fp8_control`), its soft-argmin in bf16, each the precision
        below what the configuration states for that part."""
        with torch.device(self.device):
            model = self.ref_mod.build(self.cfg)
        model.load_state_dict(self.state)
        model.eval()
        if not control:
            return model
        model = fp8_control(model)
        model.regress_dtype = torch.bfloat16
        return model

    def program_output(self, x: dict, out: dict) -> dict:
        """The program's output of one request as the check reads it: the
        stage depths (numpy, the last the returned depth), the confidence
        and the score volumes. A cascade whose configuration hooks no stage
        module takes each earlier stage's depth from the reference's f32
        regression of its own score volumes (`stage_depths`)."""
        stages = [s[0].float().cpu().numpy() for s in out["stages"]]
        if not stages and len(out["scores"]) > 1:
            stages = self.ref_mod.stage_depths(self.cfg, x,
                                               out["scores"])[:-1]
        return {"depths": stages + [out["depth"]],
                "confidence": out["confidence"], "scores": out["scores"]}

    def numbers(self, control: bool = False) -> dict:
        """The check's numbers over the sampled requests: the program's
        outputs against the reference's; with `control` the control
        stands in for the program on the same requests."""
        lo, hi = self.rig.depth_range
        with f32_flags():
            ref = self.reference_model()
            ctl = self.reference_model(control=True) if control else None
            triples = []
            for index, out in sorted(self.kept, key=lambda r: r[0]):
                req = traffic.request(self.rig, self.imgs,
                                      self.views[index][0], self.n)
                x = request_tensors(req, self.device)
                prog = (self.program_output(x, out) if ctl is None
                        else self.ref_mod.serve(ctl, x))
                centres = prog["depths"][:-1]
                triples.append((
                    prog, self.ref_mod.serve(ref, x, centres=centres or None),
                    self.ref_mod.regress_scores(self.cfg, x, prog["scores"],
                                                centres)))
        return check.serve_numbers(triples,
                                   self.ref_mod.intervals(self.cfg, lo, hi))
