"""The numbers that decide `correct`, and their limits.

Serving, for each sampled request. The reference follows the program's
cascade: it re-centres each stage after the first on the program's own
depth of the stage before (MVSNet has one stage). For each stage k:
  score_err        the program's score volume (the output of the last
                   3D regularizer, read by a forward hook in the timed
                   request) against the reference's: the RMS of their
                   difference over the reference's RMS, each centred
                   over the hypotheses at every pixel (the softmax sees
                   nothing else); worst stage and request
  depth_regress_itv  the mean |depth - d| over every pixel, in the
                   stage's hypothesis interval, where d is what the
                   reference's f32 soft-argmin makes of the program's
                   own score volume; worst stage and request
  conf_regress_abs the mean |confidence - c| over every returned
                   confidence map, c likewise; worst request
  depth_median_itv, depth_mean_itv, depth_p99_itv  the median, mean and
                   99th percentile of |depth - reference depth| / the
                   stage's interval, every pixel; worst stage and request
  conf_mean_abs    the mean |confidence - reference confidence|
  *_stage<k>       with several stages, each stage's numbers alone
A stage's interval is the reference's `intervals(cfg, lo, hi)`, or, where
the reference's `serve` returns them, the request's own (CVP-MVSNet's
refinement steps follow each request's cameras and coarser depth).
Training (the first three steps, the reference following them):
  depth_mean_itv,  of the first step's training forward's depth, as
  depth_p99_itv    above
  loss_gap         max over the steps of |loss - reference| / |reference|
  grad_gap         worst leaf of | |g1| - |g1 ref| | / max(|g1 ref|,
                   the median leaf's |g1 ref|), g1 the first gradient as
                   Adam's first moment holds it after step 1;
                   grad_gap_median the median leaf's
  change_gap       the same for the parameters' change over three steps,
                   leaving out leaves whose reference gradient is under a
                   thousandth of the median leaf's (they move by
                   round-off alone); change_gap_median the median leaf's
A non-finite output reads inf. The numbers that the workload file's
`limits` name are compared: each passes when it is at most its limit.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _finite_or_inf(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def score_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """RMS of (prog - ref) over the RMS of ref, both [D, H, W] and centred
    over D at every pixel."""
    p, r = prog.double(), ref.double()
    d = p - r
    d = d - d.mean(0)
    r = r - r.mean(0)
    return _finite_or_inf(float(torch.linalg.vector_norm(d)
                                / torch.linalg.vector_norm(r)))


def _max_into(out: dict, key: str, value: float):
    out[key] = max(out.get(key, 0.0), value)


def serve_numbers(triples: list, intervals: list) -> dict:
    """triples: (program, reference, regressed) per request. Each holds
    "depths" (a stage depth [h, w] numpy each) and "confidence" (numpy);
    program and reference "scores" too (a score volume [D, h, w] tensor
    each stage); regressed is the reference's regression of the
    program's scores. intervals: one a stage; a reference whose intervals
    depend on the request returns that request's own as its "intervals",
    which then take their place. With several stages, each stage's own
    numbers too (`_stage<k>`)."""
    stats = ("median", "mean", "p99")
    out = {}
    for prog, ref, own in triples:
        itvs = ref.get("intervals", intervals)
        staged = len(itvs) > 1
        for k, itv in enumerate(itvs, start=1):
            tag = f"_stage{k}" if staged else ""
            e = np.abs(np.asarray(prog["depths"][k - 1], np.float64)
                       - np.asarray(ref["depths"][k - 1], np.float64)) / itv
            vals = ((float(np.median(e)), float(e.mean()),
                     float(np.percentile(e, 99)))
                    if np.isfinite(e).all() else (math.inf,) * 3)
            g = np.abs(np.asarray(prog["depths"][k - 1], np.float64)
                       - np.asarray(own["depths"][k - 1], np.float64)) / itv
            named = dict(zip((f"depth_{s}_itv" for s in stats), vals))
            named["depth_regress_itv"] = _finite_or_inf(float(g.mean()))
            named["score_err"] = score_err(prog["scores"][k - 1],
                                           ref["scores"][k - 1])
            for key, v in named.items():
                _max_into(out, key, v)
                if staged:
                    _max_into(out, key + tag, v)
        conf = np.asarray(prog["confidence"], np.float64)
        for key, other in (("conf_mean_abs", ref), ("conf_regress_abs", own)):
            c = np.abs(conf - np.asarray(other["confidence"], np.float64))
            _max_into(out, key, _finite_or_inf(float(c.mean())))
    return out


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def _gaps(prog: dict, ref: dict, keys) -> list:
    """Each leaf's | |prog| - |ref| | over max(|ref|, the median leaf's)."""
    keys = list(keys)
    med = float(np.median([ref[k] for k in keys]))
    return [_finite_or_inf(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
            for k in keys]


def depth_numbers(depth_p, depth_r, interval: float) -> dict:
    """The first training step's depth [h, w] against the reference's."""
    e = np.abs(np.asarray(depth_p, np.float64)
               - np.asarray(depth_r, np.float64)) / interval
    if not np.isfinite(e).all():
        return {"depth_mean_itv": math.inf, "depth_p99_itv": math.inf}
    return {"depth_mean_itv": float(e.mean()),
            "depth_p99_itv": float(np.percentile(e, 99))}


def train_numbers(losses_p, grad_p, change_p, losses_r, grad_r,
                  change_r) -> dict:
    """Each of grad_*, change_* maps leaf name -> tensor. The worst leaf's
    gap and the median leaf's gap of each."""
    loss_gap = max(_finite_or_inf(abs(a - b) / abs(b))
                   for a, b in zip(losses_p, losses_r))
    gp, gr = _norms(grad_p), _norms(grad_r)
    cp, cr = _norms(change_p), _norms(change_r)
    med_g = float(np.median(list(gr.values())))
    moved = [k for k in gr if gr[k] >= 1e-3 * med_g]
    g, c = _gaps(gp, gr, gr), _gaps(cp, cr, moved)
    return {"loss_gap": loss_gap,
            "grad_gap": max(g), "grad_gap_median": float(np.median(g)),
            "change_gap": max(c), "change_gap_median": float(np.median(c))}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)


def report(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} in the order of `limits`."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
