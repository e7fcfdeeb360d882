#!/usr/bin/env python3
"""Parent against change on one CUDA card, in one call.

    python3 chip_ab.py PARENT CHANGE [--out DIR]

PARENT and CHANGE are directories that each hold a checkout of the repo
(for example unpacked with `git archive`). In the order parent, change,
change, parent it runs `python3 chip_smoke.py` from each tree; then, in the
same order, times `fused_cost_volume` of each tree at 2 to 16 source views
(`--views TREE`: the headline's 128x160 features, C=32, D=192, the DTU-like
rig of that tree's chip_smoke.py grown by 6-degree steps), and
`sweep_warp` and `sweep_warp_backward` of each tree at the training shapes
(`--train TREE`: the MVSNet headline, 128x160 C32 D192 [D], and the
Vis-MVSNet training stages 1-3, 64x80 D32 [D], 128x160 D16 [D,H,W] and
256x320 D8 [D,H,W], from that tree's chip_smoke.py); each by CUDA-graph
replay. Each run's output goes to DIR (`--out`). Prints the card's
name and power limit, each run's exit code, and one table of every
time and staged share the runs reported (from the `kernels`, serving, eval
and training JSON of chip_smoke.py, and the view and training-kernel
timings), one column a run. Exits 1 if any run failed.
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ORDER = (("parent", "p1"), ("change", "c1"), ("change", "c2"),
         ("parent", "p2"))
VIEWS = (2, 4, 6, 8, 12, 16)


def time_views(tree: str) -> None:
    """Print {"views_ms": {NV: ms}} for the fused kernel of `tree`."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import chip_smoke as cs
    from wildmvs_torch.ops import sweep_kernels as sk
    dev = torch.device("cuda")
    times = {}
    for nv in VIEWS:
        ref, srcs, P, Q, s, *_ = cs.kernel_inputs(dict(cs.HEADLINE, n=nv + 1),
                                                  dev)
        args = (ref, srcs, P, Q, s, None, "variance")
        times[str(nv)] = cs.graph_ms(lambda: sk.fused_cost_volume(*args))
        del ref, srcs, P, Q, s, args
        torch.cuda.empty_cache()
    print(json.dumps({"views_ms": times}), flush=True)


def time_training(tree: str) -> None:
    """Print {"train_ms": {name: ms}} for the warp and its backward of
    `tree` at the MVSNet headline and the three Vis training stages."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import chip_smoke as cs
    from wildmvs_torch.ops import sweep_kernels as sk
    dev = torch.device("cuda")
    _, srcs, P, Q, s, *_ = cs.kernel_inputs(cs.HEADLINE, dev)
    sweeps = {"headline 128x160 D192 [D]": (
        srcs[:, 0].contiguous(), P[:, 0].contiguous(), Q[:, 0].contiguous(),
        s, sk.UNIT_SCALE, None)}
    tr = dict(n=3, h=cs.HEADLINE["h"], w=cs.HEADLINE["w"], f=cs.HEADLINE["f"])
    for stage, D, per_pixel in ((1, 32, False), (2, 16, True), (3, 8, True)):
        src, _, P, Q, s, scale, clamp = cs.vis_kernel_inputs(
            dev, tr, stage, D, per_pixel)
        H, W = P.shape[-2:]
        sweeps[f"Vis stage {stage} {H}x{W} D{D}"] = (src, P, Q, s, scale,
                                                     clamp)
    times = {}
    for name, (src, P, Q, s, scale, clamp) in sweeps.items():
        out = sk.sweep_warp(src, P, Q, s, scale, clamp)
        g = torch.randn(out.shape, device=dev, generator=torch.Generator(
            dev).manual_seed(3)).to(torch.bfloat16)
        hw = tuple(src.shape[1:3])
        times[f"sweep_warp {name}"] = cs.graph_ms(
            lambda: sk.sweep_warp(src, P, Q, s, scale, clamp))
        times[f"sweep_warp_backward {name}"] = cs.graph_ms(
            lambda: sk.sweep_warp_backward(g, P, Q, s, hw, scale=scale,
                                           clamp=clamp))
    print(json.dumps({"train_ms": times}), flush=True)


def times_of(obj, prefix: str, out: dict) -> None:
    """Every number in obj under a key with an "ms" word (ms,
    request_ms_median, ...) or a staged share, by dotted path."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            path = f"{prefix}.{k}" if prefix else str(k)
            if (isinstance(v, (int, float))
                    and re.search(r"(^|_)ms($|_)|share", str(k))):
                out[path] = v
            else:
                times_of(v, path, out)


def summary(text: str) -> dict:
    """The times of one run's output: chip_smoke.py's JSON line before the
    last, or the view timings."""
    out = {}
    for line in text.splitlines():
        if line.startswith('{"kernels"'):
            doc = json.loads(line)
            for k in doc.pop("kernels"):
                times_of(k, k["name"], out)
            times_of(doc, "", out)
        elif line.startswith('{"views_ms"'):
            for nv, ms in json.loads(line)["views_ms"].items():
                out[f"fused_cost_volume NV={nv}"] = ms
        elif line.startswith('{"train_ms"'):
            out.update(json.loads(line)["train_ms"])
    return out


def run(cmd, cwd, log: Path, timeout: int) -> tuple[int, str]:
    try:
        p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                           timeout=timeout)
        rc, text = p.returncode, p.stdout + p.stderr
    except subprocess.TimeoutExpired as e:
        rc = 124
        text = "".join(x.decode() if isinstance(x, bytes) else x or ""
                       for x in (e.stdout, e.stderr))
    log.write_text(text)
    return rc, text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", metavar="TREE")
    ap.add_argument("--views", metavar="TREE",
                    help="time the fused kernel of TREE at 2-16 views")
    ap.add_argument("--train", metavar="TREE",
                    help="time the warp and its backward of TREE at the "
                    "training shapes")
    ap.add_argument("--out", default="chiprun_out/ab")
    args = ap.parse_args()
    if args.views:
        time_views(args.views)
        return 0
    if args.train:
        time_training(args.train)
        return 0
    if len(args.trees) != 2:
        ap.error("give PARENT and CHANGE")
    trees = dict(zip(("parent", "change"), args.trees))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    cols, failed = {}, False
    for phase, cmd, timeout in (
            ("smoke", ["chip_smoke.py"], 1200),
            ("views", [str(Path(__file__).resolve()), "--views"], 600),
            ("train", [str(Path(__file__).resolve()), "--train"], 600)):
        for tree, name in ORDER:
            cwd = Path(trees[tree]).resolve()
            argv = [sys.executable, *cmd] + ([] if phase == "smoke"
                                             else [str(cwd)])
            rc, text = run(argv, cwd, out / f"{phase}-{name}.txt", timeout)
            print(f"{phase} {name} ({tree}): rc {rc}", flush=True)
            failed |= rc != 0
            cols.setdefault(name, {}).update(summary(text))
    keys = sorted({k for c in cols.values() for k in c})
    names = [n for _, n in ORDER]
    print("ms or share | " + " | ".join(names))
    for k in keys:
        print(f"{k} | " + " | ".join(
            f"{cols[n][k]:.4f}" if k in cols[n] else "-" for n in names))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
