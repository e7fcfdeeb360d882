"""Time Predictor's input staging (`infer._stage`) on the card, by view
size, copy-team size and chunk size: the host time until the last view's
upload is enqueued (when the forward may start) and until the uploads are
done, as median and p90 over requests drawn from a 49-image pool, the way
the serving cells draw them. Configurations of one team size take turns
request by request, so a drift of the host reaches them all alike.

    PYTHONPATH=. python tools/time_stage.py [--reps 60] [--out stage.jsonl]

Team size 0 is the calling thread alone (every view under the team's
threshold). Prints one JSON line a configuration, with the card's name
and power limit.
"""
import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from wildmvs_torch import infer
from wildmvs_torch.infer import Predictor, _stage

SIZES = [(3, 512, 640), (5, 512, 640), (5, 640, 800), (5, 768, 1024),
         (5, 864, 1152), (5, 1184, 1600)]
TEAMS = [0, 1, 2, 3, 4, 5, 6]
CHUNK_MB = [1, 2, 4]
POOL = 49


def request(pool: list, n: int, r: int) -> tuple:
    views = [pool[(7 * r + j) % len(pool)] for j in range(n)]
    v, ragged, _ = Predictor._views(views)
    eye = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    cams = Predictor._cams(eye, eye, np.zeros((n, 3, 1), np.float32), 1.0,
                           2.0, 1, n)
    return v, ragged, cams


def timed(pool, n, r, dev) -> tuple:
    v, ragged, cams = request(pool, n, r)
    t0 = time.perf_counter()
    _stage(v, ragged, cams, dev)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=60)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cores = len(os.sched_getaffinity(0))
    rng = np.random.default_rng(0)
    pools = {hw: [rng.random(hw + (3,), dtype=np.float32)
                  for _ in range(POOL)]
             for hw in {s[1:] for s in SIZES}}
    lines = []
    for team in TEAMS:
        infer._team_workers = lambda team=team: team
        infer._TEAM_MIN_BYTES = 0 if team else 1 << 62
        configs = [(s, c) for s in SIZES for c in (CHUNK_MB if team else [0])]
        times = {k: [] for k in configs}
        for r in range(args.reps + 5):
            for (n, h, w), c in configs:
                infer._CHUNK_BYTES = max(c, 1) << 20
                got = timed(pools[(h, w)], n, r, dev)
                if r >= 5:
                    times[((n, h, w), c)].append(got)
        for ((n, h, w), c), ts in times.items():
            ts = np.array(ts) * 1e3
            q = np.percentile(ts, [50, 90], axis=0)
            line = {"card": card, "cores": cores, "team": team,
                    "chunk_mb": c, "views": n, "hw": [h, w],
                    "view_mb": round(4 * h * w * 3 / 1e6, 2),
                    "enqueued_ms": [round(x, 3) for x in q[:, 0]],
                    "uploaded_ms": [round(x, 3) for x in q[:, 1]],
                    "requests": len(ts)}
            print(json.dumps(line), flush=True)
            lines.append(line)
    print(json.dumps({"stats": infer.staging_stats()}))
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)


if __name__ == "__main__":
    main()
