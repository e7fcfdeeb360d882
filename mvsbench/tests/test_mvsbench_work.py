"""The benchmark's kernel work rules are the port's `sweep_kernels.*_work`
less what a smarter kernel need not do (the projection planes, a
per-pixel hypothesis volume, 20 operations a sample for its
coordinates), at the PERF.md kernel table's shapes; and the benchmark's
own geometry counts the same live samples as the port's."""
import pytest
import torch

from mvsbench import files, traffic, work
from mvsbench.reference import mvsnet as ref_mvsnet
from mvsbench.reference.common import (mvsnet_coords, projection,
                                       scale_intrinsics)
from wildmvs_torch.ops import sweep_kernels as sk

C = 32


def _rig_planes(h, w, nv, d, ref=24):
    """The port's MVSNet planes and hypotheses of the DTU rig at feature
    size (h, w), and the same cameras as the benchmark's tensors."""
    cell = files.workload("mvsnet_d192.serve_512x640_n3")
    r = traffic.dtu_rig(dict(cell["rig"], focal={f"{4 * h}x{4 * w}":
                                                 1156.8 * w / 160}),
                        4 * h, 4 * w)
    v = r.views(ref, nv + 1)
    K, R, t = (torch.as_tensor(a[v])[None] for a in (r.K, r.R, r.t))
    proj = projection(scale_intrinsics(K, 0.25), R, t)
    lo, hi = r.depth_range
    depth = ref_mvsnet.depth_values(d, torch.tensor([[lo]]),
                                    torch.tensor([[hi]]))
    planes = [sk.mvsnet_planes(proj[:, i], proj[:, 0], (h, w))
              for i in range(1, nv + 1)]
    return proj, depth, planes


@pytest.mark.parametrize("h,w,d", [(128, 160, 192), (32, 40, 48)])
def test_live_samples_agree_with_the_port(h, w, d):
    proj, depth, planes = _rig_planes(h, w, 2, d)
    for i, (P, Q) in enumerate(planes, start=1):
        x, y = mvsnet_coords(proj[:, i], proj[:, 0], depth, (h, w))
        mine = int(work.live_mask(x, y, h, w).sum())
        assert mine == sk.live_samples(P, Q, depth, h, w)


def test_warp_and_backward_rules_at_the_headline():
    h, w, d = 128, 160, 192
    _, depth, planes = _rig_planes(h, w, 1, d)
    P, Q = planes[0]
    src = torch.zeros(1, h, w, C, dtype=torch.bfloat16)
    n = d * h * w
    port = sk.warp_work(src, P, Q, depth)
    mine = work.warp_work(C, (h, w), (d, h, w), port.live_samples)
    assert mine.bytes + sk.nbytes(P, Q, depth) == port.bytes
    assert mine.operations + n * 20 == port.operations
    g = torch.zeros(1, d, h, w, C, dtype=torch.bfloat16)
    port = sk.warp_backward_work(g, P, Q, depth, (h, w))
    mine = work.warp_backward_work(C, (h, w), (d, h, w), port.live_samples)
    assert mine.bytes + sk.nbytes(P, Q, depth) == port.bytes
    assert mine.operations + n * 20 == port.operations


@pytest.mark.parametrize("nv", [2, 4])
def test_fused_rule(nv):
    h, w, d = 64, 80, 192
    _, depth, planes = _rig_planes(h, w, nv, d)
    P = torch.stack([p for p, _ in planes], 1)
    Q = torch.stack([q for _, q in planes], 1)
    ref = torch.zeros(1, h, w, C, dtype=torch.bfloat16)
    srcs = torch.zeros(1, nv, h, w, C, dtype=torch.bfloat16)
    port = sk.fused_work(ref, srcs, P, Q, depth)
    mine = work.fused_work(C, nv, (h, w), (d, h, w), port.live_samples)
    assert mine.bytes + sk.nbytes(P, Q, depth) == port.bytes
    assert mine.operations + nv * d * h * w * 20 == port.operations


@pytest.mark.parametrize("h,w,d", [(592, 800, 16), (148, 200, 64)])
def test_gwc_rule_at_the_vis_eval_stages(h, w, d):
    """Stage 3 (per-pixel hypotheses) and stage 1 of the 1184x1600 eval."""
    per_pixel = d == 16
    src = torch.zeros(1, h, w, C, dtype=torch.bfloat16)
    ref = torch.zeros_like(src)
    P = torch.zeros(1, 3, h, w)
    Q = torch.zeros(1, 3, h, w)
    Q[:, 0], Q[:, 1], Q[:, 2] = 10.0, 10.0, 1.0     # every sample live
    s = torch.ones((1, d, h, w) if per_pixel else (1, d))
    port = sk.gwc_work(src, ref, P, Q, s)
    n = d * h * w
    assert port.live_samples == n
    mine = work.gwc_work(C, (h, w), (d, h, w), n, per_pixel)
    start = h * w * 4 if per_pixel else 0
    assert mine.bytes - start + sk.nbytes(P, Q, s) == port.bytes
    assert mine.operations + n * 20 == port.operations
    # the bytes bind even with every sample live: liveness cannot move
    # the bound (vis_mvsnet.serve_jobs relies on it)
    assert (mine.bytes / work.HBM_BYTES_PER_S
            >= mine.operations / work.F32_FLOPS)


def test_peaks_are_the_ports():
    assert work.HBM_BYTES_PER_S == sk.HBM_BYTES_PER_S
    assert work.F32_FLOPS == sk.F32_FLOPS
