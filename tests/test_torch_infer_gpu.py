"""Predictor's input staging on the card: pinned host buffers that
PyTorch's caching host allocator hands the next request of the same size
again, results bit-identical to a fresh Predictor's and to the model
fed the unstaged uploads, and a request that raises inside the forward
leaving the next one correct; a 1184x1600 N5 request's views copied by
the copy team, bit-identical to the unstaged upload.

Imports neither jax nor the JAX package, so it runs on the card without
the repo's test configuration:
`python -m pytest tests/test_torch_infer_gpu.py -q -m gpu -p no:cacheprovider --noconftest`.
"""
import numpy as np
import pytest
import torch

from wildmvs_torch.bench import scene_dtu
from wildmvs_torch.infer import Predictor, staging_stats


def requests():
    """Three requests on a DTU-like rig at 256x320: views 0-4, views 1-5
    with other images (reversed rows, a view torch cannot wrap), and a
    ragged one."""
    imgs, K, R, t, dmin, dmax = (a.numpy() for a in
                                 scene_dtu(1, 6, 256, 320, 625.3))
    imgs, K, R, t, dmin, dmax = imgs[0], K[0], R[0], t[0], dmin[0], dmax[0]
    first = (imgs[:5], K[:5], R[:5], t[:5], dmin[:5], dmax[:5])
    second = (imgs[1:, ::-1], K[1:], R[1:], t[1:], dmin[1:], dmax[1:])
    ragged = ([imgs[0], imgs[1, :, :300], imgs[2, :250]], K[:3], R[:3],
              t[:3], dmin[:3], dmax[:3])
    return first, second, ragged


def assert_same(got, want):
    for key in ("depth", "confidence"):
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.gpu
def test_staged_requests_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: staging engages on the card only")
    reqs = requests()
    pred = Predictor(architecture="mvsnet")
    stats = [torch.cuda.host_memory_stats()]
    outs = []
    for r in reqs:
        outs.append(pred(*r))
        stats.append(torch.cuda.host_memory_stats())
    handed = [b["active_bytes.allocated"] - a["active_bytes.allocated"]
              for a, b in zip(stats, stats[1:])]
    grown = [b["num_host_alloc"] - a["num_host_alloc"]
             for a, b in zip(stats, stats[1:])]
    # every request's images went through pinned blocks
    assert handed[0] >= 4 * 5 * 256 * 320 * 3, handed
    assert handed[2] >= 4 * 3 * (256 * 320 + 256 * 288 + 224 * 320), handed
    # the second request, of the first's sizes, reused its freed blocks
    assert grown[1] == 0, grown
    # each as a fresh Predictor (same seeded weights) serves it
    for r, out in zip(reqs, outs):
        assert_same(out, Predictor(architecture="mvsnet")(*r))
    # and as the model serves the parent's pageable uploads
    x = torch.as_tensor(np.array(reqs[1][0], np.float32)[None],
                        device="cuda")
    cams = [torch.as_tensor(np.array(a, np.float32)[None], device="cuda")
            for a in reqs[1][1:]]
    with torch.inference_mode():
        depth = pred.model(x, *cams)["depth"].float().cpu().numpy()[0]
    np.testing.assert_array_equal(outs[1]["depth"], depth)

    def boom(*args, **kwargs):
        raise RuntimeError("planted")

    pred.model.forward = boom
    with pytest.raises(RuntimeError, match="planted"):
        pred(*reqs[0])
    del pred.model.forward
    assert_same(pred(*reqs[1]), outs[1])
    assert_same(pred(*reqs[0]), outs[0])


@pytest.mark.gpu
def test_a_dtu_request_goes_through_the_copy_team():
    """The 1184x1600 N5 views (22.7 MB each) are copied by the team, the
    depth equals the model's on the unstaged pageable upload, and a second
    request of that size takes no new pinned block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: staging engages on the card only")
    req = tuple(a.numpy()[0] for a in scene_dtu(1, 5, 1184, 1600, 2892.0))
    pred = Predictor(architecture="mvsnet")
    before = staging_stats()
    out = pred(*req)
    after = staging_stats()
    alloc = torch.cuda.host_memory_stats()["num_host_alloc"]
    assert after["team_requests"] == before["team_requests"] + 1
    assert after["worker_chunks"] > before["worker_chunks"], (before, after)
    assert_same(pred(*req), out)
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == alloc
    x = torch.as_tensor(np.array(req[0], np.float32)[None], device="cuda")
    cams = [torch.as_tensor(np.array(a, np.float32)[None], device="cuda")
            for a in req[1:]]
    with torch.inference_mode():
        depth = pred.model(x, *cams)["depth"].float().cpu().numpy()[0]
    np.testing.assert_array_equal(out["depth"], depth)
