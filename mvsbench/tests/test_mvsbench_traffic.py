"""The traffic generator: the same for a seed, different across seeds,
the same work for every seed."""
import itertools

import numpy as np
import torch

from mvsbench import files, traffic

CPU = torch.device("cpu")


def rig(name="mvsnet_d192.serve_512x640_n3"):
    cell = files.workload(name)
    return cell, traffic.dtu_rig(cell["rig"], cell["height"], cell["width"])


def test_rig_shape_and_neighbours():
    cell, r = rig()
    assert r.cameras == 49
    centre_dist = np.linalg.norm(r.centres, axis=1)
    assert np.allclose(centre_dist, 650.0)
    # every camera looks at the centre: its z axis points at the origin
    for k in range(r.cameras):
        z = r.R[k][2]
        assert np.allclose(z, -r.centres[k] / 650.0, atol=1e-6)
        depth_of_centre = (r.R[k] @ np.zeros(3) + r.t[k][:, 0])[2]
        assert np.isclose(depth_of_centre, 650.0, atol=1e-3)
    views = r.views(24, 5)
    assert views[0] == 24 and len(set(views)) == 5
    d = np.linalg.norm(r.centres - r.centres[24], axis=1)
    assert max(d[views[1:]]) <= sorted(d)[4] + 1e-9


def test_images_same_seed_same_other_seed_different():
    a = traffic.images(2**31 + 77, 4, 32, 48, CPU)
    b = traffic.images(2**31 + 77, 4, 32, 48, CPU)
    c = traffic.images(2**31 + 78, 4, 32, 48, CPU)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].dtype == np.float32 and 0 <= a[0].min() and a[0].max() < 1


def test_request_order_is_a_seeded_permutation_of_all_cameras():
    first = list(itertools.islice(traffic.request_order(5, 49), 98))
    again = list(itertools.islice(traffic.request_order(5, 49), 98))
    other = list(itertools.islice(traffic.request_order(6, 49), 98))
    assert first == again and first != other
    # every seed serves the same requests, in another order
    assert sorted(first[:49]) == sorted(other[:49]) == list(range(49))
    assert sorted(first[49:]) == list(range(49))


def test_training_pool():
    cell, _ = rig("mvsnet_d192.train_512x640_n3")
    h, w = 64, 80
    r = traffic.dtu_rig(dict(cell["rig"], focal={"64x80": 144.6}), h, w)
    spec = dict(cell, height=h, width=w)
    imgs = traffic.images(3, r.cameras, h, w, CPU)
    a = traffic.training_pool(3, r, imgs, spec)
    b = traffic.training_pool(3, r, imgs, spec)
    c = traffic.training_pool(4, r, imgs, spec)
    assert len(a) == cell["pool"]
    assert all(np.array_equal(x["imgs"], y["imgs"]) for x, y in zip(a, b))
    refs = [int(np.where([np.array_equal(s["imgs"][0, 0], im)
                          for im in imgs])[0][0]) for s in a]
    refs_c = [int(np.where([np.array_equal(s["imgs"][0, 0], im)
                            for im in imgs])[0][0]) for s in c]
    assert len(set(refs)) == len(refs)            # rows that all differ
    assert sorted(refs) == sorted(refs_c) and refs != refs_c
    s = a[0]
    assert s["imgs"].shape == (1, 3, h, w, 3)
    assert s["depth"].shape == s["mask"].shape == (1, h // 4, w // 4)
    lo, hi = cell["rig"]["depth_range_mm"]
    assert lo < s["depth"].min() and s["depth"].max() < hi
    assert s["mask"].min() == 1.0
