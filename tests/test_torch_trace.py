"""The port's trace spans (utils/monitor.span), on the CPU: no record
without a profiler, every span of a request and of a training step under
one, properly nested, each upload after its host copy, the same outputs
traced as untraced, and the regularizer spans holding exactly the
regularizer modules' calls."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from wildmvs_torch.data.synthetic import SyntheticMVSDataset, collate
from wildmvs_torch.infer import Predictor
from wildmvs_torch.train import trainer as T
from wildmvs_torch.train.config import TrainConfig
from wildmvs_torch.utils import monitor

torch.set_num_threads(1)

H, W, N = 64, 96, 3
P = "wildmvs_torch.Predictor."
REGULARIZERS = {
    "mvsnet": ["cost_regularization"],
    "vis_mvsnet": [f"stage{k}.{m}" for k in (1, 2, 3)
                   for m in ("reg", "reg_pair", "reg_fuse")],
}


def request(dtype=np.float32, seed=0):
    """A 3-view rig as the benchmark sends it: a list of views."""
    rng = np.random.default_rng(seed)
    imgs = [rng.random((H, W, 3)).astype(dtype) for _ in range(N)]
    K = np.tile(np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]],
                         dtype), (N, 1, 1))
    R = np.tile(np.eye(3, dtype=dtype), (N, 1, 1))
    t = np.zeros((N, 3, 1), dtype)
    t[:, 0, 0] = 0.4 * (np.arange(N) - 1)
    return imgs, K, R, t, np.full(N, 5.0, dtype), np.full(N, 10.0, dtype)


@pytest.fixture(scope="module")
def predictors():
    return {a: Predictor(architecture=a, device="cpu", bf16=False)
            for a in REGULARIZERS}


def ranges(prof, prefix=""):
    """(start, end, name) of the profiler's events named `prefix`..."""
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.name.startswith(prefix)]


def parent(span, spans):
    """The name of the innermost other span containing `span`, or None."""
    a, b, _ = span
    outer = [s for s in spans if s is not span and s[0] <= a and b <= s[1]]
    return min(outer, key=lambda s: s[1] - s[0])[2] if outer else None


def test_span_records_nothing_without_a_profiler(monkeypatch, predictors):
    def refuse(*_a, **_k):
        raise AssertionError("record_function made without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with monitor.span("wildmvs_torch.test"):
        pass
    assert monitor.span("a") is monitor.span("b")
    predictors["mvsnet"](*request())
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="without a profiler"):
            monitor.span("wildmvs_torch.test")


@pytest.mark.parametrize("arch", ["mvsnet", "vis_mvsnet"])
def test_request_spans_nest(arch, predictors):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = predictors[arch](*request())
    down = predictors[arch].downscale
    assert out["depth"].shape == (H // down, W // down)
    spans = ranges(prof, "wildmvs_torch.")
    names = [s[2] for s in spans]
    counts = {n: names.count(n) for n in set(names)}
    model = f"wildmvs_torch.{arch}."
    want = {P + "request": None, P + "prepare": P + "request",
            P + "upload": P + "request", P + "forward": P + "request",
            P + "fetch": P + "request", model + "features": P + "forward"}
    if arch == "mvsnet":
        want.update({model + p: P + "forward"
                     for p in ("sweep", "regularize", "regress")})
    else:
        want.update({f"{model}stage{k}.{p}": P + "forward"
                     for k in (1, 2, 3)
                     for p in ("sweep", "regularize", "fuse", "regress")})
    assert set(counts) == set(want)
    for s in spans:
        assert parent(s, spans) == want[s[2]], s[2]
    # one upload for the cameras and one for each view, each after its own
    # host copy, the crop one more `.prepare`
    assert counts[P + "upload"] == N + 1
    assert counts[P + "prepare"] == N + 2
    once = [n for n in want if not n.endswith((".prepare", ".upload"))]
    if arch == "mvsnet":
        assert all(counts[n] == 1 for n in once), counts
    else:
        assert all(counts[n] == 1 for n in once
                   if not n.startswith(model + "stage")), counts
        # a sweep a source pair; Reg and RegPair a pair, RegFuse once
        for k in (1, 2, 3):
            assert counts[f"{model}stage{k}.sweep"] == N - 1
            assert counts[f"{model}stage{k}.regularize"] == N
            assert counts[f"{model}stage{k}.fuse"] == 1
            assert counts[f"{model}stage{k}.regress"] == 1


@pytest.mark.parametrize("form", ["listed", "stacked", "ragged"])
def test_each_upload_follows_its_copy(form, predictors):
    """`.prepare` and `.upload` alternate after the crop, one pair for the
    cameras and one a view, and the traced request returns what the
    untraced one returns."""
    pred = predictors["mvsnet"]
    imgs, K, R, t, dmin, dmax = request()
    uploads = N + 1
    if form == "stacked":
        imgs = np.stack(imgs)
    elif form == "ragged":
        imgs = [imgs[0], imgs[1][:, :70], imgs[2][:40]]    # cropped to /32
    want = pred(imgs, K, R, t, dmin, dmax)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = pred(imgs, K, R, t, dmin, dmax)
    for k in ("depth", "confidence"):
        np.testing.assert_array_equal(got[k], want[k])
    spans = sorted(s for s in ranges(prof, P)
                   if s[2].endswith((".prepare", ".upload")))
    names = [s[2].removeprefix(P) for s in spans]
    assert names == ["prepare"] + ["prepare", "upload"] * uploads
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("arch", ["mvsnet", "vis_mvsnet"])
def test_regularize_spans_hold_the_regularizers_alone(arch, predictors):
    """Each module call, recorded as a range by forward hooks, lies inside
    a `.regularize` span exactly when the module is one of the
    architecture's regularizers or inside one."""
    model = predictors[arch].model
    stack, handles = [], []
    for name, m in model.named_modules():
        if not name:
            continue

        def pre(_m, _a, name=name):
            stack.append(record_function(f"module:{name}"))
            stack[-1].__enter__()

        def post(_m, _a, _o):
            stack.pop().__exit__(None, None, None)

        handles += [m.register_forward_pre_hook(pre),
                    m.register_forward_hook(post)]
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            predictors[arch](*request())
    finally:
        for h in handles:
            h.remove()
    regs = [s for s in ranges(prof, "wildmvs_torch.")
            if s[2].endswith(".regularize")]
    calls = ranges(prof, "module:")
    regularizers = REGULARIZERS[arch]
    seen = set()
    for a, b, name in calls:
        name = name.removeprefix("module:")
        inside = any(r[0] <= a and b <= r[1] for r in regs)
        under = [r for r in regularizers
                 if name == r or name.startswith(r + ".")]
        assert inside == bool(under), name
        seen.update(r for r in under if r == name)
    assert seen == set(regularizers)


def test_train_step_spans():
    cfg = TrainConfig(architecture="mvsnet", dataset="synthetic",
                      num_depth=8)
    state = T.create_train_state(cfg, "cpu")
    ds = SyntheticMVSDataset(num_samples=1, num_views=N, height=64,
                             width=64, seed=0)
    sample = collate([ds[0]])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batch = T.batch_to_device(sample, "cpu")
        state, out = T.train_step(state, batch, cfg)
    assert torch.isfinite(out["train_loss"])
    spans = ranges(prof, "wildmvs_torch.")
    names = [s[2] for s in spans]
    step = "wildmvs_torch.train_step"
    for part in ("forward", "loss", "backward", "optimizer"):
        [s] = [s for s in spans if s[2] == f"{step}.{part}"]
        assert parent(s, spans) == step
    assert names.count(step) == names.count("wildmvs_torch.batch_to_device")
    assert names.count(step) == 1
    # the model's own spans lie inside the step's forward
    for s in spans:
        if s[2].startswith("wildmvs_torch.mvsnet."):
            assert parent(s, spans) == f"{step}.forward"
