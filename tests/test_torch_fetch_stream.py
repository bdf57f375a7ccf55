"""The lookahead fetch's copy stream (``voxtracer_torch/utils/fetch.py``):
on a card each frame's host copy runs on a stream of the fetch's own,
ordered behind the frame's last kernel, with the copied memory held
back from the allocator until the copy has read it.

On the CPU: nothing is copied and nothing counted, the fetch is still
one frame behind, and the counters are listed; the order of the calls
a push makes on a card is held through stand-ins for ``torch.cuda``.
The tests marked ``cuda`` render on the card, with the memory of each
frame free for reuse as soon as the program lets it go, and hold every
fetched frame bit-equal to a twin renderer's blocking copies
(``python -m pytest --noconftest -m cuda tests/test_torch_fetch_stream.py``;
chip_smoke phase 25 runs them too)."""

import types

import numpy as np
import pytest
import torch

from voxtracer_torch.app import cli
from voxtracer_torch.app.renderbench import eager_render, held_orbit
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.pipeline import Renderer, counters
from voxtracer_torch.engine.scene import load_scene
from voxtracer_torch.utils import fetch as fetch_mod
from voxtracer_torch.utils.fetch import LookaheadFetch

FETCH_COUNTERS = ("fetch.copies", "fetch.stream_copies")
POSE_A = Camera(position=np.array([2.0, 3.0, -4.0]),
                direction=np.array([0.2, 0.1, 1.0]))
POSE_B = Camera(position=np.array([2.3, 3.0, -4.0]),
                direction=np.array([0.1, 0.1, 1.0]))


def _grown(before):
    return {k: counters()[k] - before[k] for k in FETCH_COUNTERS}


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("radius", [0, 2])
def test_cpu_fetch_copies_nothing_and_stays_one_frame_behind(radius):
    r = Renderer(scene=load_scene("8x8x8"), height=12, width=16,
                 device="cpu", denoise_radius=radius, lean=True)
    fetch = LookaheadFetch()
    before = counters()
    outs = [r.render(pose) for pose in (POSE_A, POSE_B, POSE_B)]
    assert fetch.push(outs[0]) is None
    got = [fetch.push(outs[1]), fetch.push(outs[2]), fetch.flush()]
    assert fetch.flush() is None
    for out, (image, rays) in zip(outs, got):
        assert np.array_equal(image, out["image"].numpy())
        assert rays == int(out["rays"].sum())
    assert _grown(before) == {k: 0 for k in FETCH_COUNTERS}
    assert fetch._stream is None  # no copy stream without a card


def test_fetch_counters_are_listed_and_printed(tmp_path, capsys):
    assert set(FETCH_COUNTERS) <= set(counters())
    assert cli.main(["--device", "cpu", "--scene", "8x8x8", "--size",
                     "16x12", "--frames", "2", "--stats",
                     "-o", str(tmp_path / "a.png")]) == 0
    lines = capsys.readouterr().out.splitlines()
    for name in FETCH_COUNTERS:
        assert f"  counter {name}: 0" in lines


class _Cuda:
    """Stand-ins for the parts of ``torch.cuda`` the fetch calls: every
    call is logged as a tuple, streams and events by name."""

    def __init__(self):
        self.log = []
        self.made = []
        self.events = 0
        self._current = {}  # device -> the stream current on it
        outer = self

        class Stream:
            def __init__(self, device=None, name=None):
                self.device = device
                self.name = name or f"copy{len(outer.made)}@{device}"
                self.cuda_stream = id(self)
                if name is None:
                    outer.made.append(self)

            def wait_event(self, event):
                outer.log.append(("wait", self.name, event.name))

        class Event:
            def __init__(self):
                self.name = f"event{outer.events}"
                outer.events += 1
                self.stream = None

            def record(self, stream):
                self.stream = stream
                outer.log.append(("record", self.name, stream.name))

            def synchronize(self):
                outer.log.append(("synchronize", self.name))

        self.Stream, self.Event = Stream, Event

    def current_stream(self, device):
        if device not in self._current:
            self._current[device] = self.Stream(device, f"compute@{device}")
        return self._current[device]

    def set_stream(self, s):
        self._current[s.device] = s

    def raw_current_stream(self, index):
        return self.current_stream(torch.device("cuda", index)).cuda_stream


class _DeviceTensor:
    """A frame's tensor on a card, as far as the fetch touches it."""

    def __init__(self, cuda, name, value, device):
        self.cuda, self.name, self.value = cuda, name, value
        self.device, self.shape, self.dtype = device, value.shape, value.dtype

    def contiguous(self):
        stream = self.cuda.current_stream(self.device).name
        self.cuda.log.append(("contiguous", self.name, stream))
        return self

    def record_stream(self, stream):
        self.cuda.log.append(("record_stream", self.name, stream.name))


@pytest.fixture
def fake_cuda(monkeypatch):
    """``utils/fetch.py`` against the stand-ins: pinned buffers are plain
    host tensors whose ``copy_`` logs the stream current on the
    source's device and takes its value."""
    cuda = _Cuda()

    def empty(shape, dtype, pin_memory):
        assert pin_memory
        host = torch.empty(shape, dtype=dtype)
        real_copy = host.copy_

        def copy_(src, non_blocking):
            assert non_blocking
            stream = cuda.current_stream(src.device).name
            cuda.log.append(("copy", src.name, stream))
            return real_copy(src.value)

        return types.SimpleNamespace(shape=host.shape, copy_=copy_,
                                     numpy=host.numpy, sum=host.sum)

    fake = types.SimpleNamespace(
        cuda=cuda, empty=empty,
        _C=types.SimpleNamespace(
            _cuda_getCurrentRawStream=cuda.raw_current_stream))
    monkeypatch.setattr(fetch_mod, "torch", fake)
    return cuda


def _frame(cuda, i, device=torch.device("cuda", 0), shape=(2, 3, 3)):
    return {"image": _DeviceTensor(cuda, f"image{i}",
                                   torch.full(shape, i, dtype=torch.uint8),
                                   device),
            "rays": _DeviceTensor(cuda, f"rays{i}",
                                  torch.tensor([i, 2 * i]), device)}


def test_push_orders_the_copy_on_its_own_stream_behind_the_frame(fake_cuda):
    cuda = fake_cuda
    fetch = LookaheadFetch()
    before = counters()
    assert fetch.push(_frame(cuda, 1)) is None
    (copy,) = cuda.made
    ready = cuda.log[1][1]
    slot_event = fetch._slots[0][2].name
    assert cuda.log == [
        ("contiguous", "image1", "compute@cuda:0"),
        ("record", ready, "compute@cuda:0"),  # behind the frame's kernels
        ("wait", copy.name, ready),
        ("copy", "image1", copy.name),
        ("copy", "rays1", copy.name),
        ("record", slot_event, copy.name),
        ("record_stream", "image1", copy.name),
        ("record_stream", "rays1", copy.name),
    ]
    assert fetch._slots[0][2].stream is copy
    # the compute stream is current again
    assert cuda.current_stream(torch.device("cuda", 0)).name == (
        "compute@cuda:0")
    del cuda.log[:]
    image, rays = fetch.push(_frame(cuda, 2))
    assert (image == 1).all() and rays == 3
    # one stream and one ``ready`` event for every frame; the slots in turn
    assert cuda.made == [copy] and cuda.log[1] == ("record", ready,
                                                   "compute@cuda:0")
    assert cuda.log[-1] == ("synchronize", slot_event)
    assert fetch._slots[1][2].stream is copy
    image, rays = fetch.flush()
    assert (image == 2).all() and rays == 6
    assert _grown(before) == {k: 2 for k in FETCH_COUNTERS}


def test_drop_resize_and_another_device(fake_cuda):
    """A dropped frame's copy is left to its stream (its memory is held
    by ``record_stream``); a new size gets new slots, a new device a new
    stream."""
    cuda = fake_cuda
    fetch = LookaheadFetch()
    fetch.push(_frame(cuda, 1))
    fetch.drop()
    assert fetch.push(_frame(cuda, 2, shape=(4, 5, 3))) is None
    image, _ = fetch.push(_frame(cuda, 3, shape=(4, 5, 3)))
    assert image.shape == (4, 5, 3) and (image == 2).all()
    assert [c for c in cuda.log if c[0] == "synchronize"] == [
        ("synchronize", fetch._slots[1][2].name)]
    on = torch.device("cuda", 1)
    image, _ = fetch.push(_frame(cuda, 4, device=on))
    assert (image == 3).all()
    assert [s.device for s in cuda.made] == [torch.device("cuda", 0), on]
    assert cuda.log[-3:-1] == [
        ("record_stream", "image4", cuda.made[1].name),
        ("record_stream", "rays4", cuda.made[1].name)]
    assert (fetch.flush()[0] == 4).all()


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _renderer(scene, size):
    return Renderer(scene=scene, height=size[0], width=size[1],
                    device="cuda", denoise_radius=2, lean=True)


def _render(r, path, cam):
    """``r``'s next frame by the direct path or the eager stages."""
    return eager_render(r, cam) if path == "eager" else r.render(cam)


RESIZE_AT, NEW_SIZE = 24, (144, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("interrupted", [False, True],
                         ids=["straight", "drop-and-resize"])
@pytest.mark.parametrize("path", ["direct", "eager"])
def test_fetched_frames_equal_blocking_copies_on_the_card(cuda, path,
                                                          interrupted):
    """48 frames at 320x180 r=2, moving and held in turn, pushed with no
    reference kept to any frame's outputs (its memory free for the next
    frame's as soon as the renderer lets it go): every fetched image and
    ray count == a twin renderer's, copied by a blocking ``.cpu()``.
    ``drop-and-resize`` forgets the frame in flight at frame 24 and goes
    on at 256x144."""
    scene = load_scene("menger")
    cams = held_orbit(scene, 48, seed=19)
    r = _renderer(scene, (180, 320))
    fetch = LookaheadFetch()
    before = counters()
    got, pushes = {}, 0
    for i, cam in enumerate(cams):
        if interrupted and i == RESIZE_AT:
            fetch.drop()
            r.resize(*NEW_SIZE)
        fetched = fetch.push(_render(r, path, cam))
        pushes += 1
        if fetched is not None:
            got[i - 1] = (fetched[0].copy(), fetched[1])
    got[len(cams) - 1] = fetch.flush()
    torch.cuda.synchronize()
    assert _grown(before) == {k: pushes for k in FETCH_COUNTERS}

    twin = _renderer(scene, (180, 320))
    want = {}
    for i, cam in enumerate(cams):
        if interrupted and i == RESIZE_AT:
            twin.resize(*NEW_SIZE)
        out = _render(twin, path, cam)
        want[i] = (out["image"].cpu().numpy(), int(out["rays"].sum().cpu()))
    dropped = {RESIZE_AT - 1} if interrupted else set()
    assert sorted(got) == [i for i in range(len(cams)) if i not in dropped]
    for i, (image, rays) in got.items():
        assert image.shape == want[i][0].shape, i
        assert np.array_equal(image, want[i][0]), i
        assert rays == want[i][1], i


@pytest.mark.cuda
def test_copy_and_its_event_run_on_the_fetch_stream(cuda):
    """The slot's event is recorded on the fetch's stream: held up by
    work there, not by the compute stream; and the compute stream
    finishes a frame while its copy still waits."""
    r = _renderer(load_scene("menger"), (180, 320))
    fetch = LookaheadFetch()
    fetch.push(r.render(POSE_A))
    fetch.flush()
    stream = fetch._stream
    compute = torch.cuda.current_stream()
    assert stream is not None and stream != compute
    assert stream.device == compute.device
    out = r.render(POSE_B)
    want = out["image"].cpu().numpy()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(200_000_000)  # ~0.1 s of the fetch's stream
    fetch.push(out)
    event = fetch._slots[1][2]
    compute.synchronize()
    assert not event.query()  # the copy waits behind the sleep
    image, _ = fetch.flush()
    assert event.query() and np.array_equal(image, want)
