"""The session layer of the port on the CPU: snapshots that cross
between the JAX package and the port, the f32zip noise format, the
timing and logging utilities against the JAX package's, and the CLI's
``--batch`` / ``--video-dir`` / ``--save-snapshot`` / ``--resume`` /
``--stats`` / ``--profile``."""

import json
import logging
import os
import struct
import time
import zlib

import numpy as np
import pytest
import torch

from voxtracer.engine import snapshot as jsnapshot
from voxtracer.engine.camera import Camera as JCamera
from voxtracer.engine.pipeline import Renderer as JRenderer
from voxtracer.io import f32zip as jf32zip
from voxtracer.utils import timing as jtiming
from voxtracer_torch.app import cli
from voxtracer_torch.engine import snapshot
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.params import (
    DenoiseParams,
    RenderParams,
    TemporalParams,
)
from voxtracer_torch.engine.pipeline import Renderer, state_to_numpy
from voxtracer_torch.engine.scene import load_scene
from voxtracer_torch.io import f32zip
from voxtracer_torch.utils import log as tlog
from voxtracer_torch.utils import timing

H, W = 24, 32
POSE = dict(position=np.array([2.0, 3.0, -4.0]),
            direction=np.array([0.2, 0.1, 1.0]))
PARAMS = dict(
    render_params=dict(sun_strength=3.0, sky_color=(0.2, 0.3, 0.9)),
    temporal_params=dict(sample_blending=0.4),
    denoise_params=dict(albedo_factor=0.6),
)


def _port(scene="8x8x8", h=H, w=W, **kw):
    return Renderer(scene=load_scene(scene), height=h, width=w, device="cpu",
                    **kw)


def _with_params(renderer, module):
    """The renderer with non-default parameters of ``module``'s classes
    (the port's ``engine.params`` or the JAX package's)."""
    for name, cls in (("render_params", module.RenderParams),
                      ("temporal_params", module.TemporalParams),
                      ("denoise_params", module.DenoiseParams)):
        setattr(renderer, name, cls(**PARAMS[name]))
    return renderer


def test_jax_snapshot_loads_into_the_port(tmp_path):
    """A snapshot written by the JAX package: state arrays equal,
    counters, parameters and camera restored; the next frame is the JAX
    renderer's own next frame at the bar of
    ``tests/test_torch_pipeline.py`` for still frames (u8 within 1 code
    at no more than 3 pixels)."""
    from voxtracer.engine import params as jparams

    scene = load_scene("menger")
    jr = _with_params(JRenderer(scene=scene, height=H, width=W,
                                trace_impl="xla", denoise_radius=1), jparams)
    jcam = JCamera(position=np.array([36.0, 34.0, -5.0]),
                   direction=np.array([-16.0, -14.0, 25.0]))
    for _ in range(3):
        jr.render(jcam)
    path = tmp_path / "jax.npz"
    jsnapshot.save(path, jr, jcam)

    r = _port(scene="menger")
    cam = snapshot.load(path, r)
    got = state_to_numpy(r.state)
    for k, v in jr.state.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    assert (r.frame_number, r.still_sample, r.denoise_radius) == (3, 3, 1)
    assert r.render_params == RenderParams(**PARAMS["render_params"])
    assert r.temporal_params == TemporalParams(**PARAMS["temporal_params"])
    assert r.denoise_params == DenoiseParams(**PARAMS["denoise_params"])
    np.testing.assert_array_equal(cam.position, jcam.position)
    np.testing.assert_array_equal(cam.direction, jcam.direction)
    assert cam.fov == jcam.fov
    want = np.asarray(jr.render(jcam)["image"]).astype(int)
    diff = np.abs(r.render(cam)["image"].numpy().astype(int) - want)
    assert diff.max() <= 1 and int((diff > 0).any(-1).sum()) <= 3
    assert r.still_sample == jr.still_sample == 4


def test_port_snapshot_loads_into_the_jax_package(tmp_path, caplog):
    """The reverse: the file has the reference's keys and meta fields,
    and the JAX package restores the port's state from it, warning only
    about the trace implementation's name."""
    import voxtracer_torch.engine.params as tparams

    r = _with_params(_port(denoise_radius=2), tparams)
    cam = Camera(**POSE)
    for _ in range(3):
        r.render(cam)
    path = tmp_path / "port.npz"
    snapshot.save(path, r, cam)

    data = np.load(path, allow_pickle=False)
    assert sorted(data.files) == ["accum_blend", "accum_color",
                                  "history_valid", "meta", "old_cam",
                                  "old_depth"]
    meta = json.loads(str(data["meta"]))
    assert sorted(meta) == sorted([
        "version", "scene_hash", "height", "width", "frame_number",
        "still_sample", "denoise_radius", "trace_impl", "render_params",
        "temporal_params", "denoise_params", "camera_position",
        "camera_direction", "camera_fov"])
    assert meta["version"] == snapshot.FORMAT_VERSION == 2
    assert meta["trace_impl"] == "cpu"

    jr = JRenderer(scene=load_scene("8x8x8"), height=H, width=W,
                   trace_impl="xla")
    with caplog.at_level(logging.WARNING):
        jcam = jsnapshot.load(path, jr)
    assert "trace_impl='cpu'" in caplog.text
    want = state_to_numpy(r.state)
    for k, v in jr.state.items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)
    assert (jr.frame_number, jr.still_sample, jr.denoise_radius) == (3, 3, 2)
    assert jr.render_params.sun_strength == 3.0
    assert jr.denoise_params.albedo_factor == 0.6
    np.testing.assert_array_equal(jcam.position, cam.position)
    np.testing.assert_array_equal(jr._last_cam, cam.rows(W, H))


@pytest.mark.parametrize("path_name, radius", [("static", 0), ("orbit", 1)])
def test_resumed_run_continues_like_an_uninterrupted_one(tmp_path, path_name,
                                                         radius):
    """Save after 3 frames, load into a fresh renderer: its next frames
    (at rest, then moved) equal the uninterrupted renderer's bit for
    bit, through ``render`` and through ``render_sequence``."""
    from voxtracer_torch.app import camera_paths

    scene = load_scene("8x8x8")
    path = camera_paths.PATHS[path_name](scene)
    a = _port(denoise_radius=radius)
    for i in range(3):
        cam = path(i / 30.0)
        a.render(cam)
    snapshot.save(tmp_path / "s.npz", a, cam)
    b, c = _port(), _port()
    for r in (b, c):
        restored = snapshot.load(tmp_path / "s.npz", r)
        assert (r.frame_number, r.still_sample, r.denoise_radius) == (
            3, a.still_sample, radius)
        assert r.state["history_valid"]
    np.testing.assert_array_equal(restored.rows(W, H), cam.rows(W, H))
    nxt = [restored, path(0.5), path(0.5)]
    want = [a.render(x)["image"] for x in nxt]
    got = [b.render(x)["image"] for x in nxt]
    seq = c.render_sequence(nxt)
    for i in range(3):
        assert torch.equal(got[i], want[i]) and torch.equal(seq[i], want[i])
    assert a.still_sample == b.still_sample == c.still_sample == (
        6 if path_name == "static" else 2)
    assert a.frame_number == b.frame_number == c.frame_number == 6


def test_snapshot_mismatches_raise(tmp_path):
    r = _port()
    cam = Camera(**POSE)
    r.render(cam)
    snapshot.save(tmp_path / "s.npz", r, cam)
    with pytest.raises(ValueError, match="resolution mismatch: 24x32 vs 16x32"):
        snapshot.load(tmp_path / "s.npz", _port(h=16))
    with pytest.raises(ValueError, match="scene mismatch"):
        snapshot.load(tmp_path / "s.npz", _port(scene="3x3x3"))
    with pytest.raises(ValueError, match="scene mismatch"):
        jsnapshot.load(tmp_path / "s.npz", JRenderer(
            scene=load_scene("3x3x3"), height=H, width=W, trace_impl="xla"))
    data = dict(np.load(tmp_path / "s.npz"))
    meta = json.loads(str(data.pop("meta")))
    np.savez(tmp_path / "v9.npz", meta=json.dumps({**meta, "version": 9}),
             **data)
    with pytest.raises(ValueError, match="unsupported snapshot version 9"):
        snapshot.load(tmp_path / "v9.npz", _port())


def test_old_snapshots_migrate_on_load(tmp_path, caplog):
    """A v1 snapshot (no scene hash, channels-last colour, another
    trace implementation) loads with warnings; colour comes back
    planar."""
    r = _port()
    cam = Camera(**POSE)
    r.render(cam)
    snapshot.save(tmp_path / "s.npz", r, cam)
    data = dict(np.load(tmp_path / "s.npz"))
    meta = json.loads(str(data.pop("meta")))
    del meta["scene_hash"]
    meta.update(version=1, trace_impl="pallas")
    data["accum_color"] = np.moveaxis(data["accum_color"], 0, -1)
    assert data["accum_color"].shape == (H, W, 3)
    np.savez(tmp_path / "v1.npz", meta=json.dumps(meta), **data)
    fresh = _port()
    with caplog.at_level(logging.WARNING):
        snapshot.load(tmp_path / "v1.npz", fresh)
    assert "no scene identity" in caplog.text
    assert "trace_impl='pallas'" in caplog.text
    assert torch.equal(fresh.state["accum_color"], r.state["accum_color"])


@pytest.mark.parametrize("name", ["8x8x8", "menger", "chr_knight"])
def test_scene_hash_equals_the_reference(name):
    scene = load_scene(name)
    assert snapshot.scene_hash(scene) == jsnapshot.scene_hash(scene)
    assert len(snapshot.scene_hash(scene)) == 32


def test_f32zip_files_are_byte_equal_and_round_trip(tmp_path, monkeypatch):
    """The two writers give the same bytes (at one clock reading: a zip
    entry records its time), and each reader returns what was written."""
    noise = np.random.default_rng(5).random((3, 8, 8), np.float32)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    f32zip.write_f32zip(tmp_path / "port.zip", noise)
    jf32zip.write_f32zip(tmp_path / "jax.zip", noise)
    monkeypatch.undo()
    assert (tmp_path / "port.zip").read_bytes() == (
        tmp_path / "jax.zip").read_bytes()
    for read in (f32zip.read_f32zip, jf32zip.read_f32zip):
        back = read(tmp_path / "port.zip")
        assert back.dtype == np.float32
        np.testing.assert_array_equal(back, noise)


def test_f32zip_rejects_what_the_reference_rejects(tmp_path):
    import zipfile

    def archive(name, *images):
        with zipfile.ZipFile(tmp_path / name, "w") as zf:
            for i, (w, h) in enumerate(images):
                zf.writestr(f"{i}.f32", struct.pack(">II", w, h)
                            + bytes(4 * w * h))
        return tmp_path / name

    for read in (f32zip.read_f32zip, jf32zip.read_f32zip):
        with pytest.raises(ValueError, match="non-square"):
            read(archive("a.zip", (4, 2)))
        with pytest.raises(ValueError, match="differ in size"):
            read(archive("b.zip", (4, 4), (2, 2)))
        with pytest.raises(ValueError, match="no images"):
            read(archive("c.zip"))


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("module", [timing, jtiming], ids=["port", "jax"])
def test_timers_on_a_faked_clock(module, monkeypatch):
    """``FpsCounter`` and ``StageTimer`` of the port behave as the JAX
    package's: one scenario, both modules.  Beside them, the JAX
    package's ``Stopwatch`` (the port has none: nothing read it) and the
    port's ``span``: while no profiler records, the one shared no-op,
    which reads no clock; under one, a range in the profiler's events,
    which reads none either (the profiler keeps its own clock)."""
    clock = _Clock()
    monkeypatch.setattr(module.time, "perf_counter", clock)
    if module is jtiming:
        watch = module.Stopwatch()
        clock.now += 0.5
        assert watch.tick() == 0.5
        clock.now += 0.25
        assert watch.tick() == 0.25
    else:
        assert not hasattr(module, "Stopwatch")
        reads = []
        monkeypatch.setattr(module.time, "perf_counter",
                            lambda: reads.append(clock.now) or clock.now)
        off = module.span("vt.render", {"frame": 1})
        assert off is module.span("vt.render.pack")
        with off:
            clock.now += 0.5
        with torch.autograd.profiler.profile(use_kineto=True) as prof:
            with module.span("vt.render.pack"):
                clock.now += 0.25
        assert reads == []
        assert [e.name for e in prof.function_events] == ["vt.render.pack"]
        monkeypatch.setattr(module.time, "perf_counter", clock)

    fps = module.FpsCounter(window=0.25)
    clock.now += 0.1
    assert fps.tick() == 0.0  # inside the window: not refreshed yet
    clock.now += 0.2
    assert fps.tick() == pytest.approx(2 / 0.3)
    clock.now += 0.5
    assert fps.tick() == pytest.approx(1 / 0.5)

    timer = module.StageTimer()

    def work(x, scale=1):
        clock.now += 0.1 * scale
        return {"depth": np.float32(x)}

    assert timer.measure("frame", work, 3)["depth"] == 3
    timer.measure("frame", work, 4, scale=3)
    timer.measure("batch", work, 5, scale=2)
    report = timer.report()
    assert list(report) == ["frame", "batch"]
    assert report["frame"] == pytest.approx(0.2)
    assert report["batch"] == pytest.approx(0.2)
    assert timer.counts == {"frame": 2, "batch": 1}


def test_stage_timer_closes_a_stage_on_its_device(monkeypatch):
    """``sync`` names a tensor of the result: on the CPU nothing waits;
    for a CUDA tensor the timer synchronises that device."""
    timer = timing.StageTimer()
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)
    out = timer.measure("frame", lambda: {"image": torch.zeros(2)},
                        sync=lambda o: o["image"])
    assert seen == [] and out["image"].shape == (2,)

    class OnCard:
        device = torch.device("cuda", 0)

    timer.measure("frame", lambda: OnCard(), sync=lambda o: o)
    assert seen == [torch.device("cuda", 0)]
    assert timer.counts["frame"] == 2


def test_setup_logging_levels(monkeypatch):
    names = ("voxtracer_torch", "voxtracer_torch.ops")
    saved = {n: logging.getLogger(n).level for n in names}
    root = logging.getLogger().level
    try:
        monkeypatch.setenv("VOXTRACER_LOG", "voxtracer_torch.ops=debug")
        tlog.setup_logging()
        assert logging.getLogger("voxtracer_torch").level == logging.INFO
        assert logging.getLogger("voxtracer_torch.ops").level == logging.DEBUG
        monkeypatch.setenv("VOXTRACER_LOG", "error")
        tlog.setup_logging()
        assert logging.getLogger("voxtracer_torch").level == logging.ERROR
        assert logging.getLogger().level == logging.ERROR
    finally:
        logging.getLogger().setLevel(root)
        for n, level in saved.items():
            logging.getLogger(n).setLevel(level)


def _read_png(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    width, height = struct.unpack(">II", data[16:24])
    idat = data.index(b"IDAT")
    n = struct.unpack(">I", data[idat - 4:idat])[0]
    rows = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + n]),
                         np.uint8).reshape(height, 1 + width * 3)
    return rows[:, 1:].reshape(height, width, 3)


BASE = ["--device", "cpu", "--scene", "8x8x8", "--size", "24x16"]


@pytest.mark.parametrize("extra", [[], ["--path", "orbit",
                                        "--denoise-radius", "1"]],
                         ids=["static", "orbit-r1"])
def test_cli_batches_write_every_frame(tmp_path, extra, capsys):
    """``--batch 2 --frames 5``: two sequences and one remainder frame;
    5 PNGs, the last equal to ``-o``, all equal to the per-frame loop's."""
    out = {}
    for mode, batch in (("batch", ["--batch", "2"]), ("loop", [])):
        frames = tmp_path / mode
        assert cli.main([*BASE, *extra, *batch, "--frames", "5", "--video-dir",
                         str(frames), "-o", str(tmp_path / f"{mode}.png")]) == 0
        assert sorted(os.listdir(frames)) == [
            f"frame_{i:05d}.png" for i in range(5)]
        out[mode] = [_read_png(frames / f"frame_{i:05d}.png")
                     for i in range(5)]
        np.testing.assert_array_equal(out[mode][-1],
                                      _read_png(tmp_path / f"{mode}.png"))
    for a, b in zip(out["batch"], out["loop"]):
        assert a.shape == (16, 24, 3) and a.std() > 0
        np.testing.assert_array_equal(a, b)
    assert "rendered 5 frames at 24x16" in capsys.readouterr().out


def test_cli_snapshot_resume_continues(tmp_path, capsys):
    """6 frames, snapshot, 4 more from it, against 10 uninterrupted:
    the resumed frames are numbered on and the final image is equal."""
    snap = str(tmp_path / "s.npz")
    assert cli.main([*BASE, "--batch", "3", "--frames", "6",
                     "--save-snapshot", snap,
                     "-o", str(tmp_path / "a.png")]) == 0
    assert cli.main([*BASE, "--batch", "3", "--frames", "4", "--resume", snap,
                     "--video-dir", str(tmp_path / "v"),
                     "-o", str(tmp_path / "b.png")]) == 0
    assert cli.main([*BASE, "--frames", "10",
                     "-o", str(tmp_path / "whole.png")]) == 0
    assert sorted(os.listdir(tmp_path / "v")) == [
        f"frame_{i:05d}.png" for i in range(6, 10)]
    np.testing.assert_array_equal(_read_png(tmp_path / "b.png"),
                                  _read_png(tmp_path / "whole.png"))
    assert not np.array_equal(_read_png(tmp_path / "a.png"),
                              _read_png(tmp_path / "whole.png"))
    assert "kernel=cpu" in capsys.readouterr().out


def test_cli_stats_and_profile(tmp_path, capsys):
    """``--stats`` prints one line per stage that ran; ``--profile``
    writes a chrome trace with events in it."""
    prof = tmp_path / "prof"
    assert cli.main([*BASE, "--batch", "2", "--frames", "3", "--stats",
                     "--profile", str(prof),
                     "-o", str(tmp_path / "a.png")]) == 0
    lines = capsys.readouterr().out.splitlines()
    stages = [ln.split()[1].rstrip(":") for ln in lines
              if ln.startswith("  stage ")]
    assert stages == ["batch", "frame"]
    assert all(ln.endswith(" ms avg") for ln in lines
               if ln.startswith("  stage "))
    with open(prof / "trace.json") as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) > 10


@pytest.mark.parametrize("flags, message", [
    (["--batch", "0"], "--batch must be >= 1"),
    (["--frames", "0"], "--frames must be >= 1"),
])
def test_cli_refuses_bad_counts(flags, message):
    with pytest.raises(SystemExit, match=message):
        cli.main([*BASE, *flags])


@pytest.mark.parametrize("flags", [["--watch-kernels"], ["--legacy-whitted"]])
def test_cli_runs_watch_kernels_and_legacy_whitted(flags, tmp_path):
    out = tmp_path / "frame.png"
    assert cli.main([*BASE, "--frames", "2", *flags, "-o", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("flags, message", [
    (["--batch", "0"], "--batch must be >= 1"),
    (["--frames", "0"], "--frames must be >= 1"),
    (["--watch-kernels"], "Queue 1 #4"),
    (["--legacy-whitted"], "Queue 1 #6"),
])
def test_cli_refuses_bad_counts_and_unported_modes(flags, message, tmp_path):
    """Kept under its earlier name and cases, from when
    ``--watch-kernels`` and ``--legacy-whitted`` were refused as not yet
    ported (ROADMAP Queue 1 #4, #6): the counts are still refused, and
    both modes now run (the two tests above)."""
    if message.startswith("Queue 1"):
        test_cli_runs_watch_kernels_and_legacy_whitted(flags, tmp_path)
    else:
        test_cli_refuses_bad_counts(flags, message)


@pytest.mark.parametrize("flags", [["--trace-impl", "xla"],
                                   ["--batch-resample", "xla"]])
def test_cli_has_no_flags_for_what_the_port_does_not_need(flags, capsys):
    """The device picks the trace implementation and the temporal kernel
    gathers at any offset: argparse rejects the reference's flags."""
    with pytest.raises(SystemExit) as e:
        cli.main([*BASE, *flags])
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err
