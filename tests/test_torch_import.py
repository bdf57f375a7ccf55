"""The PyTorch port's package boundary and its host-side ports:
imports, parameter packing, the camera basis and the camera paths."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from voxtracer.app import camera_paths as jcamera_paths
from voxtracer.engine import camera as jcamera
from voxtracer.engine import params as jparams
from voxtracer.ops import denoise_pallas, temporal_pallas, trace_pallas
from voxtracer.ops.temporal import _inv3_np
from voxtracer_torch.app import camera_paths as tcamera_paths
from voxtracer_torch.engine import camera as tcamera
from voxtracer_torch.engine import params as tparams
from voxtracer_torch.engine.scene import load_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_triton():
    """Every module of the port imports without JAX, Triton or any
    module of the JAX package ``voxtracer`` (a fresh interpreter: this
    test process has JAX loaded by conftest)."""
    code = (
        "import pkgutil, sys, json, importlib, voxtracer_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "voxtracer_torch.__path__, 'voxtracer_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'voxtracer'))\n"
        "print(json.dumps({'modules': names, 'bad': bad}))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("trace", "temporal", "denoise", "reproject", "_build",
                 "whitted"):
        assert f"voxtracer_torch.ops.{name}" in res["modules"]
    for name in ("cli", "bench", "phasestats", "stallbench", "tracebench",
                 "denoisebench", "input", "viewer", "web", "ibench",
                 "profile"):
        assert f"voxtracer_torch.app.{name}" in res["modules"]
    for name in ("io.vox", "io.image", "scene.grid", "scene.procedural",
                 "native", "oracle.renderer", "ops.noise", "utils.log",
                 "utils.timing", "io.f32zip", "engine.snapshot",
                 "engine.reload", "utils.fetch", "scene.octree",
                 "parallel", "parallel.mesh"):
        assert f"voxtracer_torch.{name}" in res["modules"]
    assert res["bad"] == []


def test_make_mesh_defaults_to_the_cuda_devices(monkeypatch):
    """``make_mesh()`` is every CUDA device, and raises without one."""
    import torch

    from voxtracer_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh() == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh(["cpu"] * 3) == (torch.device("cpu"),) * 3


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("module", ["cli", "viewer", "web", "ibench",
                                    "profile", "bench", "phasestats",
                                    "denoisebench"])
def test_entry_points_default_to_the_card(module, monkeypatch):
    """Every entry point of the port runs on the card unless the caller
    asks for the CPU (``--device cpu``): ``main([])`` parses
    ``device == "cuda"`` (stopped right after its parser)."""
    import argparse
    import importlib

    parse = argparse.ArgumentParser.parse_args
    seen = []

    def parse_and_stop(self, args=None, namespace=None):
        seen.append(parse(self, args, namespace))
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_and_stop)
    main = importlib.import_module(f"voxtracer_torch.app.{module}").main
    with pytest.raises(_Parsed):
        main([])
    assert seen[0].device == "cuda"


@pytest.mark.parametrize(
    "rp",
    [
        tparams.RenderParams(),
        tparams.RenderParams(
            emit_strength=7.5, sun_strength=0.0, sun_size=0.3,
            sun_yaw=4.1, sun_pitch=-0.7, sun_color=(0.9, 0.5, 0.2),
            sky_color=(0.1, 0.2, 0.3), specularity=0.4,
        ),
    ],
)
def test_pack_trace_params_bit_equal(rp):
    rng = np.random.default_rng(3)
    cam = rng.normal(size=(4, 3)).astype(np.float32)
    jrp = jparams.RenderParams(**dataclasses.asdict(rp))
    want = trace_pallas.pack_params(cam, jrp)[0]
    got = tparams.pack_trace_params(cam, rp)
    assert got.dtype == np.float32 and got.shape == (32,)
    assert want.tobytes() == got.tobytes()


@pytest.mark.parametrize(
    "name", ["RenderParams", "TemporalParams", "DenoiseParams"]
)
def test_params_defaults_match_reference(name):
    ref, port = getattr(jparams, name), getattr(tparams, name)
    assert [f.name for f in dataclasses.fields(ref)] == [
        f.name for f in dataclasses.fields(port)
    ]
    assert dataclasses.asdict(ref()) == dataclasses.asdict(port())
    assert tparams.DENOISE_RADIUS_DEFAULT == jparams.DENOISE_RADIUS_DEFAULT


@pytest.mark.parametrize(
    "pos, direction, fov, size",
    [
        ((0.0, 0.0, -2.0), (0.0, 0.0, 1.0), 70.0, (32, 32)),
        ((36.0, 34.0, -5.0), (-16.0, -14.0, 25.0), 70.0, (1280, 720)),
        ((1.0, 2.0, 3.0), (0.3, -0.9, 0.1), 45.0, (64, 48)),
    ],
)
def test_camera_matches_reference(pos, direction, fov, size):
    kw = dict(position=np.array(pos), direction=np.array(direction),
              fov=np.radians(fov))
    ref, port = jcamera.Camera(**kw), tcamera.Camera(**kw)
    for a, b in zip(ref.axis_scaled(*size), port.axis_scaled(*size)):
        np.testing.assert_array_equal(a, b)
    right, up, fwd = ref.axis_scaled(*size)
    np.testing.assert_array_equal(
        port.rows(*size),
        np.stack([np.asarray(pos), right, up, fwd]).astype(np.float32),
    )
    np.testing.assert_array_equal(
        ref.with_yaw_pitch(0.4, -0.2).direction,
        port.with_yaw_pitch(0.4, -0.2).direction,
    )


@pytest.mark.parametrize("history_valid", [True, False])
@pytest.mark.parametrize(
    "tp",
    [tparams.TemporalParams(),
     tparams.TemporalParams(sample_blending=0.2, maximum_blending=0.9,
                            blending_distance_cutoff=0.3)],
    ids=["default", "custom"],
)
def test_pack_temporal_params_bit_equal(tp, history_valid):
    """The host pack holds the fields of the reference's host-packed
    temporal row (without its mesh slots); its inverse of the old basis
    is bit-equal to ``_inv3_np``."""
    rng = np.random.default_rng(5)
    cam = rng.normal(size=(4, 3)).astype(np.float32)
    old = rng.normal(size=(4, 3)).astype(np.float32)
    got = tparams.pack_temporal_params(cam, old, tp, history_valid)
    assert got.dtype == np.float32 and got.shape == (40,)
    inv = _inv3_np(np.stack([old[1], old[2], old[3]], axis=1))
    assert got[24:33].tobytes() == inv.reshape(9).tobytes()
    want = temporal_pallas.pack_temporal_row_host(
        cam, old, jparams.TemporalParams(**dataclasses.asdict(tp)),
        history_valid, 48,
    )
    n = temporal_pallas._P_HVALID + 1
    assert got[:n].tobytes() == want[:n].tobytes()
    assert not got[n:].any()


def test_pack_denoise_params_bit_equal():
    rng = np.random.default_rng(6)
    cam = rng.normal(size=(4, 3)).astype(np.float32)
    dp = tparams.DenoiseParams(sigma_distance=1.3, sigma_range=0.4,
                               albedo_factor=0.7)
    got = tparams.pack_denoise_params(cam, dp)
    want = denoise_pallas.pack_denoise_row_host(
        cam, jparams.DenoiseParams(**dataclasses.asdict(dp))
    )
    assert got.dtype == np.float32 and got.shape == (16,)
    # slot 15 is the reference's mesh row offset, 0 on one device
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", ["static", "orbit", "dolly"])
def test_camera_paths_match_reference(name):
    scene = load_scene("chr_knight")
    ref, port = jcamera_paths.PATHS[name](scene), tcamera_paths.PATHS[name](
        scene)
    for t in (0.0, 1 / 30, 0.7, 5.0):
        a, b = ref(t), port(t)
        np.testing.assert_array_equal(a.position, b.position)
        np.testing.assert_array_equal(a.direction, b.direction)
        assert a.fov == b.fov
