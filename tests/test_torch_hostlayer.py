"""The port's own host layer against the JAX package's modules it was
copied from: .vox loading, voxel lists, the grid and its device tables
(both brick layouts; the native library's path and the numpy path),
the PNG writer, the numpy oracle and the noise buffers.  Everything is
bit-equal.

The numpy path of the table build is held on 8x8x8, chr_knight and the
procedural default scene at radius 24: at its full radius (256) that
path takes minutes and gigabytes on the CPU, so the full-size default
scene goes through the library path only.
"""

import glob
import os

import numpy as np
import pytest

from voxtracer import native as jnative
from voxtracer.io import image as jimage
from voxtracer.io import vox as jvox
from voxtracer.ops import bluenoise as jbluenoise
from voxtracer.ops import noise as jnoise
from voxtracer.oracle import renderer as joracle
from voxtracer import scene as jscene
from voxtracer.scene import grid as jgrid
from voxtracer_torch import native as tnative
from voxtracer_torch import scene as tscene
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.params import RenderParams
from voxtracer_torch.io import image as timage
from voxtracer_torch.io import vox as tvox
from voxtracer_torch.ops import noise as tnoise
from voxtracer_torch.oracle import renderer as toracle
from voxtracer_torch.scene import grid as tgrid

VOX_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "vox")
ASSETS = sorted(os.path.splitext(os.path.basename(p))[0]
                for p in glob.glob(os.path.join(VOX_DIR, "*.vox")))
TABLE_KEYS = ("packed_idx", "meta_idx", "brick_idx", "palette")


def _scene(pkg_vox, pkg_scene, name, radius=256):
    if name == "default":
        return pkg_scene.GridScene.from_voxels(
            pkg_scene.default_scene(radius=radius))
    vox = pkg_vox.load(os.path.join(VOX_DIR, name + ".vox"))
    return pkg_scene.GridScene.from_voxels(pkg_scene.voxels_from_vox(vox))


def _assert_tables_equal(name, dedup_max, monkeypatch, radius=256):
    """Both packages build ``name``'s scene and device tables with
    ``BRICK_DEDUP_MAX`` forced to ``dedup_max`` (None: the default)."""
    if dedup_max is not None:
        monkeypatch.setattr(jgrid, "BRICK_DEDUP_MAX", dedup_max)
        monkeypatch.setattr(tgrid, "BRICK_DEDUP_MAX", dedup_max)
    ts = _scene(tvox, tscene, name, radius)
    js = _scene(jvox, jscene, name, radius)
    assert ts.values.tobytes() == js.values.tobytes()
    np.testing.assert_array_equal(ts.origin, js.origin)
    assert len(ts.mips) == len(js.mips)
    for a, b in zip(ts.mips, js.mips):
        np.testing.assert_array_equal(a, b)
    got, want = ts.device_tables(), js.device_tables()
    for key in TABLE_KEYS:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key
    assert got["zw"] == want["zw"]
    assert tuple(got["l3_dims"]) == tuple(want["l3_dims"])
    if dedup_max == 0:
        assert got["brick_idx"].shape[0] == 2  # per-node layout
    return got


@pytest.fixture
def library():
    if not (tnative.loaded() and jnative.get() is not None):
        pytest.skip("the native library cannot be built here")


@pytest.mark.parametrize("dedup_max", [None, 0], ids=["dedup", "per_node"])
@pytest.mark.parametrize("name", ASSETS + ["default"])
def test_device_tables_library_path(name, dedup_max, monkeypatch, library):
    got = _assert_tables_equal(name, dedup_max, monkeypatch)
    if dedup_max is None and name != "default":
        assert got["brick_idx"].shape[0] == 3  # every asset dedups


@pytest.mark.parametrize("dedup_max", [None, 0], ids=["dedup", "per_node"])
@pytest.mark.parametrize("name", ["8x8x8", "chr_knight", "default"])
def test_device_tables_numpy_path(name, dedup_max, monkeypatch):
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "get", lambda: None)
    assert not tnative.loaded()
    _assert_tables_equal(name, dedup_max, monkeypatch, radius=24)


def test_vox_parse_equal():
    """Models, palette and materials of every asset."""
    for name in ASSETS:
        path = os.path.join(VOX_DIR, name + ".vox")
        t, j = tvox.load(path), jvox.load(path)
        assert [m.size for m in t.models] == [m.size for m in j.models]
        for a, b in zip(t.models, j.models):
            np.testing.assert_array_equal(a.voxels, b.voxels)
        np.testing.assert_array_equal(t.palette, j.palette)
        assert {k: (m.kind.value, m.flux) for k, m in t.materials.items()} \
            == {k: (m.kind.value, m.flux) for k, m in j.materials.items()}


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_png_same_bytes(tmp_path, channels):
    rng = np.random.default_rng(channels)
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    timage.write_png(tmp_path / "t.png", img)
    jimage.write_png(tmp_path / "j.png", img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_oracle_render_sample_bit_equal():
    scene = tscene.GridScene.from_voxels(tscene.voxels_from_vox(
        tvox.load(os.path.join(VOX_DIR, "8x8x8.vox"))))
    cam = Camera(position=np.array([2.0, 3.0, -4.0]),
                 direction=np.array([0.2, 0.1, 1.0]))
    w = h = 32
    right, up, forward = cam.axis_scaled(w, h)
    planes = tnoise.noise_planes(tnoise.white_noise_buffer(seed=7), 1, h, w)
    args = (scene.values, scene.origin.astype(np.int64),
            np.asarray(cam.position, np.float64), right, up, forward,
            RenderParams(), planes, w, h)
    got, want = toracle.render_sample(*args), joracle.render_sample(*args)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert (got["depth"] >= 0).any()


def test_noise_buffers_equal():
    np.testing.assert_array_equal(tnoise.white_noise_buffer(seed=3, count=8),
                                  jnoise.white_noise_buffer(seed=3, count=8))
    blue = tnoise.blue_noise_buffer()
    assert blue.shape == (512, 128, 128) and blue.dtype == np.float32
    assert blue.tobytes() == jbluenoise.cached_buffer().tobytes()
    buf = tnoise.white_noise_buffer(seed=4, count=40)
    np.testing.assert_array_equal(tnoise.noise_planes(buf, 37, 150, 300),
                                  jnoise.noise_planes(buf, 37, 150, 300))


def test_blue_noise_loader_raises_on_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="blue-noise asset"):
        tnoise.blue_noise_buffer(str(tmp_path / "missing.npz"))
