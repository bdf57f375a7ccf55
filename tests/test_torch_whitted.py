"""The legacy Whitted mode of the port (``scene/octree.py``,
``ops/whitted.py``, the CLI's ``--legacy-whitted``) against the JAX
package's, and against an independent brute-force voxel intersector.

Bars (those of ``tests/test_whitted.py``): the octree bit-equal; hit
flags equal; hit times within 1e-5 (the traversal's float32 arithmetic
in the reference's order, measured equal or within an ulp); colours and
the background within 1e-6; normals exact.  The CLI writes the same PNG
bytes as the JAX package's CLI.  On the card: the image within 1e-5 of
the CPU's (measured equal).

The JAX package is imported inside the tests: the card's machine runs
this file's ``cuda`` tests without JAX,

    python -m pytest --noconftest -m cuda tests/test_torch_whitted.py
"""

import importlib
import os

import numpy as np
import pytest
import torch

from voxtracer_torch.app import camera_paths, cli
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.scene import load_scene, load_voxels
from voxtracer_torch.ops import whitted
from voxtracer_torch.scene import VoxelList
from voxtracer_torch.scene.octree import (
    build_octree,
    octree_depth,
    resolve_octree,
)


def _jax(name):
    return importlib.import_module("voxtracer." + name)


def _voxel_list(pos, rgb):
    mrgb = np.zeros((len(pos), 4), np.uint8)
    mrgb[:, 1:] = rgb
    return VoxelList(pos=np.asarray(pos, np.int16).reshape(-1, 3), mrgb=mrgb)


def _random_scene(rng, n=60, span=8):
    pos = np.unique(rng.integers(-span, span, size=(n, 3)), axis=0)
    return pos, rng.integers(1, 256, size=(len(pos), 3))


# -- the octree ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["default", "8x8x8", "menger", "chr_knight"])
def test_octree_bit_equal_to_reference(name):
    joctree = _jax("scene.octree")
    voxels = load_voxels(name)
    jvoxels = _jax("app.cli").load_voxels(name)
    np.testing.assert_array_equal(voxels.pos, jvoxels.pos)
    np.testing.assert_array_equal(voxels.mrgb, jvoxels.mrgb)
    tree = build_octree(voxels)
    want = joctree.build_octree(jvoxels)
    assert tree.dtype == want.dtype == np.int32
    assert tree.tobytes() == want.tobytes()
    probe = np.concatenate([voxels.pos[::97], voxels.pos[:5] + 1]).astype(
        np.int64)
    got = resolve_octree(tree, probe)
    np.testing.assert_array_equal(got, joctree.resolve_octree(want, probe))
    assert (got[:len(voxels.pos[::97])] < 0).all()  # leaves where voxels are


@pytest.mark.parametrize(
    "pos",
    [np.zeros((0, 3)), np.array([[0, 0, 0]]), np.array([[-1, 0, 0]]),
     np.array([[-9, 3, 15], [16, -16, 0]]), np.array([[1, 2, 3]])],
    ids=["empty", "origin", "minus-one", "mixed", "small"],
)
def test_octree_depth_matches_reference(pos):
    assert octree_depth(pos) == _jax("scene.octree").octree_depth(pos)


def test_random_octree_resolves_every_voxel():
    rng = np.random.default_rng(3)
    pos, rgb = _random_scene(rng, n=300, span=20)
    tree = build_octree(_voxel_list(pos, rgb))
    got = resolve_octree(tree, pos)
    want = _voxel_list(pos, rgb)
    from voxtracer_torch.scene.voxels import pack_leaves

    np.testing.assert_array_equal(got, pack_leaves(want.mrgb))


def test_load_voxels_refuses_an_unknown_scene():
    with pytest.raises(ValueError, match="unknown scene"):
        load_voxels("no-such-scene")


# -- the raytracer against the JAX package -------------------------------------

def _rays(rng, n):
    """Origins outside the root cube looking inward, generic directions."""
    origins = rng.normal(size=(n, 3))
    origins = origins / np.linalg.norm(origins, axis=1, keepdims=True) * 9.0
    dirs = rng.uniform(-3.0, 3.0, size=(n, 3)) + 0.123456 - origins
    dirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins.astype(np.float32), dirs.astype(np.float32)


def _cast_port(tree, origins, dirs):
    header = torch.from_numpy(tree[:5].view(np.float32).copy())
    nodes = torch.from_numpy(tree[5:].astype(np.int64))
    return [t.numpy() for t in whitted.cast_ray(
        nodes, header[:3], header[3], torch.from_numpy(origins),
        torch.from_numpy(dirs))]


def test_cast_ray_matches_reference():
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    jwhitted = _jax("ops.whitted")
    rng = np.random.default_rng(7)
    pos, rgb = _random_scene(rng)
    tree = build_octree(_voxel_list(pos, rgb))
    origins, dirs = _rays(rng, 400)
    header = tree[:5].view(np.float32)
    nodes = jnp.asarray(tree[5:])
    cast = jax.jit(jax.vmap(lambda o, d: jwhitted.cast_ray(
        nodes, jnp.asarray(header[:3]), jnp.float32(header[3]), o, d)))
    want = [np.asarray(a) for a in cast(jnp.asarray(origins),
                                        jnp.asarray(dirs))]
    got = _cast_port(tree, origins, dirs)
    hit = want[0]
    np.testing.assert_array_equal(got[0], hit)
    assert 50 < hit.sum() < 400
    np.testing.assert_allclose(got[1][hit], want[1][hit], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[3][hit], want[3][hit])


def _brute_force(pos, rgb, origin, direction):
    """Nearest voxel hit by direct slab tests (voxel ``p`` occupies
    ``[p/2, (p+1)/2)``): (hit, time, color, normal)."""
    lo = pos.astype(np.float64) / 2.0
    hi = lo + 0.5
    inv = 1.0 / direction
    t0, t1 = (lo - origin) * inv, (hi - origin) * inv
    tmin, tmax = np.minimum(t0, t1), np.maximum(t0, t1)
    entry_ax = np.argmax(tmin, axis=1)
    entry, exit_ = tmin.max(axis=1), tmax.min(axis=1)
    ok = (exit_ >= 0) & (entry < exit_)
    if not ok.any():
        return False, 0.0, None, None
    idx = np.flatnonzero(ok)[np.argmin(entry[ok])]
    normal = np.zeros(3)
    normal[entry_ax[idx]] = -np.sign(direction[entry_ax[idx]])
    return True, entry[idx], rgb[idx] / 255.0, normal


def test_cast_ray_matches_brute_force():
    rng = np.random.default_rng(11)
    pos, rgb = _random_scene(rng)
    tree = build_octree(_voxel_list(pos, rgb))
    origins, dirs = _rays(rng, 300)
    hit, time, color, normal = _cast_port(tree, origins, dirs)
    mismatches = 0
    for k in range(len(origins)):
        bf_hit, bf_t, bf_c, bf_n = _brute_force(
            pos, rgb, origins[k].astype(np.float64),
            dirs[k].astype(np.float64))
        if bf_hit != bool(hit[k]):
            mismatches += 1
            continue
        if bf_hit:
            assert abs(bf_t - time[k]) < 1e-3, (k, bf_t, time[k])
            np.testing.assert_allclose(color[k], bf_c, atol=1e-6)
            np.testing.assert_allclose(normal[k], bf_n, atol=0)
    assert mismatches == 0  # measured 0 on this seed


@pytest.mark.parametrize(
    "name, pos, direction, size, light",
    [
        ("8x8x8", (6.0, 5.0, -8.0), (0.0, 0.0, 1.0), (24, 16),
         ((4.0, 8.0, -6.0), 60.0)),
        ("menger", (90.0, 70.0, -40.0), (-0.45, -0.5, 1.0), (64, 36),
         ((0.4, -0.4, 0.02), 0.05)),
        ("chr_knight", (9.0, 7.0, 9.0), (-8.0, -6.5, -8.5), (48, 32),
         ((4.0, 8.0, -6.0), 60.0)),
    ],
    ids=["8x8x8", "menger", "chr_knight"],
)
def test_render_scene_matches_reference(name, pos, direction, size, light):
    jwhitted = _jax("ops.whitted")
    jcamera = _jax("engine.camera")
    kw = dict(position=np.array(pos), direction=np.array(direction))
    w, h = size
    want = np.asarray(jwhitted.render_scene(
        _jax("app.cli").load_voxels(name), jcamera.Camera(**kw), w, h,
        light_pos=light[0], light_brightness=light[1]))
    got = whitted.render_scene(load_voxels(name), Camera(**kw), w, h,
                               light_pos=light[0], light_brightness=light[1],
                               device="cpu").numpy()
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    sky = _sky(Camera(**kw), w, h)
    assert (got != sky).any(-1).mean() > 0.05  # the scene is in view


def _sky(cam, w, h):
    empty = VoxelList(pos=np.zeros((0, 3), np.int16),
                      mrgb=np.zeros((0, 4), np.uint8))
    return whitted.render_scene(empty, cam, w, h, device="cpu").numpy()


def test_render_background_is_abs_dir():
    """An empty scene: every pixel is abs(normalised ray direction)
    (basic.frag:269), as the reference's ``render_whitted`` draws it."""
    cam = Camera(position=np.array([0.0, 0.0, -6.0]))
    right, up, forward = cam.axis_scaled(16, 16)
    img = _sky(cam, 16, 16)
    d = 8.5 * right - 3.5 * up + forward
    np.testing.assert_allclose(img[3, 8], np.abs(d / np.linalg.norm(d)),
                               atol=1e-6)
    jwhitted = _jax("ops.whitted")
    jnp = pytest.importorskip("jax").numpy
    empty = build_octree(VoxelList(pos=np.zeros((0, 3), np.int16),
                                   mrgb=np.zeros((0, 4), np.uint8)))
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    want = np.asarray(jwhitted.render_whitted(
        jnp.asarray(empty), f32(cam.position), f32(right), f32(up),
        f32(forward), jnp.zeros(3, jnp.float32), jnp.float32(0.05),
        width=16, height=16))
    np.testing.assert_allclose(img, want, rtol=0, atol=1e-6)


def test_shading_formula_point_light():
    """One voxel; the diffuse, shadow-free formula (basic.frag:254-267)
    against a direct numpy evaluation."""
    rgb = np.array([[200, 100, 50]])
    vl = _voxel_list(np.array([[0, 0, 0]]), rgb)
    cam = Camera(position=np.array([0.25, 0.25, -4.0]),
                 direction=np.array([0.0, 0.0, 1.0]))
    w = h = 9
    img = whitted.render_scene(vl, cam, w, h, light_pos=(0.25, 0.25, -2.0),
                               light_brightness=2.0, device="cpu").numpy()
    right, up, forward = cam.axis_scaled(w, h)
    cx = w // 2
    d = (cx + 0.5) * right - (cx + 0.5) * up + forward
    d = d / np.linalg.norm(d)
    t = (0.0 - cam.position[2]) / d[2]
    to_hit = cam.position + d * (0.99999 * t) - np.array([0.25, 0.25, -2.0])
    dist = np.linalg.norm(to_hit)
    diffuse = (0.8 * 2.0 * max(0.0, np.dot(-to_hit / dist, [0, 0, -1.0]))
               / dist**2)
    np.testing.assert_allclose(img[cx, cx], (rgb[0] / 255.0) * (0.2 + diffuse),
                               rtol=1e-4)


def test_shadow_darkens():
    """A floor slab and a blocker under the light: the shadowed texel
    takes the 0.3 * diffuse arm (basic.frag:266)."""
    floor = [(x, -2, z) for x in range(-4, 5) for z in range(-4, 5)]
    pos = np.array(floor + [(0, 2, 0)])
    vl = _voxel_list(pos, np.full((len(pos), 3), 180))
    cam = Camera(position=np.array([0.1, 3.0, -5.0]),
                 direction=np.array([0.0, -0.55, 1.0]))
    img = whitted.render_scene(vl, cam, 65, 65, light_pos=(0.25, 3.0, 0.25),
                               light_brightness=6.0, device="cpu").numpy()
    assert np.isfinite(img).all()
    lum = img.sum(axis=2)
    sky = _sky(cam, 65, 65).sum(axis=2)
    hit = lum != sky
    assert hit.any() and lum[hit].min() < 0.6 * lum[hit].max()


def test_cli_legacy_whitted_writes_the_reference_png(tmp_path):
    jcli = _jax("app.cli")
    argv = ["--scene", "8x8x8", "--legacy-whitted", "--size", "24x16",
            "--camera-pos", "6,5,-8", "--light", "4,8,-6,60"]
    port, ref = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert cli.main(["--device", "cpu", *argv, "-o", port]) == 0
    assert jcli.main([*argv, "-o", ref]) == 0
    with open(port, "rb") as a, open(ref, "rb") as b:
        data = a.read()
        assert data == b.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_legacy_whitted_frames_the_path_camera(tmp_path):
    """Without --camera-pos the still is taken from the path's first
    pose, as the reference's CLI takes it."""
    out = str(tmp_path / "w.png")
    assert cli.main(["--device", "cpu", "--legacy-whitted", "--scene",
                     "chr_knight", "--size", "32x20", "--path", "orbit",
                     "-o", out]) == 0
    assert os.path.getsize(out) > 100


@pytest.mark.cuda
def test_whitted_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    scene = load_scene("menger")
    cam = camera_paths.static(scene)(0.0)
    voxels = load_voxels("menger")
    card = whitted.render_scene(voxels, cam, 160, 90, device="cuda")
    host = whitted.render_scene(voxels, cam, 160, 90, device="cpu")
    assert card.device.type == "cuda"
    err = float((card.cpu() - host).abs().max())
    assert err <= 1e-5, err
    assert (host.numpy() != _sky(cam, 160, 90)).any(-1).mean() > 0.05
