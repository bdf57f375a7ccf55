"""The port's blue-noise baker (``voxtracer_torch/ops/bluenoise.py``) on
the CPU: the JAX test's bar (``tests/test_noise.py:33-56``: a permutation
of (rank + 0.5) / N with a blue spectrum) on the port's own bake, the
energy and the kernel against the JAX package's, the same algorithm as
the JAX package's from its own initial patterns, and ``cached_buffer``'s
file scheme.  The frames keep loading the shipped asset
(``ops/noise.py``); a bake is not that asset (``torch.Generator`` is not
``jax.random``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.ops import bluenoise as jbluenoise
from voxtracer_torch.ops import bluenoise
from voxtracer_torch.ops import noise as noise_op


def _assert_blue_noise(noise, count, size):
    """The JAX test's bar (tests/test_noise.py:40-56)."""
    assert noise.shape == (count, size, size) and noise.dtype == np.float32
    n = size * size
    for s in range(count):
        vals = np.sort(noise[s].reshape(-1))
        np.testing.assert_allclose(vals, (np.arange(n) + 0.5) / n, atol=1e-6)
    pat = (noise[0] < 0.25).astype(np.float64)
    pat -= pat.mean()
    spec = np.abs(np.fft.fft2(pat)) ** 2
    freq = np.fft.fftfreq(size)
    fy, fx = np.meshgrid(freq, freq, indexing="ij")
    rad = np.sqrt(fy**2 + fx**2)
    low = spec[(rad < 0.15) & (rad > 0)].mean()
    high = spec[rad > 0.3].mean()
    assert high > 2.0 * low, f"not blue: low {low}, high {high}"


def test_bluenoise_small():
    """The JAX test's bake, ``generate(count=2, size=16, seed=1)``, on
    the port (the CPU)."""
    _assert_blue_noise(bluenoise.generate(count=2, size=16, seed=1,
                                          device="cpu"), 2, 16)


def test_bake_is_seeded():
    """One seed, one bake; another seed, another."""
    a = bluenoise.generate(2, 16, seed=3, device="cpu")
    np.testing.assert_array_equal(a, bluenoise.generate(2, 16, seed=3,
                                                        device="cpu"))
    assert not np.array_equal(a, bluenoise.generate(2, 16, seed=4,
                                                    device="cpu"))


def test_wrapped_gaussian_equals_the_jax_packages():
    for size in (16, 128):
        np.testing.assert_array_equal(
            bluenoise._wrapped_gaussian(size, bluenoise.SIGMA),
            jbluenoise._wrapped_gaussian(size, jbluenoise.SIGMA))


@pytest.mark.parametrize("size", [16, 128])
def test_energy_matches_the_jax_packages(size):
    """A random pattern's energy (the FFT convolution at each phase's
    start) within 1e-5 absolute of the JAX package's formula
    (``voxtracer/ops/bluenoise.py`` ``energy_of``)."""
    pattern = (np.random.default_rng(size).random((size, size)) < 0.1
               ).astype(np.int32)
    kernel = jbluenoise._wrapped_gaussian(size, jbluenoise.SIGMA)
    ref = np.asarray(jnp.fft.irfft2(
        jnp.fft.rfft2(jnp.asarray(kernel))
        * jnp.fft.rfft2(jnp.asarray(pattern, jnp.float32)),
        s=pattern.shape))
    got = bluenoise.energy_of(torch.from_numpy(pattern),
                              torch.from_numpy(kernel)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size, count, seed", [(16, 2, 1), (32, 2, 5)])
def test_same_ranks_as_the_jax_package_from_its_initial_patterns(
        size, count, seed):
    """From the JAX package's own initial patterns (its
    ``jax.random.permutation`` of each slice's key) the port ranks like
    it: where the two FFTs round two energies into another order, a pair
    of ranks swaps.  Measured: 2 of 512 and 15 of 2048 values differ;
    a different algorithm would differ almost everywhere."""
    n = size * size
    n1 = max(1, int(n * 0.1))
    keys = jax.random.split(jax.random.PRNGKey(seed), count)
    initial = np.zeros((count, n), np.int32)
    for b in range(count):
        initial[b, np.asarray(jax.random.permutation(keys[b], n)[:n1])] = 1
    ref = jbluenoise.generate(count, size, seed)
    got = bluenoise.generate(count, size, seed, device="cpu",
                             initial=initial.reshape(count, size, size))
    _assert_blue_noise(got, count, size)
    assert (got != ref).mean() < 0.02


def test_generate_refuses_a_wrong_initial_pattern():
    with pytest.raises(ValueError, match="initial"):
        bluenoise.generate(1, 16, device="cpu",
                           initial=np.ones((1, 16, 16), np.int32))


def test_cached_buffer_loads_an_existing_file_without_baking(
        tmp_path, monkeypatch):
    """An existing file of the scheme's name is loaded, never baked."""
    noise = np.random.default_rng(0).random((4, 8, 8)).astype(np.float32)
    np.savez_compressed(tmp_path / "bluenoise-8x8x4-s2.npz", noise=noise)

    def no_bake(*a, **kw):
        raise AssertionError("baked")

    monkeypatch.setattr(bluenoise, "generate", no_bake)
    got = bluenoise.cached_buffer(4, 8, seed=2, cache_dir=str(tmp_path))
    np.testing.assert_array_equal(got, noise)


def test_cached_buffer_bakes_a_missing_file_once(tmp_path):
    """A missing file is baked on the given device, saved under the
    scheme's name, and loaded the next time."""
    a = bluenoise.cached_buffer(2, 16, seed=1, cache_dir=str(tmp_path),
                                device="cpu")
    assert os.path.exists(tmp_path / "bluenoise-16x16x2-s1.npz")
    _assert_blue_noise(a, 2, 16)
    np.testing.assert_array_equal(
        a, bluenoise.cached_buffer(2, 16, seed=1, cache_dir=str(tmp_path)))


def test_default_cache_is_the_shipped_asset():
    """``cached_buffer()``'s default file is the asset the frames load,
    the JAX package's (no bake: it ships)."""
    shipped = noise_op.blue_noise_buffer()
    got = bluenoise.cached_buffer()
    assert got.tobytes() == shipped.tobytes()
    assert got.tobytes() == jbluenoise.cached_buffer().tobytes()
