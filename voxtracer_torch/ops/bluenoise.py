"""Blue-noise texture baking (void-and-cluster) in torch.

Counterpart of :mod:`voxtracer.ops.bluenoise`, which bakes with XLA
(``jax.vmap`` over ``while_loop`` / ``fori_loop``, no Pallas kernel), so
plain torch ops on the caller's device are its port.  Ulichney's
void-and-cluster method, batched over the slices:

1. a random initial pattern of ``initial_fraction`` ones is relaxed by
   moving the tightest cluster (the largest Gaussian energy among ones)
   into the largest void (the smallest among zeros) until a move goes
   nowhere, at most ``4 * n1`` moves;
2. ranks below the initial count come from deleting tightest clusters,
   ranks up to half from inserting into largest voids, the rest from
   deleting the tightest clusters of zeros (the inversion past half);
3. ``noise = (rank + 0.5) / N``: uniform values, a blue spectrum.

The energy of a pattern is its torus-wrapped convolution with the
Gaussian (an FFT at each phase's start); a toggle adds or takes off the
Gaussian rolled to the pixel.  Ties go to the first pixel in row-major
order, as ``jnp.argmax`` breaks them.

A buffer baked here is not the shipped asset
(``assets/generated/bluenoise-128x128x512-s0.npz``, which the frames
load through ``ops/noise.py``): ``torch.Generator`` is not
``jax.random``, so the initial patterns differ, and the two FFTs round
differently, so where two energies are close one flipped argmax changes
every rank after it.  It has the same properties (a permutation of the
ranks, a blue spectrum), not the same values.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

log = logging.getLogger("voxtracer_torch.ops.bluenoise")

SIGMA = 1.9
# how many relax moves run between two checks that some slice still moves
RELAX_CHECK = 32


def _wrapped_gaussian(size: int, sigma: float) -> np.ndarray:
    ax = np.arange(size)
    d = np.minimum(ax, size - ax).astype(np.float64)
    g1 = np.exp(-(d**2) / (2 * sigma**2))
    k = np.outer(g1, g1)
    k[0, 0] = 0.0  # self-energy excluded so argmax prefers neighbors
    return k.astype(np.float32)


def energy_of(pattern: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The torus-wrapped convolution of (..., S, S) patterns with the
    (S, S) ``kernel``, float32, by FFT."""
    kf = torch.fft.rfft2(kernel)
    pf = torch.fft.rfft2(pattern.to(torch.float32))
    return torch.fft.irfft2(kf * pf, s=pattern.shape[-2:])


def generate(
    count: int,
    size: int = 128,
    seed: int = 0,
    initial_fraction: float = 0.1,
    device="cuda",
    initial: np.ndarray | None = None,
) -> np.ndarray:
    """Bake ``count`` independent blue-noise slices on ``device`` ->
    (count, size, size) float32 in [0, 1).  The initial patterns come from
    one ``torch.Generator`` seeded with ``seed`` (on the CPU, so every
    device gets the same), or are ``initial``: (count, size, size) of 0 and
    1, ``int(size * size * initial_fraction)`` ones each."""
    device = torch.device(device)
    n = size * size
    n1 = max(1, int(n * initial_fraction))
    half = n // 2
    kflat = torch.from_numpy(_wrapped_gaussian(size, SIGMA)).to(device)
    kernel = kflat.reshape(size, size)
    kflat = kflat.reshape(-1)
    ar = torch.arange(size, device=device)
    batch = torch.arange(count, device=device)

    def rolled(idx):
        # the kernel rolled to each slice's pixel idx: k[(i - y) % S, (j - x) % S]
        y, x = (idx // size)[:, None, None], (idx % size)[:, None, None]
        return kflat[((ar[None, :, None] - y) % size) * size
                     + (ar[None, None, :] - x) % size]

    def tightest(ones, energy):
        return torch.where(ones > 0, energy, -torch.inf).reshape(
            count, -1).argmax(dim=1)

    def largest_void(ones, energy):
        return torch.where(ones > 0, torch.inf, energy).reshape(
            count, -1).argmin(dim=1)

    def put(pattern, idx, value, where=None):
        flat = pattern.reshape(count, -1)
        if where is None:
            flat[batch, idx] = value
        else:
            flat[batch, idx] = torch.where(where, value, flat[batch, idx])

    if initial is None:
        gen = torch.Generator().manual_seed(seed)
        pattern0 = torch.zeros((count, size, size), dtype=torch.int32,
                               device=device)
        for b in range(count):
            pattern0.reshape(count, -1)[b, torch.randperm(
                n, generator=gen)[:n1].to(device)] = 1
    else:
        pattern0 = torch.from_numpy(
            np.asarray(initial, np.int32).copy()).to(device)
        if pattern0.shape != (count, size, size) or bool(
                (pattern0.reshape(count, -1).sum(1) != n1).any()):
            raise ValueError(f"initial must be ({count}, {size}, {size}) "
                             f"with {n1} ones a slice")

    # relax: move the tightest cluster into the largest void until a move
    # goes nowhere; each slice stops on its own (masked), as under vmap
    energy = energy_of(pattern0, kernel)
    active = torch.ones(count, dtype=torch.bool, device=device)
    for i in range(4 * n1):
        if i % RELAX_CHECK == 0 and not bool(active.any()):
            break
        live = active[:, None, None]
        c = tightest(pattern0, energy)
        put(pattern0, c, 0, active)
        energy = torch.where(live, energy - rolled(c), energy)
        v = largest_void(pattern0, energy)
        put(pattern0, v, 1, active)
        energy = torch.where(live, energy + rolled(v), energy)
        active = active & (v != c)

    ranks = torch.zeros((count, size, size), dtype=torch.int32, device=device)
    # phase 1: delete tightest clusters, ranks n1 - 1 .. 0
    p1 = pattern0.clone()
    e1 = energy_of(p1, kernel)
    for i in range(n1):
        c = tightest(p1, e1)
        put(p1, c, 0)
        e1 = e1 - rolled(c)
        put(ranks, c, n1 - 1 - i)
    # phase 2: insert into largest voids, ranks n1 .. n / 2 - 1
    p2 = pattern0
    e2 = energy_of(p2, kernel)
    for i in range(half - n1):
        v = largest_void(p2, e2)
        put(p2, v, 1)
        e2 = e2 + rolled(v)
        put(ranks, v, n1 + i)
    # phase 3: past half, delete the tightest clusters of zeros
    e3 = energy_of(1 - p2, kernel)
    for i in range(n - half):
        z = tightest(1 - p2, e3)
        put(p2, z, 1)
        e3 = e3 - rolled(z)
        put(ranks, z, half + i)
    return ((ranks.to(torch.float32) + 0.5) / n).cpu().numpy()


def cached_buffer(
    count: int = 512,
    size: int = 128,
    seed: int = 0,
    cache_dir: str | None = None,
    device="cuda",
) -> np.ndarray:
    """Load the blue-noise buffer of this shape and seed from
    ``cache_dir`` (default ``assets/generated``, the reference's file
    name scheme), or bake it on ``device`` and save it there."""
    cache_dir = cache_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "assets",
        "generated",
    )
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(
        cache_dir, f"bluenoise-{size}x{size}x{count}-s{seed}.npz"
    )
    if os.path.exists(path):
        with np.load(path) as f:
            return f["noise"]
    log.info("baking blue noise %dx%dx%d ...", count, size, size)
    noise = generate(count, size, seed, device=device)
    np.savez_compressed(path, noise=noise)
    return noise
