"""``voxtracer_torch.app.denoisebench``: its CLI on the CPU (the plain
version at tiny sizes) and its bound, against a hand count."""

import json

import pytest
import torch

from voxtracer_torch.app import denoisebench

KEYS = {"size", "radius", "planes", "taps", "ms_per_call",
        "us_per_tap_mpix", "bound_ms", "bound_by", "share", "device"}


def test_cli_prints_one_line_per_size_and_radius(capsys):
    assert denoisebench.main(["--device", "cpu", "--sizes", "12x8,5x3",
                              "--radii", "1,2,3", "--reps", "1"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(r["size"], r["radius"]) for r in rows] == [
        (s, r) for s in ("12x8", "5x3") for r in (1, 2, 3)]
    for row in rows:
        assert set(row) == KEYS and row["device"] == "cpu"
        assert row["planes"] == "random"
        w, h = (int(v) for v in row["size"].split("x"))
        assert row["taps"] == (2 * row["radius"] + 1) ** 2
        assert row["ms_per_call"] > 0
        assert row["us_per_tap_mpix"] == pytest.approx(
            row["ms_per_call"] * 1e3 / row["taps"] / (w * h / 1e6))
        assert (row["bound_ms"], row["bound_by"]) == denoisebench.denoise_bound(
            h, w, row["radius"])
        assert row["share"] == row["bound_ms"] / row["ms_per_call"]


def test_uniform_planes_make_every_tap_alike(capsys):
    """--planes uniform: every element equal (so every tap's range
    difference is 0, as between sky pixels), with the same bound."""
    colors, normal, depth, albedo, node, _ = denoisebench.make_inputs(
        6, 7, "cpu", planes="uniform")
    for t in (colors, normal, depth, albedo, node):
        assert (t == t.reshape(-1)[0]).all()
    assert denoisebench.main(["--device", "cpu", "--sizes", "7x6", "--radii",
                              "2", "--reps", "1", "--planes", "uniform"]) == 0
    (row,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert row["planes"] == "uniform"
    assert (row["bound_ms"], row["bound_by"]) == denoisebench.denoise_bound(
        6, 7, 2)


@pytest.mark.parametrize("radius, taps", [(1, 10 * 7), (2, 14 * 9)])
def test_bound_on_a_hand_counted_frame(radius, taps):
    """A 4x3 frame: at r = 1 its columns see 2, 3, 3, 2 in-frame offsets
    and its rows 2, 3, 2 (70 taps); at r = 2, 3, 4, 4, 3 and 3, 3, 3
    (126).  56 bytes a pixel; 39 operations a tap and 45 a pixel."""
    assert denoisebench.in_frame_taps(4, radius) * denoisebench.in_frame_taps(
        3, radius) == taps
    t_bytes = 56 * 12 / 3.35e12 * 1e3
    t_ops = (39 * taps + 45 * 12) / 67e12 * 1e3
    bound_ms, bound_by = denoisebench.denoise_bound(3, 4, radius)
    assert bound_ms == pytest.approx(max(t_bytes, t_ops), rel=1e-12)
    assert bound_by == ("bytes" if t_bytes >= t_ops else "operations")


def test_bound_turns_to_operations_at_large_radii():
    """1080p: bytes bound r = 1 and operations r = 8."""
    assert denoisebench.denoise_bound(1080, 1920, 1)[1] == "bytes"
    assert denoisebench.denoise_bound(1080, 1920, 8)[1] == "operations"


def test_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(SystemExit, match="CUDA"):
        denoisebench.main(["--sizes", "8x8", "--radii", "1"])
