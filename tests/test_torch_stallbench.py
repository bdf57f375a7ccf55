"""The port's stall microbenchmark: its plain torch version (the
reference the CUDA kernel is held against) vs the JAX package's Pallas
kernel ``voxtracer.app.stallbench._make_kernel`` run in interpret mode,
with the specs of its ``run_case``.  Integer arithmetic: exact equality.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from voxtracer.app import stallbench as jstall
from voxtracer_torch.app import stallbench

TRIPS = 8


def _pallas(tab, x, trips, mode, h, pre, mid):
    kernel = jstall._make_kernel(trips, mode, h, pre, mid)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((jstall.TILE_H, jstall.TILE_W),
                                       jnp.int32),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(tab), jnp.asarray(x))
    return np.asarray(out)


@pytest.mark.parametrize(
    "case",
    ["static:1", "static:2:0:2", "ser:1", "ser:2:0:3", "ser:4:2:1", "ind:2",
     "ind:4:1:2"],
)
def test_plain_matches_interpreted_pallas_kernel(case):
    mode, h, pre, mid = stallbench.parse_case(case)
    tab, x = stallbench.make_inputs("cpu")
    got = stallbench.run_plain(tab, x, TRIPS, mode, h, pre, mid)
    want = _pallas(tab.numpy(), x.numpy(), TRIPS, mode, h, pre, mid)
    assert got.dtype == torch.int32 and got.shape == (32, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    if pre + mid:
        # the chains' int32 wrap is exercised: about half the words are
        # negative
        assert 0.25 < (want < 0).mean() < 0.75


def test_inputs_are_the_reference_draws():
    rng = np.random.default_rng(7)
    tab, x = stallbench.make_inputs("cpu")
    np.testing.assert_array_equal(
        tab.numpy(), rng.integers(0, 1 << 20, size=(256, 128), dtype=np.int32))
    np.testing.assert_array_equal(
        x.numpy(), rng.integers(0, 1 << 20, size=(32, 128), dtype=np.int32))


@pytest.mark.parametrize(
    "text, want",
    [("ser:1", ("ser", 1, 0, 0)), ("static:2:128", ("static", 2, 128, 0)),
     ("ind:4:1:2", ("ind", 4, 1, 2))],
)
def test_parse_case(text, want):
    assert stallbench.parse_case(text) == want


@pytest.mark.parametrize("text", ["ser", "warp:1", "ser:1:2:3:4", "ser:x"])
def test_parse_case_rejects(text):
    with pytest.raises(ValueError):
        stallbench.parse_case(text)


def test_default_matrix_is_the_reference_matrix():
    cases = stallbench.default_cases()
    assert len(cases) == 18 and len(set(cases)) == 18
    assert cases[:3] == [("static", 1, 0, 0), ("static", 2, 0, 0),
                         ("static", 4, 0, 0)]


def test_refusals():
    tab, x = stallbench.make_inputs("cpu")
    with pytest.raises(ValueError, match="CUDA kernel"):
        stallbench.run_cuda(tab, x, 1, "ser", 1, 0, 0)
    with pytest.raises(ValueError, match="h must be"):
        stallbench.run_plain(tab, x, 1, "ser", 9, 0, 0)
    with pytest.raises(ValueError, match="mode"):
        stallbench.run_plain(tab, x, 1, "warp", 1, 0, 0)


def test_stall_columns_pair_each_case_with_its_own_static(monkeypatch, capsys):
    """In the default matrix ``ser:1:0:64`` runs before ``static:1:0:64``;
    its stall is still taken against that static case, not against
    ``static:1``.  (Cycles faked: static = 1000 h + 10 (pre + mid), and
    a handoff 300 more.)"""
    def fake_case(mode, h, pre, mid, trips, reps):
        cycles = 1000 * h + 10 * (pre + mid) + (0 if mode == "static" else
                                                300 * h)
        return dict(mode=mode, h=h, pre=pre, mid=mid, ms=1.0,
                    cycles_per_trip=float(cycles))

    monkeypatch.setattr(stallbench, "run_case", fake_case)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert stallbench.main(["--json"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(rows) == 18
    for r in rows:
        if r["mode"] == "static":
            assert "stall_cycles_per_handoff" not in r
        else:
            assert r["stall_cycles_per_handoff"] == 300.0, r


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(SystemExit, match="CUDA"):
        stallbench.main(["--case", "ser:1", "--trips", "1"])


def _ladder_sweep(tab, waddr, base, win=jstall.WIN):
    """The Pallas kernel's sweep (``_make_kernel``'s ``sweep``, the
    ``_serve_loop`` ladder) in numpy, step by step: the window's rows
    broadcast one by one, the column gathered, the word selected where
    the row matches."""
    window = tab[base:base + win, :]
    rows = waddr >> 7
    off = rows - base
    col = waddr & 127
    word = np.zeros_like(waddr)
    for s8 in range(win):
        row_b = np.broadcast_to(window[s8:s8 + 1, :], waddr.shape)
        g = np.take_along_axis(row_b, col, axis=1)
        word = np.where(off == s8, g, word)
    return word


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ladder_sweep_equals_one_guarded_gather(seed):
    """The TPU's 24-row ladder yields the one word that ``_sweep`` and
    the CUDA kernel's guarded gather (``tab[waddr]`` where
    ``(unsigned)(row - base) < 24``, else 0) fetch, for every base the
    kernel can take, with rows inside and outside the window."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(-2**31, 2**31, size=(256, 128), dtype=np.int32)
    waddr = rng.integers(0, 256 * 128, size=(32, 128), dtype=np.int32)
    ttab, twaddr = torch.from_numpy(tab), torch.from_numpy(waddr)
    inside = 0
    for base in range(256 - jstall.WIN + 1):
        want = _ladder_sweep(tab, waddr, base)
        guarded = np.where(
            ((waddr >> 7) - base).astype(np.uint32) < jstall.WIN,
            tab.reshape(-1)[waddr], 0)
        np.testing.assert_array_equal(guarded, want)
        for b in (base, torch.tensor(base, dtype=torch.int32)):
            np.testing.assert_array_equal(
                stallbench._sweep(ttab, twaddr, b).numpy(), want)
        hit = ((waddr >> 7) - base >= 0) & ((waddr >> 7) - base < 24)
        assert 0 < hit.sum() < hit.size
        inside += hit.sum()
    assert inside > 0


_EXTREMES = [-2**31, -2**31 + 1, -32769, -32768, -32767, -1, 0, 1, 32767,
             32768, 32769, 2**31 - 2, 2**31 - 1]


def _int32_values():
    rng = np.random.default_rng(3)
    return np.concatenate([
        np.array(_EXTREMES, dtype=np.int32),
        rng.integers(-2**31, 2**31, size=100_000, dtype=np.int32)])


def test_floor_mod_by_2_15_is_a_mask_numpy():
    """The kernel's ``& 32767`` equals the floor-mod by 32768 of the
    reference (numpy's ``%``), the old kernel's C form ``((a % m) + m) %
    m`` with truncating ``%``, and the mask of the uint32 bits."""
    v, m = _int32_values(), 32768
    want = v & 32767
    np.testing.assert_array_equal(((v % m) + m) % m, want)
    np.testing.assert_array_equal(np.fmod(np.fmod(v, m) + m, m), want)
    np.testing.assert_array_equal(v.view(np.uint32) & 32767, want)
    assert want.min() == 0 and want.max() == 32767


def test_floor_mod_by_2_15_is_a_mask_torch():
    """The same in torch, whose ``%`` is the plain version's, and for
    the ``ind`` address, whose int32 wrap the mask makes moot."""
    v, m = torch.from_numpy(_int32_values()), 32768
    want = v & 32767
    assert torch.equal(((v % m) + m) % m, want)
    assert torch.equal(torch.fmod(torch.fmod(v, m) + m, m), want)
    for c in range(stallbench.MAX_H):
        raw = (v >> 1).to(torch.int64) * (2 * c + 1) + 131 * c
        assert torch.equal(stallbench._wrap(raw) % m, (raw & 32767).int())


T = 1000


@pytest.mark.parametrize("case, ops_per_trip", [
    # the address: multiply-add, mask; the sweep with the base folded into
    # the address: compare, predicated load, predicated xor; the fold:
    # shift, xor
    ("static:1", 2 + 3 + 2),
    # chains: 3 ahead, 5 after each of the 2 reduces, a multiply-add each;
    # per sweep the address, half a minimum (three-input minima), the
    # offset from the base and its compare, the load and the xor
    ("ser:2:3:5", 3 + 2 * 5 + 2 * (2 + 0.5 + 4) + 2),
    # one shift of x for the 3 addresses after the first; per minimum the
    # address, half a minimum, the offset, compare, load and xor into x
    ("ind:4", 1 + 4 * (2 + 0.5 + 4) + 2),
])
def test_stall_work_is_the_hand_count(case, ops_per_trip):
    mode, h, pre, mid = stallbench.parse_case(case)
    work = stallbench.stall_work(T, mode, h, pre, mid)
    # once: y's seed and the output's sum
    assert work == dict(ops=4096 * (T * ops_per_trip + 2),
                        words=4096 * T * h)


def test_stall_bound_is_one_sm():
    """ser:1 at 16,384 trips: operations over one SM's issue rate (128
    lane operations a clock at 1.98 GHz), above its gathers over one
    SM's shared memory; the whole card's figure 132 times less."""
    ms, by, card_ms = stallbench.stall_bound(16384, "ser", 1, 0, 0)
    ops = 4096 * (16384 * 8.5 + 2)
    assert by == "operations"
    assert ms == pytest.approx(ops / (33.5e12 / 132) * 1e3)
    assert 2.2 < ms < 2.3 and card_ms == pytest.approx(ms / 132)
    words_ms = 4096 * 16384 * 4 / (128 * 1.98e9) * 1e3
    assert words_ms < ms / 2


@pytest.mark.parametrize("mode", stallbench.MODES)
def test_stall_bound_words_never_bind(mode):
    """The gathers' term counts a word for every element and sweep, more
    than a run's data needs; the operations' term is above it in every
    mode and h, so the bound is the same as with the data's own count."""
    for h in range(1, stallbench.MAX_H + 1):
        w = stallbench.stall_work(1, mode, h, 0, 0)
        ops_clocks = (w["ops"] - 2 * 4096) / 128
        words_clocks = w["words"] * 4 / 128
        assert ops_clocks > words_clocks * 1.2, (h, ops_clocks, words_clocks)


def test_cli_rows_carry_bound_and_share(monkeypatch, capsys):
    def fake_case(mode, h, pre, mid, trips, reps):
        return dict(mode=mode, h=h, pre=pre, mid=mid, ms=2.0,
                    cycles_per_trip=1000.0 * h)

    monkeypatch.setattr(stallbench, "run_case", fake_case)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert stallbench.main(["--json", "--trips", "100", "--case", "ser:1",
                            "--case", "static:1"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    for r in rows:
        ms, by, card_ms = stallbench.stall_bound(100, r["mode"], 1, 0, 0)
        assert r["bound_ms"] == round(ms, 4) and r["bound_by"] == by
        assert r["share"] == round(ms / 2.0, 4)
        assert r["bound_card_ms"] == round(card_ms, 6)


def test_launch_refuses_cpu_tensors_before_loading(monkeypatch):
    from voxtracer_torch.ops import _build

    def load():
        raise AssertionError("a CPU tensor must not build the kernels")

    monkeypatch.setattr(_build, "load", load)
    tab, x = stallbench.make_inputs("cpu")
    with pytest.raises(ValueError, match="CUDA kernel"):
        stallbench.run_cuda(tab, x, 1, "ser", 1, 0, 0)


def test_check_cases_reach_every_mode_max_h_odd_trips_and_long_chains():
    cases = stallbench.check_cases()
    assert {(m, h) for _, m, h, _, _ in cases} >= {
        (m, h) for m in stallbench.MODES for h in (1, 2, 4, stallbench.MAX_H)}
    assert any(t % 2 for t, *_ in cases)
    assert ("ind", 512, 256) in {(m, p, q) for _, m, _, p, q in cases}
    for case in cases:
        stallbench._check(*stallbench.make_inputs("cpu"), *case)


def _perf_table_shares():
    """Every number in the share column of PERF.md's kernel table."""
    import pathlib
    import re

    text = (pathlib.Path(__file__).parents[1] / "PERF.md").read_text()
    lines = text.split("### Every TPU kernel", 1)[1].splitlines()
    cells = [re.split(r"(?<!\\)\|", ln) for ln in lines
             if ln.startswith("| ")]  # "\|" is a pipe inside a cell
    col = [c.strip() for c in cells[0]].index("share")
    return {int(r[1]): [float(v) for v in re.findall(r"\d+\.\d+", r[col])]
            for r in cells if r[1].strip().isdigit()}


def test_perf_md_shares_are_at_most_one():
    """A bound is the least time the card could take: no share recorded
    against it in PERF.md's kernel table may exceed 1."""
    shares = _perf_table_shares()
    assert sorted(shares) == [1, 2, 3, 4, 5, 6]
    assert all(shares.values())
    for row, values in shares.items():
        assert max(values) <= 1.0, (row, values)


def test_byte_offsets_are_four_times_the_address():
    """The CUDA kernel's byte offsets of the sweep addresses, in uint32
    as it computes them: ``(x * 2 + 524 c) & 0x1fffc`` (ser, static) and
    ``((x >> 1) * (8 c + 4) + 524 c) & 0x1fffc`` (ind) are 4 x the
    reference's addresses, and their smallest row (``bytes >> 9``) the
    reference's minimum."""
    x = _int32_values()
    ux = x.view(np.uint32)
    with np.errstate(over="ignore"):
        for c in range(stallbench.MAX_H):
            want = ((x >> 1) + 131 * c) % 32768
            got = (ux * np.uint32(2) + np.uint32(524 * c)) & np.uint32(0x1FFFC)
            np.testing.assert_array_equal(got, 4 * want)
            raw = (x >> 1).astype(np.int64) * (2 * c + 1) + 131 * c
            want = stallbench._wrap(torch.from_numpy(raw)).numpy() % 32768
            got = (((x >> 1).view(np.uint32) * np.uint32(8 * c + 4)
                    + np.uint32(524 * c)) & np.uint32(0x1FFFC))
            np.testing.assert_array_equal(got, 4 * want)
            assert got.min() >> 9 == (want >> 7).min()


@pytest.mark.parametrize("c", [0, 1, 7])
def test_window_tests_on_byte_offsets_select_the_reference_words(c):
    """The kernel's window tests, in uint32 as it computes them: static
    folds the base into the address, ``off = (x * 2 + 524 c - 512 base) &
    0x1fffc``, takes the word where ``off < 12288`` at ``512 base + off``
    (the byte offset itself there, no wrap); ser and ind subtract it from
    the byte offset, ``bytes - 512 base < 12288``.  Both give
    ``_sweep``'s word for every base the kernel can take."""
    x = _int32_values()[:20_000]
    ux = x.view(np.uint32)
    tab = np.random.default_rng(4).integers(
        -2**31, 2**31, size=(256, 128), dtype=np.int32)
    flat = tab.reshape(-1)
    waddr = ((x >> 1) + 131 * c) % 32768
    ttab, twaddr = torch.from_numpy(tab), torch.from_numpy(waddr)
    mask = np.uint32(0x1FFFC)
    with np.errstate(over="ignore"):
        nbytes = (ux * np.uint32(2) + np.uint32(524 * c)) & mask
        for base in range(256 - jstall.WIN + 1):
            want = stallbench._sweep(ttab, twaddr, base).numpy()
            bb = np.uint32(512 * base)
            off = (ux * np.uint32(2) + (np.uint32(524 * c) - bb)) & mask
            inside = off < 12288
            assert np.array_equal((bb + off)[inside], nbytes[inside])
            got = np.where(inside, flat[(((bb + off) & mask) >> 2)], 0)
            np.testing.assert_array_equal(got, want)
            ser_off = nbytes - bb
            np.testing.assert_array_equal(ser_off < 12288, inside)
            np.testing.assert_array_equal(
                np.where(ser_off < 12288, flat[nbytes >> 2], 0), want)
