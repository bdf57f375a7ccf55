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
