"""Whole runs of each cell on the CPU at a tiny size (the harness's look
for a card skipped), sound and with the timed path broken underneath:
the sound run is correct, each fault is not."""

import pytest
import torch

from benchmark.harness import run_cell

from .conftest import CELLS

SEED = 2**31 + 77


def seconds(cell):
    """Long enough that the checked units come inside the window at the
    CPU's few frames a second (a unit of 3 or 4 frames takes about a
    second, and a unit may be kept as late as 0.9 of the window; a
    view waits for a pair of frames of its kind)."""
    return 20.0 if cell.endswith(".view") else 12.0

PLANES = ("accum_color", "accum_blend", "old_depth")


def state_unchanged(r):
    """Every call returns and leaves the carried state it was given."""
    for name in ("render", "render_burst", "render_sequence"):
        orig = getattr(r, name)

        def call(*a, _orig=orig, **k):
            before = {p: r.state[p] for p in PLANES}
            out = _orig(*a, **k)
            r.state.update(before)
            return out
        setattr(r, name, call)


def answer_altered(r):
    """Every image is altered where the program produces it."""
    orig_render, orig_seq = r.render, r.render_sequence
    orig_burst = r.render_burst

    def render(*a, **k):
        out = orig_render(*a, **k)
        out["image"] = out["image"] ^ 8
        return out
    r.render = render
    r.render_sequence = lambda *a, **k: orig_seq(*a, **k) ^ 8
    r.render_burst = lambda *a, **k: orig_burst(*a, **k) ^ 8


def half_left_out(r):
    """A burst or a sequence renders half of its frames; the rest of a
    sequence repeats its last frame."""
    orig_seq, orig_burst = r.render_sequence, r.render_burst

    def seq(cams, *a, **k):
        half = orig_seq(cams[:max(1, len(cams) // 2)], *a, **k)
        rest = half[-1:].expand(len(cams) - len(half), *half.shape[1:])
        r.frame_number += len(cams) - len(half)
        return torch.cat([half, rest])

    def burst(cam, n, *a, **k):
        out = orig_burst(cam, max(1, n // 2), *a, **k)
        r.frame_number += n - max(1, n // 2)
        return out
    r.render_sequence = seq
    r.render_burst = burst


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny_root):
    """The sound run is correct; the control (the reference in bfloat16
    in the program's place) comes out not correct by the same verdict."""
    res = run_cell(cell, SEED, seconds(cell), False, device="cpu",
                   root=tiny_root, control=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["control_correct"] is False, res["checks"]
    assert list(res)[-1] == "checks"


def sun_frozen(r):
    """Every frame at the first frame's ``RenderParams``: a change of
    ``render_params`` (the traffic's sun) is ignored."""
    first, orig = r.render_params, r.render

    def render(*a, **k):
        r.render_params = first
        return orig(*a, **k)
    r.render = render


FAULTS = [(c, state_unchanged) for c in CELLS] + [
    (c, answer_altered) for c in CELLS] + [
    ("menger720-r0.burst", half_left_out),
    ("monu9-1080-r2.export", half_left_out),
    ("castle4k-r0.sun", sun_frozen)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, tiny_root):
    res = run_cell(cell, SEED, seconds(cell), False, device="cpu", root=tiny_root,
                   hook=fault)
    assert not res["correct"], res["checks"]
