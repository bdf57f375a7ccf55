"""The port's scale probe (``voxtracer_torch/app/scaleprobe.py``) on the
CPU: its synthetic shell is bit-equal to the JAX package's (values,
origin, mips, every ``device_tables()`` array), it keeps the JAX test's
invariants (``tests/test_scaleprobe.py``), its frame agrees with the JAX
package's XLA renderer at the trace parity bar of
``tests/test_torch_trace.py``, and the scene tables refuse a scene the
trace kernel would address past int32."""

import contextlib
import io

import numpy as np
import pytest
import torch

from voxtracer.app.scaleprobe import synthetic_shell as jax_shell
from voxtracer.engine.camera import Camera as JCamera
from voxtracer.engine.pipeline import Renderer as JRenderer
from voxtracer_torch.app import scaleprobe
from voxtracer_torch.engine.pipeline import Renderer
from voxtracer_torch.engine.scene import (
    INT32_LIMIT,
    SceneTables,
    check_table_addressing,
)


@pytest.mark.parametrize("dims", [48, 64])
def test_shell_is_bit_equal_to_the_jax_packages(dims):
    """Values, origin, mips and every device table equal the JAX
    package's."""
    a, b = scaleprobe.synthetic_shell(dims), jax_shell(dims)
    assert a.values.dtype == b.values.dtype
    np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(a.origin, b.origin)
    assert len(a.mips) == len(b.mips)
    for ma, mb in zip(a.mips, b.mips):
        np.testing.assert_array_equal(ma, mb)
    ta, tb = a.device_tables(), b.device_tables()
    assert sorted(ta) == sorted(tb)
    for key in ta:
        va, vb = np.asarray(ta[key]), np.asarray(tb[key])
        assert va.dtype == vb.dtype and va.shape == vb.shape, key
        np.testing.assert_array_equal(va, vb, err_msg=key)


def test_synthetic_shell_invariants():
    """The JAX test's invariants (tests/test_scaleprobe.py:14-30)."""
    s = scaleprobe.synthetic_shell(48)
    assert s.values.shape == (48, 48, 48)
    assert tuple(s.origin) == (-23, -23, -23)
    occ = s.values != 0
    assert 0.01 < occ.mean() < 0.4
    assert (s.values[occ] < 0).all()
    t = s.device_tables()
    assert t["packed_idx"].shape[1] == 128
    np.testing.assert_array_equal(s.values,
                                  scaleprobe.synthetic_shell(48).values)


def test_plain_frame_matches_the_jax_xla_renderer():
    """The port's frame of the shell at 64x32 (the plain trace) against
    the JAX package's ``Renderer(trace_impl="xla")`` at the parity bar:
    node ids bit-exact, depth 1e-5 relative and absolute, normals exact,
    colour 1e-3, albedo 1e-6, u8 images within 1.  Measured: 0 node
    flips, depth 1.2e-5 at most (absolute), colour 2.4e-7, albedo 6e-8,
    images equal."""
    dims, w, h = 48, 64, 32
    cam = scaleprobe.shell_camera(dims)
    jcam = JCamera(position=cam.position, direction=cam.direction)
    ref = JRenderer(scene=jax_shell(dims), height=h, width=w,
                    trace_impl="xla").render(jcam)
    got = Renderer(scene=scaleprobe.synthetic_shell(dims), height=h, width=w,
                   device="cpu").render(cam)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    hit = ref["depth"] >= 0
    assert hit.any() and (~hit).any()
    assert int((ref["node"] != got["node"]).sum()) == 0
    np.testing.assert_allclose(got["depth"][hit], ref["depth"][hit],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["normal"], ref["normal"])
    np.testing.assert_allclose(got["linear"], ref["linear"], atol=1e-3)
    np.testing.assert_allclose(got["albedo"], ref["albedo"], atol=1e-6)
    diff = np.abs(got["image"].astype(int) - ref["image"].astype(int))
    assert diff.max() <= 1


def test_probe_on_the_cpu_reports_exact_agreement():
    """``--plain`` on the CPU compares the plain trace with itself: node
    agreement 1.0; the table bytes are the tables'."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = scaleprobe.probe(32, 32, 16, 1, torch.device("cpu"),
                               plain=True)
    assert res["node_agreement"] == 1.0 and res["disagreements"] == 0
    assert res["l2_bytes"] is None and res["trace_share"] is None
    tables = SceneTables(scaleprobe.synthetic_shell(32), "cpu")
    assert res["table_bytes"]["packed_idx"] == tables.packed_idx.numel() * 4


def test_node_agreement_breaks_down_the_flips():
    """Hit/miss flips and both-hit cell flips are told apart."""
    miss = scaleprobe.trace_op.MISS_NODE
    k = {"node": torch.tensor([[1, 2, miss, 4]]),
         "depth": torch.tensor([[1.0, 2.0, -1.0, 4.0]])}
    p = {"node": torch.tensor([[1, 3, 5, 4]]),
         "depth": torch.tensor([[1.0, 2.5, 3.0, 4.0]])}
    res = scaleprobe.node_agreement(k, p)
    assert res["node_agreement"] == 0.5 and res["disagreements"] == 2
    assert res["hit_miss_flips"] == 1 and res["both_hit_flips"] == 1
    assert res["depth_delta_max"] == 4.0


def _tables_of(dims, dedup=False):
    """A scene's geometry and table element counts (about what
    ``device_tables()`` builds) from its dims alone, without data."""
    X, Y, Z = dims
    zw = -(-Z // 3)
    l3 = tuple(-(-d // 4) for d in dims)
    cols = -(-X // 4) * -(-Y // 4) * 16
    l3_cols = -(-l3[0] // 4) * -(-l3[1] // 4) * 16
    numel = {"packed_idx": -(-cols * zw // 128) * 128,
             "meta_idx": -(-l3_cols * -(-l3[2] // 2) // 128) * 128,
             "brick_idx": (3 if dedup else 2) * l3_cols * l3[2],
             "palette": 1024}
    return dims, zw, l3, numel, dedup


@pytest.mark.parametrize("dims, name", [
    ((1872, 1872, 1872), "packed_idx"),
    ((4096, 4096, 400), "packed_idx"),
])
def test_tables_past_int32_are_refused(dims, name):
    """A scene whose fine table the kernel would address past 2^31 is
    refused with the table's name and size, from its shape alone."""
    with pytest.raises(ValueError, match=name) as err:
        check_table_addressing(*_tables_of(dims))
    assert "elements" in str(err.value) and "2^31" in str(err.value)


@pytest.mark.parametrize("dims", [(480, 480, 480), (1856, 1856, 1856)])
def test_tables_within_int32_pass(dims):
    """The probe's shell and a cube just inside the limit pass."""
    check_table_addressing(*_tables_of(dims))
    check_table_addressing(*_tables_of(dims, dedup=True))


def test_brick_and_meta_reach_are_checked():
    """A brick table whose planes reach 2^31 is refused too."""
    dims, zw, l3, numel, _ = _tables_of((64, 64, 64))
    numel = dict(numel, brick_idx=3 * (INT32_LIMIT // 3 + 1))
    with pytest.raises(ValueError, match="brick_idx"):
        check_table_addressing(dims, zw, l3, numel, True)
    numel = dict(_tables_of((64, 64, 64))[3], meta_idx=INT32_LIMIT)
    with pytest.raises(ValueError, match="meta_idx"):
        check_table_addressing(dims, zw, l3, numel, False)
