"""Device pipeline (virtual 8-device CPU mesh) vs host numpy oracle."""
import numpy as np
import pytest

from gci_tpu.depth.accum import (
    GenomeLayout,
    accumulate_depth_numpy,
    depth_dict_from_flat,
)
from gci_tpu.depth.device import (
    build_scan_valid,
    depth_single,
    edges_to_intervals,
    interval_edges,
    make_sharded_depth_fn,
    make_sharded_interval_fn,
    pack_read_deltas,
    pack_read_deltas_sharded,
    two_type_max,
)
from gci_tpu.intervals import collapse_depth_dict
from gci_tpu.parallel import make_mesh, pad_to_multiple


TARGETS = {"c1": 5000, "c2": 3001, "c3": 57}  # c3 shorter than 2*flank


def _random_reads(rng, n):
    names = list(TARGETS)
    tid = rng.integers(0, len(names), size=n)
    lens = np.array([TARGETS[t] for t in names])
    start = (rng.random(n) * np.maximum(lens[tid] - 30, 1)).astype(np.int64)
    end = start + rng.integers(5, 4000, size=n)
    end = np.minimum(end, lens[tid])
    return tid.astype(np.int64), start, end


def test_depth_single_matches_numpy(rng):
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _random_reads(rng, 700)
    want = accumulate_depth_numpy(layout, tid, start, end, 15)
    gs, ge, live = pack_read_deltas(layout, tid, start, end, 15)
    got = np.asarray(depth_single(gs, ge, live, layout.total_slots))
    np.testing.assert_array_equal(got, want)


def test_interval_edges_single_match_collapse(rng):
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _random_reads(rng, 300)
    flat = accumulate_depth_numpy(layout, tid, start, end, 15)
    valid = build_scan_valid(layout, 15)
    m, rise, fall = interval_edges(flat, valid, -1, 0)
    got = edges_to_intervals(layout, np.asarray(rise), np.asarray(fall), np.asarray(m), 15)
    want = collapse_depth_dict(depth_dict_from_flat(layout, flat), -1, 0, 15, 0)
    assert got == want


@pytest.mark.parametrize("n_devices", [8])
def test_sharded_depth_and_intervals(rng, n_devices):
    import jax

    if len(jax.devices()) < n_devices:
        pytest.skip("need 8 virtual devices")
    mesh = make_mesh(n_devices)
    gp, dp = mesh.shape["gp"], mesh.shape["dp"]
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _random_reads(rng, 500)
    want_flat = accumulate_depth_numpy(layout, tid, start, end, 15)

    total = layout.total_slots
    pad_total = total + ((-total) % gp)
    packed = pack_read_deltas_sharded(layout, tid, start, end, 15, pad_total // gp)
    packed = tuple(
        pad_to_multiple(a, dp, fill=f) for a, f in zip(packed, (-1, 0, -1, 0, 0))
    )
    valid = np.zeros(pad_total, dtype=bool)
    valid[:total] = build_scan_valid(layout, 15)

    import jax.numpy as jnp

    depth_fn = make_sharded_depth_fn(mesh, pad_total)
    interval_fn = make_sharded_interval_fn(mesh, pad_total)
    with mesh:
        depth = depth_fn(*(jnp.asarray(a) for a in packed))
        rise, fall = interval_fn(
            depth, jnp.asarray(valid),
            jnp.asarray([-1], dtype=jnp.int32), jnp.asarray([0], dtype=jnp.int32),
        )
    np.testing.assert_array_equal(np.asarray(depth)[:total], want_flat)
    got = edges_to_intervals(layout, np.asarray(rise), np.asarray(fall), None, 15)
    want = collapse_depth_dict(depth_dict_from_flat(layout, want_flat), -1, 0, 15, 0)
    assert got == want


def test_two_type_max_device(rng):
    a = rng.integers(0, 50, size=1000).astype(np.int32)
    b = rng.integers(0, 50, size=1000).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(two_type_max(a, b)), np.maximum(a, b))


def test_graft_entry_smoke():
    import jax

    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out[0].shape[0] > 0
    ge.dryrun_multichip(8)


def test_streamed_depth_matches_numpy(rng):
    from gci_tpu.depth.streamed import accumulate_depth_streamed

    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _random_reads(rng, 400)
    want = accumulate_depth_numpy(layout, tid, start, end, 15)
    # tiny chunks force many boundaries + carries; jnp-cumsum kernel on CPU
    got = accumulate_depth_streamed(
        layout, tid, start, end, 15, chunk_slots=1000
    )
    np.testing.assert_array_equal(got, want)
