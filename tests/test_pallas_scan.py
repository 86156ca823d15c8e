"""Genome-axis scans: the Triton kernels (interpret mode on the CPU) and
their plain XLA references against the numpy oracle, the kernel choice and
padding, and the compiled kernels on a GPU (``gpu`` marker)."""
import subprocess
import sys

import numpy as np
import pytest

from gci_tpu.depth.scan import (
    BLOCK,
    fused_depth_scan_flags_xla,
    fused_depth_scan_packed_xla,
    pad_to_block,
    packed_scan_kernel,
    prefix_sum_kernel,
    use_kernel,
)


def _oracle(word, lo, hi):
    """numpy (raw_depth, flags) of a packed word axis."""
    sw = np.cumsum(word.astype(np.int64)).astype(np.int32)
    raw = sw >> 2
    gap = (sw & 2) != 0
    m = (np.where(gap, 0, raw) > lo) & (np.where(gap, 0, raw) <= hi) & ((sw & 1) != 0)
    prev = np.concatenate(([False], m[:-1]))
    change = np.concatenate(([True], raw[1:] != raw[:-1]))
    flags = (m & ~prev) + 2 * (~m & prev) + 4 * change + 8 * gap
    return raw, flags.astype(np.int8)


def _disjoint(rng, total, n):
    """(starts, stops) of sorted DISJOINT intervals (the packed word's
    precondition: gap/valid event prefix sums stay in {0, 1})."""
    cuts = np.sort(rng.choice(total, size=2 * n, replace=False))
    return cuts[0::2], cuts[1::2]


def _random_word(rng, total, n_reads=500, max_span=300):
    word = np.zeros(total, np.int32)
    idx = rng.integers(0, total, n_reads)
    np.add.at(word, idx, 1 << 2)
    np.add.at(
        word, np.minimum(idx + rng.integers(1, max_span, n_reads), total - 1),
        -(1 << 2),
    )
    gs, ge = _disjoint(rng, total, 12)
    np.add.at(word, gs, 2)
    np.add.at(word, ge, -2)
    vs, ve = _disjoint(rng, total, 8)
    np.add.at(word, vs, 1)
    np.add.at(word, ve, -1)
    return word


def _assert_scan(word, lo, hi, block):
    want = _oracle(word, lo, hi)
    for got in (
        packed_scan_kernel(word, lo, hi, block=block, interpret=True),
        fused_depth_scan_packed_xla(word, lo, hi),
    ):
        np.testing.assert_array_equal(np.asarray(got[0]), want[0])
        np.testing.assert_array_equal(np.asarray(got[1]), want[1])


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_fused_scan_matches_numpy(rng, block, n_chunks):
    """Kernel (interpret) and XLA reference == numpy, at several block
    counts."""
    total = n_chunks * block
    _assert_scan(_random_word(rng, total, 40, 60), -1, 0, block)


def test_fused_scan_chunk_boundary_run(rng):
    # a run spanning a block boundary must not produce spurious edges
    block = 128
    word = np.zeros(3 * block, np.int32)
    word[0] = 1  # valid everywhere, depth 0 everywhere -> one issue run
    depth, flags = packed_scan_kernel(word, -1, 0, block=block, interpret=True)
    rise = np.asarray(flags) & 1
    assert rise.sum() == 1 and rise[0] == 1
    assert (np.asarray(flags) & 2).sum() == 0
    _assert_scan(word, -1, 0, block)


def test_fused_scan_gap_at_block_boundary():
    # a gap covering the last slot of block 0 and the first of block 1:
    # the carry must bring the gap state into block 1
    block = 128
    word = np.zeros(2 * block, np.int32)
    word[0] = (3 << 2) + 1  # depth 3, valid everywhere
    word[block - 4] += 2
    word[block + 4] -= 2
    _assert_scan(word, -1, 0, block)
    _, flags = packed_scan_kernel(word, -1, 0, block=block, interpret=True)
    f = np.asarray(flags)
    assert f[block - 4] & 1 and f[block + 4] & 2  # masked issue run
    assert (f[block - 4 : block + 4] & 8).all()


def test_fused_scan_carry_into_first_element():
    # a depth change and a fall exactly at a block's first slot are seen
    # through the carry alone
    block = 128
    word = np.zeros(3 * block, np.int32)
    word[0] = 1
    word[block] = 1 << 2   # depth 0 -> 1 at block 1's first slot
    word[2 * block] = -(1 << 2)  # back to 0 at block 2's first slot
    _assert_scan(word, -1, 0, block)
    _, flags = packed_scan_kernel(word, -1, 0, block=block, interpret=True)
    f = np.asarray(flags)
    assert f[block] == 2 + 4 and f[2 * block] == 1 + 4


def test_fused_scan_large_magnitude_deltas(rng):
    # int32 wraparound of the block carries must match a plain cumsum
    block = 128
    x = rng.integers(-(2**23), 2**23, size=5 * block).astype(np.int32)
    got = prefix_sum_kernel(x, block=block, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.cumsum(x).astype(np.int32))


@pytest.mark.parametrize("n_blocks", [1, 2, 7])
def test_prefix_sum_kernel_matches_cumsum(rng, n_blocks):
    block = 256
    x = rng.integers(-3, 4, size=n_blocks * block).astype(np.int32)
    got = prefix_sum_kernel(x, block=block, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.cumsum(x))


def test_fused_scan_flags_matches_xla(rng):
    """Unpacked flags reference (gap+valid in one byte; rise/fall/change
    bits out) vs the numpy oracle, randomized."""
    for trial in range(6):
        total = int(rng.integers(1, 4)) * 1000
        delta = np.zeros(total, np.int32)
        idx = rng.integers(0, total, 500)
        np.add.at(delta, idx, 1)
        np.add.at(delta, np.minimum(idx + rng.integers(1, 300, 500), total - 1), -1)
        gap = (rng.random(total) < 0.1).astype(np.int8)
        valid = (rng.random(total) < 0.9).astype(np.int8)
        lo, hi = -1, int(rng.integers(0, 3))
        raw, out = fused_depth_scan_flags_xla(delta, gap + valid * 2, lo, hi)
        want_raw = np.cumsum(delta).astype(np.int32)
        masked = np.where(gap != 0, 0, want_raw)
        m = (masked > lo) & (masked <= hi) & (valid != 0)
        prev = np.concatenate(([False], m[:-1]))
        change = np.concatenate(([True], want_raw[1:] != want_raw[:-1]))
        want = (m & ~prev) + 2 * (~m & prev) + 4 * change
        np.testing.assert_array_equal(np.asarray(raw), want_raw)
        np.testing.assert_array_equal(np.asarray(out), want, err_msg=f"trial {trial}")


def test_fused_scan_flags_equivalent_to_masked(rng):
    """The flags reference's bits decode to the three per-slot streams of
    the gap-masked issue scan."""
    total = 3000
    delta = np.zeros(total, np.int32)
    idx = rng.integers(0, total, 800)
    np.add.at(delta, idx, 1)
    np.add.at(delta, np.minimum(idx + 120, total - 1), -1)
    gap = (rng.random(total) < 0.08).astype(np.int8)
    valid = (rng.random(total) < 0.95).astype(np.int8)
    raw, out = fused_depth_scan_flags_xla(delta, gap + valid * 2, -1, 0)
    out = np.asarray(out)
    depth = np.cumsum(delta)
    m = (np.where(gap != 0, 0, depth) == 0) & (valid != 0)
    np.testing.assert_array_equal(out & 1, m & ~np.concatenate(([False], m[:-1])))
    np.testing.assert_array_equal((out >> 1) & 1, ~m & np.concatenate(([False], m[:-1])))
    np.testing.assert_array_equal((out >> 2) & 1, np.concatenate(([True], depth[1:] != depth[:-1])))


def test_fused_scan_packed_matches_xla(rng):
    """Packed-word kernel (interpret) vs its XLA reference, randomized over
    block counts and thresholds."""
    block = 128
    for trial in range(6):
        total = int(rng.integers(1, 6)) * block
        word = _random_word(rng, total, 200, 100)
        lo, hi = -1, int(rng.integers(0, 3))
        got = packed_scan_kernel(word, lo, hi, block=block, interpret=True)
        want = fused_depth_scan_packed_xla(word, lo, hi)
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(
            np.asarray(got[1]), np.asarray(want[1]), err_msg=f"trial {trial}"
        )


def test_fused_scan_packed_equivalent_to_flags(rng):
    """The packed word's outputs decode to exactly the flags reference's
    streams (same math, one input stream), bit3 = the gap indicator."""
    total = 3 * 1024
    delta = np.zeros(total, np.int32)
    idx = rng.integers(0, total, 800)
    np.add.at(delta, idx, 1)
    np.add.at(delta, np.minimum(idx + 120, total - 1), -1)
    gs, ge = _disjoint(rng, total, 10)
    vs, ve = _disjoint(rng, total, 6)
    gd = np.zeros(total, np.int32)
    np.add.at(gd, gs, 1)
    np.add.at(gd, ge, -1)
    vd = np.zeros(total, np.int32)
    np.add.at(vd, vs, 1)
    np.add.at(vd, ve, -1)
    gap = (np.cumsum(gd) > 0).astype(np.int8)
    valid = (np.cumsum(vd) > 0).astype(np.int8)
    word = (delta << 2) + gd * 2 + vd

    d1, o1 = fused_depth_scan_flags_xla(delta, gap + valid * 2, -1, 0)
    for d2, o2 in (
        fused_depth_scan_packed_xla(word, -1, 0),
        packed_scan_kernel(word, -1, 0, block=1024, interpret=True),
    ):
        o2 = np.asarray(o2)
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
        np.testing.assert_array_equal(np.asarray(o1), o2 & 7)
        np.testing.assert_array_equal(gap, (o2 >> 3) & 1)


@pytest.mark.parametrize(
    "platform, n, want",
    [
        ("gpu", BLOCK, True),
        ("gpu", 5 * BLOCK, True),
        ("gpu", 5 * BLOCK + 1, False),  # not whole blocks: XLA reference
        ("gpu", 0, False),
        ("cpu", 5 * BLOCK, False),
    ],
)
def test_use_kernel_by_platform(platform, n, want):
    assert use_kernel(platform, n) is want


@pytest.mark.parametrize("n", [1, BLOCK - 1, BLOCK, BLOCK + 1, 7 * BLOCK + 3])
def test_pad_to_block(n):
    p = pad_to_block(n)
    assert p % BLOCK == 0 and n <= p < n + BLOCK
    assert use_kernel("gpu", p)


def test_resident_axes_are_whole_blocks():
    """Every production axis takes the kernel on a GPU: the resident pad,
    the sharded per-shard pad and the streamed chunk."""
    from gci_tpu.depth.fused import DeviceDepth
    from gci_tpu.depth.sharded import ShardedDepth
    from gci_tpu.depth.streamed import resident_chunk_slots
    from gci_tpu.parallel import make_mesh

    for total in (8193, 3_000_017):
        assert use_kernel("gpu", DeviceDepth.pad_total_for(total))
        assert use_kernel("gpu", resident_chunk_slots(total, 4096))
        mesh = make_mesh(4, dp=2)
        pad = ShardedDepth._pad_total(mesh, total)
        assert pad >= total and use_kernel("gpu", pad // mesh.shape["gp"])


@pytest.mark.gpu
def test_scans_compiled_gpu(gpu):
    """The compiled Triton kernels == their XLA references on the card.
    This process is pinned to the CPU, so the check runs in a child that
    keeps jax's default (GPU) platform."""
    code = (
        "from tests.scan_checks import check_compiled_scans\n"
        f"check_compiled_scans([{BLOCK}, {BLOCK} * 37, {BLOCK} * 4096])\n"
        "print('COMPILED_OK')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], env=gpu, cwd=gpu["PYTHONPATH"],
        capture_output=True, timeout=900,
    )
    assert r.returncode == 0, r.stderr.decode(errors="replace")[-3000:]
    assert b"COMPILED_OK" in r.stdout
