"""Genome-axis scans: the plain XLA reference and the Pallas-Triton kernels.

Two scans run over the padded genome axis:

* ``prefix_sum`` — the inclusive int32 prefix sum (depth from a delta
  array, the rank of a bitmap for device compaction);
* ``packed_scan`` — the production construction.  One int32 word per slot,
  ``word = read_delta<<2 | gap_event<<1 | valid_event``, scans into the
  clean depth plus a flag byte (bit0 rise, bit1 fall, bit2 change, bit3
  in-gap) of the issue intervals ``(lo, hi]`` inside valid slots.  N-gap and
  scan-window intervals are each disjoint, so their event prefix sums stay
  in {0, 1} and one int32 scan carries all three fields without cross-field
  carries while depth < 2^29 (callers guard on ``fused.PACKED_DEPTH_LIMIT``).

``*_xla`` are the plain references: what XLA compiles from ``jnp.cumsum``
and elementwise code.  The kernels are a two-level scan, because GPU blocks
run in no order and carry nothing from one to the next: XLA sums each
``BLOCK``-slot block and takes the exclusive prefix of the block sums (the
carries); then each Triton program scans its block, adds its carry and
writes the epilogue.  The packed word's carry is its prefix sum, so it also
brings the previous block's gap and valid state.  The previous slot's word
prefix is ``prefix - word``, so rise, fall and change at a block's first
slot need no neighbour load.  Results are int32 and exact: integer adds do
not depend on their order.

``use_kernel`` picks the kernel on a GPU when the axis is a whole number of
blocks (every production axis is: ``pad_to_block``); elsewhere the XLA
reference runs.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# slots per Triton program (a power of two) and warps per program: the
# fastest pair of a sweep over 1024-8192 slots x 4/8 warps on an H100 at
# 0.4G and 1.2G slots; the spread across the sweep was within ~15%
BLOCK = 2048
NUM_WARPS = 4


def use_kernel(platform: str, n: int) -> bool:
    """Whether an ``n``-slot scan on ``platform`` runs the Triton kernel."""
    return platform == "gpu" and n > 0 and n % BLOCK == 0


def pad_to_block(n: int) -> int:
    """``n`` rounded up to a whole number of kernel blocks."""
    return n + ((-n) % BLOCK)


# ---------------------------------------------------------------------------
# plain XLA references
# ---------------------------------------------------------------------------

def fused_depth_scan_packed_xla(word, leftmost, rightmost):
    """(raw_depth, flags) of a packed event-word axis, as plain XLA."""
    sw = jnp.cumsum(word).astype(jnp.int32)
    raw = jax.lax.shift_right_logical(sw, 2)
    gap = (sw & 2) != 0
    valid = (sw & 1) != 0
    masked = jnp.where(gap, 0, raw)
    m = (masked > leftmost) & (masked <= rightmost) & valid
    prev = jnp.concatenate([jnp.zeros(1, bool), m[:-1]])
    rise = m & ~prev
    fall = ~m & prev
    prev_raw = jnp.concatenate([raw[:1] - 1, raw[:-1]])  # forces change at 0
    change = raw != prev_raw
    out = (
        rise.astype(jnp.int8)
        + fall.astype(jnp.int8) * 2
        + change.astype(jnp.int8) * 4
        + gap.astype(jnp.int8) * 8
    )
    return raw, out


def fused_depth_scan_flags_xla(delta, flags, leftmost, rightmost):
    """(raw_depth, flags) from a plain delta and separate flag bytes
    (in: bit0 gap, bit1 valid; out: bit0 rise, bit1 fall, bit2 change).
    The construction for inputs past ``fused.PACKED_DEPTH_LIMIT`` reads."""
    raw = jnp.cumsum(delta).astype(jnp.int32)
    gap = (flags & 1) != 0
    valid = (flags & 2) != 0
    masked = jnp.where(gap, 0, raw)
    m = (masked > leftmost) & (masked <= rightmost) & valid
    prev = jnp.concatenate([jnp.zeros(1, bool), m[:-1]])
    rise = m & ~prev
    fall = ~m & prev
    prev_raw = jnp.concatenate([raw[:1] - 1, raw[:-1]])  # forces change at 0
    change = raw != prev_raw
    out = (
        rise.astype(jnp.int8)
        + fall.astype(jnp.int8) * 2
        + change.astype(jnp.int8) * 4
    )
    return raw, out


# ---------------------------------------------------------------------------
# Pallas-Triton kernels
# ---------------------------------------------------------------------------

def _block_carries(x, block: int):
    """Exclusive prefix of the per-block sums: each block's carry."""
    sums = jnp.sum(x.reshape(-1, block), axis=1, dtype=jnp.int32)
    return jnp.cumsum(sums) - sums


def _prefix_kernel(carry_ref, x_ref, out_ref):
    out_ref[...] = jnp.cumsum(x_ref[...]) + carry_ref[0]


def _decode(sw, lo, hi):
    """Depth, issue-mask and gap bit of packed word prefixes."""
    depth = jax.lax.shift_right_logical(sw, 2)
    gap = (sw & 2) != 0
    masked = jnp.where(gap, 0, depth)
    m = (masked > lo) & (masked <= hi) & ((sw & 1) != 0)
    return depth, m, gap


def _packed_kernel(lohi_ref, carry_ref, word_ref, depth_ref, flags_ref):
    lo = lohi_ref[0]
    hi = lohi_ref[1]
    w = word_ref[...]
    sw = jnp.cumsum(w) + carry_ref[0]
    depth, m, gap = _decode(sw, lo, hi)
    # the slot before each slot: prefix minus its own word (the axis's
    # first slot sees an all-zero word: no depth, no gap, not valid)
    prev_depth, prev_m, _ = _decode(sw - w, lo, hi)
    first = (pl.program_id(0) == 0) & (
        jax.lax.broadcasted_iota(jnp.int32, w.shape, 0) == 0
    )
    rise = m & ~prev_m
    fall = prev_m & ~m
    change = (depth != prev_depth) | first
    depth_ref[...] = depth
    flags_ref[...] = (
        rise.astype(jnp.int32)
        + fall.astype(jnp.int32) * 2
        + change.astype(jnp.int32) * 4
        + gap.astype(jnp.int32) * 8
    ).astype(jnp.int8)


def _blocks(n: int, block: int) -> int:
    if n % block:
        raise ValueError(f"scan axis {n} is not a multiple of block {block}")
    return n // block


def _out(x, dtype):
    """Output shape of a per-slot result; under ``shard_map`` it varies
    over the same mesh axes as the input."""
    return jax.ShapeDtypeStruct(x.shape, dtype, vma=jax.typeof(x).vma)


@functools.partial(jax.jit, static_argnames=("block", "interpret"))
def prefix_sum_kernel(x, block: int = BLOCK, interpret: bool = False):
    """Inclusive int32 prefix sum of ``x`` (length a multiple of ``block``)."""
    n = x.shape[0]
    nb = _blocks(n, block)
    spec = pl.BlockSpec((block,), lambda i: (i,))
    return pl.pallas_call(
        _prefix_kernel,
        grid=(nb,),
        in_specs=[pl.BlockSpec((1,), lambda i: (i,)), spec],
        out_specs=spec,
        out_shape=_out(x, jnp.int32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="gci_prefix_sum",
    )(_block_carries(x, block), x)


@functools.partial(jax.jit, static_argnames=("block", "interpret"))
def packed_scan_kernel(word, leftmost, rightmost, block: int = BLOCK,
                       interpret: bool = False):
    """(raw_depth, flags) of a packed event-word axis; same results as
    ``fused_depth_scan_packed_xla``."""
    n = word.shape[0]
    nb = _blocks(n, block)
    lohi = jnp.stack([jnp.asarray(leftmost, jnp.int32),
                      jnp.asarray(rightmost, jnp.int32)])
    spec = pl.BlockSpec((block,), lambda i: (i,))
    depth, flags = pl.pallas_call(
        _packed_kernel,
        grid=(nb,),
        in_specs=[
            pl.BlockSpec((2,), lambda i: (0,)),
            pl.BlockSpec((1,), lambda i: (i,)),
            spec,
        ],
        out_specs=[spec, spec],
        out_shape=[_out(word, jnp.int32), _out(word, jnp.int8)],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="gci_packed_scan",
    )(lohi, _block_carries(word, block), word)
    return depth, flags


# ---------------------------------------------------------------------------
# the scans callers use
# ---------------------------------------------------------------------------

def prefix_sum(x):
    """Inclusive int32 prefix sum over the genome axis."""
    if use_kernel(jax.default_backend(), x.shape[0]):
        return prefix_sum_kernel(x)
    return jnp.cumsum(x)


def packed_scan(word, leftmost, rightmost):
    """(raw_depth, flags) of a packed event-word axis."""
    if use_kernel(jax.default_backend(), word.shape[0]):
        return packed_scan_kernel(word, leftmost, rightmost)
    return fused_depth_scan_packed_xla(word, leftmost, rightmost)
