import os

import numpy as np
import pytest

from gci_tpu.viz.plot import plot_depth_files, sliding_window_average


def oracle_window_average(depths, window_size, max_depth, start):
    """Literal transcription of the documented reference loop (GCI.py:660-705)."""
    averaged_positions = []
    averaged_depths = []
    window = []
    if len(depths) < window_size:
        window_size = 1
    i = -1
    for i, depth in enumerate(depths):
        if depth == 0:
            if len(window) > 0:
                avg = sum(window) / len(window)
                avg = min(avg, max_depth)
                averaged_depths.append(avg)
                averaged_positions.append((i + start - 1) / 1e6)
                window = []
            averaged_depths.append(0)
            averaged_positions.append((i + start) / 1e6)
        else:
            window.append(depth)
            if len(window) == window_size:
                avg = sum(window) / window_size
                avg = min(avg, max_depth)
                averaged_depths.append(avg)
                averaged_positions.append((i + start) / 1e6)
                window = []
    if len(window) > 0:
        avg = sum(window) / len(window)
        avg = min(avg, max_depth)
        averaged_depths.append(avg)
        averaged_positions.append((i + start) / 1e6)
    return averaged_positions, averaged_depths


@pytest.mark.parametrize("ws", [1, 3, 7])
def test_window_average_matches_oracle(rng, ws):
    for trial in range(30):
        n = int(rng.integers(ws, 120))
        depth = rng.integers(0, 5, size=n).astype(np.int64)
        got_p, got_v = sliding_window_average(depth, ws, 3.0, start=17, target="t")
        want_p, want_v = oracle_window_average(list(depth), ws, 3.0, 17)
        np.testing.assert_allclose(got_p, want_p, rtol=0, atol=0)
        np.testing.assert_allclose(got_v, want_v, rtol=0, atol=0)


def test_window_size_fallback_warning(capsys):
    got_p, got_v = sliding_window_average(np.array([1, 2]), 50, 10.0, 0, "chrZ")
    err = capsys.readouterr().err
    assert "window size will be 1 bp" in err
    assert got_v.tolist() == [1, 2]


def test_plot_files_written(tmp_path, rng):
    d = str(tmp_path)
    os.makedirs(f"{d}/images")
    depths = {
        "c1": rng.integers(0, 40, size=2000).astype(np.int64),
        "c2": rng.integers(0, 40, size=1500).astype(np.int64),
    }
    nano = {
        "c1": rng.integers(0, 30, size=2000).astype(np.int64),
        "c2": rng.integers(0, 30, size=1500).astype(np.int64),
    }
    depths["c1"][100:200] = 0
    plot_depth_files(
        [depths, nano], targets_length={"c1": 2000, "c2": 1500},
        window_size=100, directory=d, prefix="P",
        regions_bed={"c1": [(50, 700)]},
    )
    for f in ["P.c1.png", "P.c2.png", "P.c1:50-700.png"]:
        assert os.path.exists(f"{d}/images/{f}"), f
        assert os.path.getsize(f"{d}/images/{f}") > 10000


def test_plot_rejects_bad_image_type(tmp_path):
    with pytest.raises(SystemExit):
        plot_depth_files(
            [{"c": np.ones(10)}], image_type="svg",
            targets_length={"c": 10}, directory=str(tmp_path),
        )


@pytest.mark.parametrize("ws", [7, 50, 1000])
def test_window_average_events_matches_array(rng, ws):
    """Event-space window averaging is bit-identical to the per-base path
    (positions AND values), including zero runs, segment flushes and
    max-depth clamping."""
    from gci_tpu.depth.eventspace import DepthEvents

    for trial in range(20):
        n = int(rng.integers(1, 4000))
        depth = rng.integers(0, 6, size=n).astype(np.int64)
        # inject long zero and constant stretches
        if n > 100:
            depth[20:70] = 0
            depth[80:100] = 3
        ev = DepthEvents.from_array(depth)
        p1, v1 = sliding_window_average(depth, ws, 4.5, 11, "t")
        p2, v2 = sliding_window_average(ev, ws, 4.5, 11, "t")
        assert p1 == p2, (trial, n, ws)
        np.testing.assert_array_equal(v1, v2)


def test_plot_files_written_from_events(tmp_path, rng):
    """-p after an event-space (streamed/sharded) run: plots render without
    materializing per-base arrays and match the array-backed output."""
    from gci_tpu.depth.eventspace import DepthEvents

    lens = {"c1": 3000, "c2": 2000}
    arrays = {
        t: rng.integers(0, 5, size=L).astype(np.int64) for t, L in lens.items()
    }
    arrays["c1"][:200] = 0
    events = {t: DepthEvents.from_array(a) for t, a in arrays.items()}
    d1 = str(tmp_path / "arr")
    d2 = str(tmp_path / "ev")
    for d in (d1, d2):
        os.makedirs(f"{d}/images")
    regions = {"c1": [(100, 2500)]}
    plot_depth_files(
        [arrays], window_size=500, directory=d1, prefix="P", force=True,
        targets_length=lens, regions_bed=regions,
    )
    plot_depth_files(
        [events], window_size=500, directory=d2, prefix="P", force=True,
        targets_length=lens, regions_bed=regions,
    )
    for name in ("P.c1.png", "P.c2.png", "P.c1:100-2500.png"):
        a = open(f"{d1}/images/{name}", "rb").read()
        b = open(f"{d2}/images/{name}", "rb").read()
        assert a == b, name


def test_rendered_figures_match_snapshots(tmp_path):
    """Pixel-level regression guard for plot_target's transliterated visual
    constants: the rendered PNGs for a fixed
    synthetic input must hash-match the committed fixtures.  Regenerate
    after an intentional visual change: python -m tests.plot_snapshots"""
    import json

    import matplotlib

    from tests.plot_snapshots import (
        SNAPSHOT_FILE,
        hash_figures,
        render_canonical_figures,
    )

    with open(SNAPSHOT_FILE) as f:
        fixture = json.load(f)
    if fixture["matplotlib"] != matplotlib.__version__:
        pytest.skip(
            f"snapshots recorded with matplotlib {fixture['matplotlib']}, "
            f"running {matplotlib.__version__}"
        )
    got = hash_figures(render_canonical_figures(str(tmp_path)))
    assert got == fixture["figures"], (
        "rendered figures diverged from the committed snapshots; if the "
        "change is intentional run `python -m tests.plot_snapshots`"
    )
    # the event-space render must stay bit-identical to the array render
    assert got["events.cA"] == got["single.cA"]


def test_snapshot_mismatch_ticks_and_ref_track(tmp_path):
    """bamsnap-detail parity: the mismatch walk
    returns exactly the reference positions where SEQ differs (M/X compared,
    '=' trusted, I/S skip query, D/N skip reference), and the rendered
    figure carries the reference base track."""
    import numpy as np

    from gci_tpu.io.bam_writer import build_record
    from gci_tpu.viz.snap import _mismatch_xs, snapshot_regions
    from tests.fixtures import make_bam, make_fasta

    # reference: ACGT repeated; read at pos 10, seq chosen to mismatch at
    # read offsets 2 and 5 within a 10M block -> ref positions 12 and 15
    ref_seq = ("ACGT" * 25)
    rec = build_record(
        "r1", 0, 10, 60, "10M", nm=2,
        seq="GT" + "A" + "TA" + "G" + "TGTA",  # ref[10:20] = GTACGTACGT
    )
    rseq = np.frombuffer(ref_seq.encode(), np.uint8)
    xs = _mismatch_xs(rec[4:], rseq)
    want = [
        10 + k for k in range(10)
        if ("GTATAGTGTA"[k] != "GTACGTACGT"[k])
    ]
    assert xs.tolist() == want
    # insertion/deletion bookkeeping: 3M2I3M2D2M consumes q=3+2+3+2, r=3+3+2+2
    # q = ACG | TT(ins) | TAG | (2D) | AC ; ref = ACG TAC [GT deleted] AC
    # M1 ACG==ACG; M2 TAG vs TAC -> mismatch at ref pos 5 only;
    # M3 AC==ref[8:10] AC (the deletion advanced the reference cursor)
    rec2 = build_record("r2", 0, 0, 60, "3M2I3M2D2M", nm=4, seq="ACGTTTAGAC")
    xs2 = _mismatch_xs(rec2[4:], rseq)
    assert xs2.tolist() == [5]

    # e2e: figure renders with the reference track + ticks
    make_fasta(str(tmp_path / "ref.fa"), [("chrA", ref_seq)])
    make_bam(
        str(tmp_path / "in.bam"), ["chrA"], [100],
        [dict(name="r1", ref="chrA", pos=10, mapq=60, cigar="10M", nm=2)],
    )
    snapshot_regions(
        [str(tmp_path / "in.bam")], [str(tmp_path / "in.bam")],
        str(tmp_path / "ref.fa"), ["chrA:0-100"],
        directory=str(tmp_path), prefix="snapx", force=True,
    )
    assert (tmp_path / "snapx.png").exists()
