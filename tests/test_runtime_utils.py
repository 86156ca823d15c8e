import json

import numpy as np
import pytest

from gci_tpu.parallel.distributed import HostShard
from gci_tpu.utils.metrics import get_metrics, stage


def test_stage_metrics():
    m = get_metrics()
    m.reset()
    with stage("demo", items=100, unit="reads"):
        pass
    rows = [json.loads(line) for line in m.report().splitlines()]
    assert rows[-1]["stage"] == "demo"
    assert rows[-1]["items"] == 100
    assert "per_second" in rows[-1]
    m.reset()


def test_host_shard_files():
    s0 = HostShard(0, 3)
    s1 = HostShard(1, 3)
    s2 = HostShard(2, 3)
    paths = [f"f{i}" for i in range(7)]
    all_assigned = s0.files(paths) + s1.files(paths) + s2.files(paths)
    assert sorted(all_assigned) == sorted(paths)
    assert s0.files(paths) == ["f0", "f3", "f6"]


def test_host_shard_record_range():
    shards = [HostShard(i, 4) for i in range(4)]
    ranges = [s.record_range(10) for s in shards]
    covered = []
    for a, b in ranges:
        covered.extend(range(a, b))
    assert covered == list(range(10))


def test_accumulate_depth_device_backend_matches_numpy(rng):
    # the host numpy backend of accumulate_depth equals the numpy oracle
    from gci_tpu.depth import GenomeLayout, accumulate_depth, accumulate_depth_numpy

    targets = {"a": 5000, "b": 3000}
    layout = GenomeLayout.from_targets(targets)
    tid = rng.integers(0, 2, size=200)
    lens = np.array([5000, 3000])
    start = rng.integers(0, 2500, size=200)
    end = np.minimum(start + rng.integers(10, 2000, size=200), lens[tid])
    want = accumulate_depth_numpy(layout, tid, start, end, 15)
    got = accumulate_depth(layout, tid, start, end, 15, backend="numpy")
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# auto backend resolution
# ---------------------------------------------------------------------------


def test_resolve_auto_backend_host_only():
    # this suite pins jax to the CPU: auto is the host event-space path
    from gci_tpu.depth import resolve_auto_backend

    assert resolve_auto_backend() == "events"


@pytest.mark.parametrize(
    "platform, want",
    [("cpu", "events"), ("gpu", "device"), ("rocm", "device")],
)
def test_resolve_auto_backend_rule(monkeypatch, platform, want):
    from gci_tpu.depth import resolve_auto_backend

    monkeypatch.delenv("GCI_AUTO_BACKEND", raising=False)
    assert resolve_auto_backend(platform) == want


def test_resolve_auto_backend_env_override(monkeypatch):
    from gci_tpu.depth import resolve_auto_backend

    monkeypatch.setenv("GCI_AUTO_BACKEND", "numpy")
    assert resolve_auto_backend("gpu") == "numpy"
    monkeypatch.setenv("GCI_AUTO_BACKEND", "bogus")
    with pytest.raises(ValueError):
        resolve_auto_backend("gpu")


# ---------------------------------------------------------------------------
# compile cache location
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set the cache lands there and the
    checkout's .jax_cache is left alone; unset, the checkout's is used."""
    import os
    import subprocess
    import sys

    from gci_tpu.utils.jaxcache import CHECKOUT_CACHE_DIR

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    code = (
        "import jax, jax.numpy as jnp\n"
        "from gci_tpu.utils.jaxcache import enable_compile_cache\n"
        "enable_compile_cache()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120, cwd=os.path.dirname(CHECKOUT_CACHE_DIR),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    want = str(tmp_path / "cc") if env_dir else CHECKOUT_CACHE_DIR
    assert r.stdout.strip().splitlines()[-1] == want
