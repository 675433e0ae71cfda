"""Process set-up that decides where things live: the persistent compile
cache, the native library build, and the device-OSD memory budget."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits
    at the fixed path <repo>/.xla_cache."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "QCSS_NO_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    want = os.path.join(ROOT, ".xla_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax, qcss_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env={**env, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == want


_PROBE = """
import jax
import pytest


@pytest.mark.gpu
def test_probe():
    plat = jax.config.jax_platforms
    devs = len(jax.devices()) if plat == "cpu" else "-"
    print("PLATFORMS", plat, devs)
"""


@pytest.mark.parametrize("platforms,worker,args,want", [
    ("cuda", "gw0", ["-m", "gpu"], "cpu 8"),   # an xdist worker
    ("cuda,cpu", "gw3", [], "cpu 8"),
    ("cuda", None, [], "cpu 8"),               # not a -m gpu run
    ("", None, [], "cpu 8"),
    ("cuda", None, ["-m", "gpu"], "cuda -"),   # single-process -m gpu
])
def test_conftest_holds_runs_to_the_cpu(tmp_path, platforms, worker, args,
                                        want):
    """Only a single-process ``-m gpu`` run keeps JAX_PLATFORMS; every
    other run, and every xdist worker, gets the CPU with 8 devices."""
    import shutil

    shutil.copy(os.path.join(ROOT, "tests", "conftest.py"), tmp_path)
    (tmp_path / "test_probe.py").write_text(_PROBE)
    env = {k: v for k, v in os.environ.items()
           if k != "PYTEST_XDIST_WORKER"}
    env["JAX_PLATFORMS"] = platforms
    if worker:
        env["PYTEST_XDIST_WORKER"] = worker
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-s", "-p", "no:xdist",
         "-p", "no:cacheprovider", *args, "test_probe.py"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"PLATFORMS {want}" in r.stdout


def test_native_library_builds_inside_the_checkout():
    from qcss_tpu import native

    if not native.available():
        pytest.skip("no C++ toolchain")
    pkg = os.path.dirname(os.path.abspath(native.__file__))
    assert os.path.dirname(native.BUILD_DIR) == pkg
    assert os.path.exists(os.path.join(native.BUILD_DIR, "libqcss.so"))
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", native.BUILD_DIR], cwd=ROOT)
    if ignored.returncode != 128:  # 128: not a git checkout
        assert ignored.returncode == 0, "build dir must be git-ignored"


@pytest.mark.parametrize("bytes_limit,r,C,want", [
    (60 << 30, 72, 144, 2048),            # small system: clamped high
    (16 << 30, 5000, 5256, 163),          # a 16 GiB card, big circuit graph
    (1 << 30, 5000, 5256, 64),            # clamped low
])
def test_osd_chunk_from_bytes_limit(bytes_limit, r, C, want):
    from qcss_tpu.decode.bp import osd_chunk

    assert osd_chunk(r, C, bytes_limit) == want


def test_osd_chunk_without_memory_stats():
    """The CPU backend reports no memory limit: the stated fallback
    budget applies."""
    from qcss_tpu.decode.bp import OSD_FALLBACK_BUDGET_BITS, osd_chunk

    r, C = 3000, 3256
    assert osd_chunk(r, C) == min(2048, max(
        64, OSD_FALLBACK_BUDGET_BITS // (r * C)))
