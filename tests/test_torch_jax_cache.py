"""JAX's persistent compilation cache, shared by the test processes of one
pytest run.

The port's tests hold each module against its JAX twin, and most of their
CPU time goes to XLA compiling the same JAX programs (a tiny checkpoint's
initialisers, the reference pipelines) again in every file and every
xdist worker. Pytest imports this module while it collects, which every
worker does before it runs a test, and the module points JAX's persistent
cache at one directory for the whole run (named by xdist's run id, or by
the process when pytest runs without xdist). A program that one worker
compiled is then read back by the others. The cache holds the compiled
executables themselves, so a program read back computes what a fresh
compile of it computes.

Entries are written to a temporary name and renamed into place, so that a
worker never reads another's half-written entry. A run leaves its
directory behind (no worker knows it is the last one); a run removes those
of earlier runs once they are a day old.
"""

import glob
import os
import shutil
import tempfile
import time

import jax
from jax._src import lru_cache

RUN_ID = os.environ.get("PYTEST_XDIST_TESTRUNUID") or f"pid{os.getpid()}"
CACHE_DIR = os.path.join(tempfile.gettempdir(),
                         f"fastvideo_tests_jax_cache_{RUN_ID}")


def _atomic_put(self, key: str, val: bytes) -> None:
    path = self.path / f"{key}{lru_cache._CACHE_SUFFIX}"
    if path.exists():
        return
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(val)
    os.replace(tmp, path)


_plain_put = lru_cache.LRUCache.put


def _put(self, key: str, val: bytes) -> None:
    if self.eviction_enabled:
        _plain_put(self, key, val)
    else:
        _atomic_put(self, key, val)


def prune(max_age_s: float = 86400.0) -> None:
    for path in glob.glob(os.path.join(tempfile.gettempdir(),
                                       "fastvideo_tests_jax_cache_*")):
        try:
            old = time.time() - os.path.getmtime(path) > max_age_s
        except OSError:  # another worker removed it first
            continue
        if path != CACHE_DIR and old:
            shutil.rmtree(path, ignore_errors=True)


def enable() -> None:
    prune()
    lru_cache.LRUCache.put = _put
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


enable()


def test_cache_points_at_the_run_directory():
    assert jax.config.jax_compilation_cache_dir == CACHE_DIR
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    if "PYTEST_XDIST_TESTRUNUID" in os.environ:
        assert RUN_ID == os.environ["PYTEST_XDIST_TESTRUNUID"]


def test_old_run_directories_are_pruned():
    old = tempfile.mkdtemp(prefix="fastvideo_tests_jax_cache_old",
                           dir=tempfile.gettempdir())
    fresh = tempfile.mkdtemp(prefix="fastvideo_tests_jax_cache_new",
                             dir=tempfile.gettempdir())
    os.utime(old, (time.time() - 2 * 86400,) * 2)
    prune()
    assert not os.path.exists(old) and os.path.isdir(fresh)
    os.rmdir(fresh)


def test_entries_are_written_whole(tmp_path):
    cache = lru_cache.LRUCache(str(tmp_path), max_size=-1)
    cache.put("k", b"abc")
    cache.put("k", b"other")  # an entry already there stays
    assert cache.get("k") == b"abc"
    assert [p.name for p in tmp_path.iterdir()] == [
        f"k{lru_cache._CACHE_SUFFIX}"]
