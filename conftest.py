"""How the suite runs under ``--dist loadfile``: the order in which
pytest-xdist hands out the tests, how the JAX package's own tests compile,
and a JAX compilation cache that the workers share. Nothing here selects,
skips or deselects a test, or changes what one checks.

Order. xdist queues files by their test count, so a long file with few
tests starts late and ends the run, and a run cut by the clock counts
only the tests it finished. The scheduler below starts the long units
first, longest first (``LONG_UNIT_SECONDS`` or more in all, or
``LONG_TEST_SECONDS`` or more a test; ``SECONDS``: worker seconds in a
whole run of the suite on six CPU workers), and then runs the rest in
order of seconds a test, fewest first, so that the suite's many quick
tests finish early; it starts each worker on one unit. A unit is a file,
except in the files of ``BY_TEST``, whose tests are handed out one by one:
test_train_cli.py alone takes longer than a worker's share of the run.
Where the installed xdist lacks the internals it extends, or under
another ``--dist`` mode, xdist's own scheduler runs.

Compilation. XLA's compilation is most of the suite's time. The JAX
package's own tests compile with ``jax_disable_most_optimizations`` (XLA's
backend at optimisation level 0): the same programs, run less optimised.
The port's tests (``test_torch_*``) hold the port to JAX references
compiled as XLA compiles by default, so before each of them the flag is
off and JAX's in-memory caches hold nothing compiled the other way.

Cache. Each worker is its own process, so a program that two workers,
or two tests through two jitted functions, compile was compiled twice.
The controller makes one temporary directory for JAX's persistent
compilation cache, the workers inherit it through
``JAX_COMPILATION_CACHE_DIR``, and it is removed when the run ends. A
program is stored once its compilation took ``CACHE_MIN_COMPILE_SECONDS``
and it is at most ``CACHE_MAX_ENTRY_BYTES`` (the few larger ones, whole
training steps, are compiled once and would fill the disk). A cached
program is the compiled executable itself, keyed by the program and every
compiler option, so a result is the one that compiling again would give.
Where the caller has set a cache of their own, that one is used as it is.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import pytest

# Worker seconds of a file under tests/ in the JUnit of a whole run of the
# tier-1 command on six workers, with the compilation settings above; a
# file not listed takes under 10 s.
SECONDS = {
    "test_detr.py": 649,
    "test_engine.py": 526,
    "test_detection_train.py": 336,
    "test_quant_resnet.py": 267,
    "test_detection.py": 192,
    "test_fused_vit_block.py": 183,
    "test_torch_detection_train.py": 183,
    "test_laud_vit.py": 156,
    "test_amp.py": 146,
    "test_tp_pp.py": 144,
    "test_torch_parallel_cli.py": 142,
    "test_torch_detection.py": 140,
    "test_laud_resnet.py": 130,
    "test_torch_detection_cli.py": 126,
    "test_quant_vit.py": 124,
    "test_detection_cli.py": 120,
    "test_segm_eval.py": 120,
    "test_multihost.py": 116,
    "test_torch_fused_vit.py": 115,
    "test_torch_laud_vit_train.py": 112,
    "test_export_pruned.py": 109,
    "test_pallas_masked.py": 105,
    "test_vit_attention.py": 99,
    "test_torch_laud_vit.py": 96,
    "test_torch_trainer.py": 86,
    "test_torch_detr_train.py": 85,
    "test_torch_train_cli.py": 83,
    "test_rect_detection.py": 76,
    "test_torch_parallel.py": 75,
    "test_torch_vit_attention.py": 54,
    "test_sim.py": 52,
    "test_torch_quant.py": 52,
    "test_coco_data.py": 49,
    "test_torch_detr.py": 48,
    "test_sparse.py": 45,
    "test_layerskip_engine.py": 44,
    "test_torch_engine.py": 43,
    "test_torch_data_train.py": 41,
    "test_torch_masked_block.py": 41,
    "test_torch_tp_pp.py": 38,
    "test_torch_convert.py": 30,
    "test_aot.py": 28,
    "test_tp_fused.py": 28,
    "test_sparsity_convergence.py": 27,
    "test_torch_maskers.py": 26,
    "test_torch_vit_block.py": 23,
    "test_torch_aot.py": 23,
    "test_torch_sim_gpu.py": 23,
    "test_torch_laud_regnet.py": 22,
    "test_torch_sparse.py": 19,
    "test_torch_t2t.py": 17,
    "test_torch_laud_resnet.py": 16,
    "test_torch_probes.py": 15,
    "test_torch_resnet.py": 14,
    "test_torch_gating.py": 14,
    "test_torch_export_pruned.py": 13,
    "test_vit_parity.py": 12,
    "test_torch_package.py": 11,
}
# Files handed out test by test, with each test's worker seconds in the
# same JUnit (test_train_cli.py: 1,284 s in all).
BY_TEST = {
    "test_train_cli.py": {
        "test_train_main_regnet_smoke": 183,
        "test_train_main_amp_fsdp_smoke": 183,
        "test_train_main_smoke": 157,
        "test_train_main_tp_fused_smoke": 149,
        "test_train_main_tp_smoke": 144,
        "test_train_main_fsdp_smoke": 130,
        "test_train_main_vit_int8_qat_smoke": 100,
        "test_train_main_tp_fused_indivisible_heads_falls_back": 82,
        "test_train_main_vit_smoke": 75,
        "test_train_main_pp_smoke": 72,
        "test_tensor_parallel_specs_cover_optimizer_state": 9,
    },
}
LONG_UNIT_SECONDS, LONG_TEST_SECONDS = 250.0, 60.0
CACHE_MIN_COMPILE_SECONDS = "0.1"
CACHE_MAX_ENTRY_BYTES = 4 << 20
PORT_TESTS = "test_torch_"
_CACHE_DIR = pytest.StashKey[str]()
_OURS = "LAUDNET_TESTS_JAX_CACHE"
_FAST = "jax_disable_most_optimizations"
_INTERNALS = ("schedule", "_assign_work_unit", "_reschedule", "_pending_of",
              "_split_scope", "_check_nodes_have_same_collection")


def _seconds(scope: str) -> float:
    path, _, test = scope.removeprefix("tests/").partition("::")
    if test:
        return BY_TEST[path].get(test.partition("[")[0], 0.0)
    return SECONDS.get(path, 0.0)


def _long_first_scheduler(base):
    class LongFirstScheduling(base):
        """xdist's file scheduler with the units queued as the module
        says; a worker gets its second unit only when its first runs out
        (xdist gives every worker two at the start)."""

        def _split_scope(self, nodeid):
            scope = super()._split_scope(nodeid)
            return nodeid if scope.removeprefix("tests/") in BY_TEST else scope

        def schedule(self):
            if self.collection is not None:
                return super().schedule()
            if not self._check_nodes_have_same_collection():
                self.log("**Different tests collected, aborting run**")
                return
            collection = list(next(iter(self.registered_collections.values())))
            if not collection:
                return
            self.collection = collection
            units: dict = {}
            for nodeid in collection:
                units.setdefault(self._split_scope(nodeid), {})[nodeid] = False

            def rank(scope):
                seconds, tests = _seconds(scope), len(units[scope])
                if seconds >= LONG_UNIT_SECONDS or \
                        seconds >= LONG_TEST_SECONDS * tests:
                    return 0, -seconds
                return 1, seconds / tests

            for scope in sorted(units, key=rank):
                self.workqueue[scope] = units[scope]
            for _ in range(len(self.nodes) - len(self.workqueue)):
                unused, _ = self.assigned_work.popitem()
                unused.shutdown()
            for node in self.nodes:
                self._assign_work_unit(node)
            # a worker runs a test only once it holds the next one, so a
            # one-test unit needs a second unit behind it from the start
            for node in self.nodes:
                if self._pending_of(self.assigned_work[node]) < 2:
                    self._reschedule(node)
            if not self.workqueue:
                for node in self.nodes:
                    node.shutdown()

    return LongFirstScheduling


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    try:
        from xdist.scheduler import LoadFileScheduling
    except ImportError:
        return None
    if not all(hasattr(LoadFileScheduling, name) for name in _INTERNALS):
        return None
    scheduler = _long_first_scheduler(LoadFileScheduling)(config, log)
    if not all(hasattr(scheduler, name) for name in ("workqueue",
                                                     "assigned_work")):
        return None
    return scheduler


def _cap_cache_entries() -> bool:
    """Store no program larger than ``CACHE_MAX_ENTRY_BYTES`` (the cache's
    file class, wrapped once per process); False where JAX lacks it."""
    try:
        from jax._src import lru_cache
    except ImportError:
        return False
    put = getattr(lru_cache.LRUCache, "put", None)
    if put is None:
        return False
    if getattr(put, "capped", False):
        return True

    def capped_put(self, key, val):
        if len(val) <= CACHE_MAX_ENTRY_BYTES:
            put(self, key, val)

    capped_put.capped = True
    lru_cache.LRUCache.put = capped_put
    return True


def pytest_configure(config):
    ours = os.environ.get(_OURS)
    if ours and ours == os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        # a worker of this run: the same cap, or no cache
        if not _cap_cache_entries():
            import jax
            jax.config.update("jax_enable_compilation_cache", False)
        return
    if hasattr(config, "workerinput") or os.environ.get(
            "JAX_COMPILATION_CACHE_DIR") or not _cap_cache_entries():
        return
    path = tempfile.mkdtemp(prefix="jax-compilation-cache-")
    config.stash[_CACHE_DIR] = path
    os.environ[_OURS] = os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    os.environ["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = (
        CACHE_MIN_COMPILE_SECONDS)
    import jax  # imported already (tests/conftest.py): set it here too

    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(CACHE_MIN_COMPILE_SECONDS))


def pytest_unconfigure(config):
    path = config.stash.get(_CACHE_DIR, None)
    if path is not None:
        for name in (_OURS, "JAX_COMPILATION_CACHE_DIR",
                     "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"):
            os.environ.pop(name, None)
        shutil.rmtree(path, ignore_errors=True)


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_setup(item):
    """The JAX package's own tests compile with XLA's optimisation mostly
    off; a port test (``test_torch_*``) compiles its JAX references as
    XLA does by default, from caches emptied of programs compiled the
    other way. Before the item's fixtures, module-scoped ones included."""
    jax = sys.modules.get("jax")
    if jax is None:
        return
    fast = not item.path.name.startswith(PORT_TESTS)
    if jax.config.values.get(_FAST, fast) == fast:
        return
    jax.config.update(_FAST, fast)
    if not fast:
        jax.clear_caches()
