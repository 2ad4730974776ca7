"""Order in which pytest-xdist hands out test files under ``--dist loadfile``.

xdist queues files by their test count, so a long file with few tests
starts late and ends the run. The scheduler below queues the files known
to take longest first (``LONGEST_FIRST``, the slowest first) and the rest
in xdist's own order, and starts each worker on one file. It selects,
skips and deselects nothing: only the order in which the files run
changes. Where the installed xdist lacks the internals it extends, or
under another ``--dist`` mode, xdist's own scheduler runs.
"""

from __future__ import annotations

import pytest

# Worker seconds of the suite's slowest files on six CPU workers, slowest
# first: test_train_cli.py 944, test_detr.py 527, test_engine.py 455,
# test_detection_train.py 326; then test_torch_parallel_cli.py 133, whose
# spawned ranks also hold CPU cores beside its worker.
LONGEST_FIRST = ("tests/test_train_cli.py", "tests/test_detr.py",
                 "tests/test_engine.py", "tests/test_detection_train.py",
                 "tests/test_torch_parallel_cli.py")
_INTERNALS = ("schedule", "_assign_work_unit", "_reschedule", "_pending_of",
              "_split_scope", "_check_nodes_have_same_collection")


def _longest_first_scheduler(base):
    class LongestFirstScheduling(base):
        """xdist's file scheduler with ``LONGEST_FIRST`` at the head of its
        queue; a worker gets its second file only when its first runs out
        (xdist gives every worker two at the start)."""

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
                first = (LONGEST_FIRST.index(scope) if scope in LONGEST_FIRST
                         else len(LONGEST_FIRST))
                return first, -len(units[scope])

            for scope in sorted(units, key=rank):
                self.workqueue[scope] = units[scope]
            for _ in range(len(self.nodes) - len(self.workqueue)):
                unused, _ = self.assigned_work.popitem()
                unused.shutdown()
            for node in self.nodes:
                self._assign_work_unit(node)
            # a worker runs a test only once it holds the next one, so a
            # one-test file needs a second file behind it from the start
            for node in self.nodes:
                if self._pending_of(self.assigned_work[node]) < 2:
                    self._reschedule(node)
            if not self.workqueue:
                for node in self.nodes:
                    node.shutdown()

    return LongestFirstScheduling


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
    scheduler = _longest_first_scheduler(LoadFileScheduling)(config, log)
    if not all(hasattr(scheduler, name) for name in ("workqueue",
                                                     "assigned_work")):
        return None
    return scheduler
