"""Suite-wide hooks: the slow marks and the per-phase time limit.

Imports only the standard library and pytest. ``tests/conftest.py`` must stay
the first to import JAX (it sets the platform and the 8 virtual devices), and
``splatbench/tests`` asserts that no JAX is loaded.
"""
import faulthandler
import signal
import threading
from contextlib import contextmanager

import pytest

# Each of these runs shard_map eagerly (render(mesh=...) or jax.grad of it
# outside jax.jit), which compiles one 8-device program per primitive: more
# than 400 s each on CPU. Their compiled twins are in tests/test_dist_jit.py.
SLOW_NODE_IDS = (
    "tests/test_dist.py::test_sharded_render_matches_single",
    "tests/test_dist.py::test_sharded_gradients_match_single",
    "tests/test_dist.py::test_sharded_pallas_matches_single",
    "tests/test_dist.py::test_sharded_binning_production_switches",
)

# Each of setup, call and teardown fails past this many seconds, with every
# thread's stack written to stderr. Tests marked slow are exempt.
TIME_LIMIT_S = 600


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.nodeid in SLOW_NODE_IDS:
            item.add_marker(pytest.mark.slow)


def _on_alarm(signum, frame):
    faulthandler.dump_traceback(all_threads=True)
    pytest.fail(f"time limit {TIME_LIMIT_S} s")


@contextmanager
def _time_limit(item):
    """Arms SIGALRM and a faulthandler watchdog for one phase of ``item``.

    The watchdog dumps the stacks even where the main thread is stuck in C
    code and the alarm's handler cannot run. Only the main thread of a POSIX
    process can take the alarm; elsewhere this does nothing.
    """
    if (
        item.get_closest_marker("slow") is not None
        or not hasattr(signal, "SIGALRM")
        or threading.current_thread() is not threading.main_thread()
    ):
        yield
        return
    previous = signal.signal(signal.SIGALRM, _on_alarm)
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=False)
    signal.alarm(TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True, tryfirst=True)
def pytest_runtest_setup(item):
    with _time_limit(item):
        return (yield)


@pytest.hookimpl(wrapper=True, tryfirst=True)
def pytest_runtest_call(item):
    with _time_limit(item):
        return (yield)


@pytest.hookimpl(wrapper=True, tryfirst=True)
def pytest_runtest_teardown(item, nextitem):
    with _time_limit(item):
        return (yield)
