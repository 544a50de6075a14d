"""The top-level conftest.py's per-phase time limit, at a limit of 1 s.

An inner pytest run in a scratch directory takes a copy of the conftest with
TIME_LIMIT_S = 1, once in one process and once under xdist (the tier-1
command's shape): a 5 s test fails with the limit and a stack dump, a slow
test of 2 s is exempt, and a test of 0.1 s passes.
"""
import os
import pathlib
import subprocess
import sys

import pytest

CONFTEST = pathlib.Path(__file__).resolve().parent.parent / "conftest.py"

INNER_TESTS = """\
import time

import pytest


def test_sleeps_past_limit():
    time.sleep(5)


@pytest.mark.slow
def test_slow_is_exempt():
    time.sleep(2)


def test_quick():
    time.sleep(0.1)
"""


@pytest.mark.parametrize("workers", [[], ["-p", "xdist", "-n", "1"]],
                         ids=["one_process", "xdist"])
def test_phase_past_limit_fails_with_stacks(tmp_path, workers):
    text = CONFTEST.read_text()
    assert "\nTIME_LIMIT_S = 600\n" in text
    (tmp_path / "conftest.py").write_text(
        text.replace("\nTIME_LIMIT_S = 600\n", "\nTIME_LIMIT_S = 1\n")
    )
    (tmp_path / "test_inner.py").write_text(INNER_TESTS)
    env = dict(os.environ, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
         *workers, "test_inner.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60,
    )
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert "FAILED test_inner.py::test_sleeps_past_limit - Failed: time limit 1 s" in out
    assert "PASSED test_inner.py::test_slow_is_exempt" in out
    assert "PASSED test_inner.py::test_quick" in out
    # faulthandler's dump: every thread, the sleeping test's frame among them
    assert "most recent call first" in out, out
    assert "in test_sleeps_past_limit" in out, out
