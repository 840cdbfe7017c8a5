"""What a run of the whole suite needs beyond tests/conftest.py.

``tests/test_suite_plugin.py`` loads this module for the whole session
through its ``pytest_plugins``: pytest registers it while it collects that
file, after every ``pytest_configure`` that came before it (it runs this
one's then) and before any test runs.

- Every test runs under a time limit: ``DEFAULT_TIMEOUT`` seconds, or the
  ``timeout(seconds)`` marker's.  A hang fails that one test, named,
  instead of holding the whole run until an outer clock cuts it.
- The persistent XLA compile cache stays off, as tests/conftest.py says it
  is in a plain ``pytest tests/``, whatever a test turns on later.
- ``SLOW_TESTS``, the costliest tests of the files that predate the port,
  carry the ``slow`` marker, so that ``-m 'not slow'`` deselects them.
  ``pytest tests/ -m slow`` runs them, and so does ``tests/run_suite.sh``
  (one file a process, so this plugin is not loaded there).
- ``test_end_to_end.py``'s chain of tests on its trained fixture starts
  first.
"""

import faulthandler
import os
import signal
import sys
import threading

import pytest

# Nearly 2x the slowest tests left in a `-m 'not slow'` run
# (test_parallel.py::test_full_model_dp_tp_train_step and
# test_end_to_end.py::test_train_checkpoints_eval with its fixture,
# 455-545 s on an 8-core host), and well below the 1470 s an outer clock
# gives the whole run, so that a hang fails its own test first.
DEFAULT_TIMEOUT = 900
# A test stuck in C code (an XLA compile, a collective) never returns to the
# interpreter, so SIGALRM cannot fail it: this long after its limit,
# faulthandler prints every thread's stack and ends the process (under xdist
# the worker is replaced and the test reported as crashed).
HARD_GRACE = 60
_STDERR = pytest.StashKey[int]()

# `file::test` of the tests that each take a sixth or more of what one worker
# of the Tier-1 run (-n 6, 1470 s) has.  Each tests only the frozen JAX
# package.  Seconds are setup + call + teardown on an 8-core host, from the
# per-test timings in CHANGES.md: "step 1" (the suite before this list) and
# "after" (its run with the fixture chain first).  test_end_to_end.py's
# test_train_checkpoints_eval (452.6 s, after) stays in the run: it is the
# first user of the module fixture `tiny_setup`, whose training run would
# only move to the next test of the chain.
SLOW_TESTS = frozenset({
    "test_parallel.py::test_multihost_data_parallel_train_step",  # 560.4 after
    # 559.1 after
    "test_parallel.py::test_data_parallel_train_step_matches_single_device",
    "test_end_to_end.py::test_cli_train_dp_sp",  # 457.7 after
    "test_end_to_end.py::test_cli_train_data_parallel",  # 450.3 after
    "test_end_to_end.py::test_resume_continues",  # 481.9 step 1
    "test_train_eval.py::test_grad_accum_matches_full_batch",  # 395.0 step 1
    "test_parallel.py::test_seq_sharded_scan_pallas_backend",  # 355.1 step 1
    "test_parallel.py::test_full_model_dp_sp_train_step",  # 345.5 step 1
    "test_bf16.py::test_ssm_out_dtype_bf16_model",  # 273.2 after
    "test_fuzz_scan.py::test_pallas_fuzz_vs_oracle",  # 261.6 after
    "test_bf16.py::test_bf16_dtypes_and_values",  # 243.9 after
    "test_train_eval.py::test_train_step_overfits_tiny",  # 240.7 step 1
})


def pytest_configure(config):
    # the real stderr for the stack dump: while a test runs, fd 2 is a
    # capture file that dies with the process
    config.stash[_STDERR] = os.dup(sys.__stderr__.fileno())
    if (os.environ.get("FOCALNET_TEST_CACHE") == "1"
            or os.environ.get("FOCALNET_TPU_TESTS") == "1"):
        return  # tests/conftest.py turns the cache on for these runs
    import jax

    # The CLI's main() runs enable_compilation_cache(), which sets the dir
    # and the threshold but never this switch, so the cache stays off for
    # the life of the process (tests/test_suite_plugin.py).
    jax.config.update("jax_enable_compilation_cache", False)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR])


def _e2e_chain(item):
    return (item.path.name == "test_end_to_end.py"
            and "tiny_setup" in item.fixturenames)


# first, so that the marks are on before the `-m` selection reads them
@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    for item in items:
        if f"{item.path.name}::{item.name}" in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)

    # This order pays only under xdist's `--dist load`, and only as long as
    # it hands each worker a run of consecutive items first (a quarter of
    # the worker's share: 28 of ~680 at -n 6).  test_end_to_end.py's tests
    # on its module fixture `tiny_setup` (a training run) must share one
    # worker, or each worker trains it again; they are the run's longest
    # chain, so they go first, and the cheap guards fill the rest of that
    # worker's first run.
    def rank(item):
        if _e2e_chain(item):
            return 0
        return 1 if item.path.name == "test_torch_guards.py" else 2

    items.sort(key=rank)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    marker = item.get_closest_marker("timeout")
    limit = marker.args[0] if marker else DEFAULT_TIMEOUT
    if threading.current_thread() is not threading.main_thread():
        yield  # signals reach the main thread only
        return

    def expired(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its time limit of {limit} s")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.alarm(limit)
    faulthandler.dump_traceback_later(limit + HARD_GRACE, exit=True,
                                      file=item.config.stash[_STDERR])
    try:
        yield
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)
