"""Loads tests/suite_plugin.py for the whole session, and holds it to what
it promises: a time limit per test, no persistent compile cache in a plain
`pytest tests/` process, and the `slow` marker on the tests its list
names."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest_plugins = ["pytester", "suite_plugin"]

_CACHE_ON = (os.environ.get("FOCALNET_TEST_CACHE") == "1"
             or os.environ.get("FOCALNET_TPU_TESTS") == "1")


def test_time_limit_fails_a_test_that_runs_past_it(pytester, monkeypatch):
    """A test that sleeps past its `timeout` marker fails at the limit, and
    the failure names the limit.  The inner run is a process of its own, so
    that its limit does not replace this test's."""
    monkeypatch.setenv("PYTHONPATH", os.path.dirname(__file__))
    pytester.makepyfile("""
        import time

        import pytest

        @pytest.mark.timeout(1)
        def test_sleeps_past_its_limit():
            time.sleep(60)
    """)
    t0 = time.monotonic()
    result = pytester.runpytest_subprocess("-p", "suite_plugin",
                                           "-p", "no:cacheprovider")
    assert time.monotonic() - t0 < 30
    result.assert_outcomes(failed=1)
    result.stdout.fnmatch_lines(["*ran past its time limit of 1 s*"])


@pytest.mark.skipif(_CACHE_ON, reason="FOCALNET_TEST_CACHE=1 and "
                    "FOCALNET_TPU_TESTS=1 turn the cache on")
def test_cli_main_leaves_the_compile_cache_off(tmp_path, monkeypatch):
    """An in-process CLI call turns the persistent cache on
    (`enable_compilation_cache`); a compile after it must still write
    nothing to the cache dir."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    from focalnet_tpu.main import main, parse_args
    from focalnet_tpu.models import build_net
    from focalnet_tpu.train.checkpoint import CheckpointManager

    # the cheapest CLI mode: Orbax dir -> reference .pkl, with zero weights
    # of the tiny model's shapes (no compile needed to make them)
    shapes = jax.eval_shape(
        build_net("1mlp_g2", scan_backend="chunked", vssg_dim=16,
                  ssm_d_state=4).init,
        {"params": jax.random.PRNGKey(0)}, jax.ShapeDtypeStruct(
            (1, 32, 32, 3), np.float32))
    params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                          shapes)["params"]
    ckpt = CheckpointManager(str(tmp_path / "weights"), async_save=False)
    ckpt._save("Best", {"params": params})
    ckpt.wait()

    cache_dir = tmp_path / "cache"
    monkeypatch.setenv("FOCALNET_COMPILE_CACHE", str(cache_dir))
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        cc.reset_cache()  # decide afresh, whatever ran in this process
        main(parse_args([
            "--mode", "convert", "--input", str(tmp_path / "weights" / "Best"),
            "--output", str(tmp_path / "exported.pkl"),
            "--vssg_dim", "16", "--ssm_d_state", "4",
            "--scan_backend", "chunked",
            "--model_save_dir", str(tmp_path / "weights"),
            "--result_dir", str(tmp_path / "results"),
        ]))
        assert os.path.isfile(tmp_path / "exported.pkl")
        assert jax.config.jax_compilation_cache_dir == str(cache_dir)
        # every compile is worth caching now, if the cache is on at all
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        y = jax.jit(lambda x: jnp.sin(x) + 1.0)(np.arange(7, dtype=np.float32))
        assert float(y[0]) == 1.0
        assert not cache_dir.exists() or not any(cache_dir.iterdir())
    finally:
        jax.config.update("jax_compilation_cache_dir", before[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          before[1])
        cc.reset_cache()


def test_slow_list_names_collected_pre_port_tests(pytester, monkeypatch):
    """With the plugin loaded as the Tier-1 run loads it, `-m slow` collects
    exactly the tests that `SLOW_TESTS` names, so a renamed test leaves no
    stale entry, and `-m 'not slow'` collects none of them.  No entry is a
    test of the port."""
    from suite_plugin import SLOW_TESTS

    assert SLOW_TESTS
    assert not [t for t in SLOW_TESTS if t.startswith("test_torch_")]
    here = os.path.dirname(os.path.abspath(__file__))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(filter(None, [
        os.path.dirname(here), os.environ.get("PYTHONPATH")])))
    files = sorted({t.split("::")[0] for t in SLOW_TESTS})
    paths = [os.path.join(here, f) for f in files + ["test_suite_plugin.py"]]

    def collect(expr):
        result = pytester.runpytest_subprocess(
            *paths, "-m", expr, "--collect-only", "-q",
            "-p", "no:cacheprovider")
        assert result.ret == 0, result.stdout.str()
        return {os.path.basename(line.strip())
                for line in result.stdout.lines if "::" in line}

    assert collect("slow") == SLOW_TESTS
    fast = collect("not slow")
    assert fast and not fast & SLOW_TESTS
