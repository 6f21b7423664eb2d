import os
import sys

# Tests must see the default single CPU device (the 512-device override is
# for the dry-run driver ONLY).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def require_or_skip_hypothesis():
    """Skip a hypothesis-based module when the package is missing locally —
    but hard-fail when REQUIRE_HYPOTHESIS is set (CI sets it, so the
    property suites can never silently report "skipped" there)."""
    import pytest

    if os.environ.get("REQUIRE_HYPOTHESIS"):
        import hypothesis  # noqa: F401 — ImportError here IS the failure
    else:
        pytest.importorskip("hypothesis")


import pytest  # noqa: E402 — after the sys.path insert above


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself without one"
    )


@pytest.fixture
def compile_sentinel():
    """Recompile/tracer-leak sentinel for any suite: yields the
    ``repro.analysis.sentinels`` module so tests can count compilations
    (``with compile_sentinel.count_compiles() as c:``) or assert the
    compile-once contract (``compile_sentinel.assert_compiles_once(fn)``)
    without importing the analysis package themselves."""
    from repro.analysis import sentinels

    return sentinels
