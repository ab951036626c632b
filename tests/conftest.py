"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding tests use XLA's forced host platform device count, as
the reference never needed (SURVEY.md section 4) — no accelerator is needed
for the test suite. The backend is pinned through jax.config before any
device is touched; XLA_FLAGS is read at backend initialization, so setting
it here works.

Tests that need the card carry the `gpu` marker and the `gpu` fixture. On
the machine with the card, `python -m pytest -m gpu tests/` runs them on
the default backend; every other selection pins JAX to the CPU, where they
skip.
"""

import os
import pathlib

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# small work-queue quantum for CPU tests: the production default (32k) is
# sized for the chip; on the CPU backend every masked window row executes
# for real, so tests would crawl (and the big while_loop body compiles for
# minutes). 256 stresses the ordering logic harder anyway.
os.environ.setdefault("FLOXER_TPU_WQ_QUANTUM", "256")

import jax

import signal

import pytest


def pytest_configure(config):
    if config.getoption("markexpr", "") != "gpu":
        jax.config.update("jax_platforms", "cpu")
    config.addinivalue_line(
        "markers",
        "timeout(seconds): abort the test if it runs longer. pytest-timeout "
        "is not installed in this image; this SIGALRM-based implementation "
        "(conftest.py) makes the mark real so a hung distributed test is "
        "killed instead of wedging CI.",
    )


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    marker = item.get_closest_marker("timeout")
    if marker is None or not marker.args:
        return (yield)
    seconds = int(marker.args[0])

    def on_alarm(signum, frame):
        raise TimeoutError(
            f"test exceeded its timeout mark of {seconds} seconds"
        )

    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(seconds)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return pathlib.Path(__file__).parent / "data"


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest -m gpu tests/` there")
