"""Test harness setup.

The default suite runs on a *CPU-simulated 8-device mesh*
(``--xla_force_host_platform_device_count=8``) — the standard JAX substitute
for multi-device hardware (SURVEY.md §4). The device count must be fixed
before jax initializes its backend, so ``pytest_configure`` re-execs pytest
once with ``JAX_PLATFORMS=cpu`` and that flag when the environment does not
already carry them (global capture is stopped first so the child's output
reaches the terminal). The decision reads the environment only: it never
initializes a backend.

Set ``TPUMCIA_TEST_BACKEND=native`` to skip the re-exec and run against
whatever backend the environment provides. Tests that need an NVIDIA GPU
carry the ``gpu`` marker and skip elsewhere; on the card run them with
``TPUMCIA_TEST_BACKEND=native python -m pytest -m gpu tests/``.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


def _needs_cpu_reexec() -> bool:
    if os.environ.get("TPUMCIA_TEST_BACKEND", "cpu") != "cpu":
        return False
    if os.environ.get("TPUMCIA_REEXECED") == "1":
        return False
    return (
        os.environ.get("JAX_PLATFORMS") != "cpu"
        or "xla_force_host_platform_device_count"
        not in os.environ.get("XLA_FLAGS", "")
    )


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: requires an NVIDIA GPU backend")
    config.addinivalue_line("markers", "slow: long-running test")

    if _needs_cpu_reexec():
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        flags = env.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            env["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        env["TPUMCIA_REEXECED"] = "1"
        capman = config.pluginmanager.getplugin("capturemanager")
        if capman is not None:
            capman.stop_global_capturing()
        sys.stdout.flush()
        sys.stderr.flush()
        os.execve(
            sys.executable,
            [sys.executable, "-m", "pytest", *config.invocation_params.args],
            env,
        )


def pytest_sessionstart(session):
    session._tpumcia_t0 = __import__("time").perf_counter()


def pytest_sessionfinish(session, exitstatus):
    """Append suite duration to .test_times.jsonl (gitignored) so suite-time
    regressions are visible across runs."""
    import json
    import time

    t0 = getattr(session, "_tpumcia_t0", None)
    if t0 is None:
        return
    rec = {
        "ts": time.time(),
        "duration_s": round(time.perf_counter() - t0, 1),
        "exitstatus": int(exitstatus),
        "testsfailed": int(getattr(session, "testsfailed", -1)),
        "testscollected": int(getattr(session, "testscollected", -1)),
        "args": list(session.config.invocation_params.args),
    }
    try:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ".test_times.jsonl",
        )
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless jax runs on a GPU. Decided here, per
    test, never at import or collection time: every xdist worker must
    collect the same tests."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: TPUMCIA_TEST_BACKEND=native "
            "python -m pytest -m gpu tests/"
        )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def small_batch(rng):
    """(B, 64, 64, 3) uint8 batch in the reference's synthesized-channel
    layout: channel 1 structured signal, channels 2-3 clipped gaussian noise."""
    from tpumcia.reference_impl import oracle

    imgs = []
    yy, xx = np.mgrid[:64, :64]
    for i in range(8):
        cy, cx = rng.integers(20, 44, size=2)
        sigma = rng.uniform(5, 12)
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2))) * 200
        base = rng.random((64, 64)) * 60
        img = np.clip(base + blob, 0, 255).astype(np.uint8)
        imgs.append(oracle.add_noise_channels(img, rng))
    return np.stack(imgs)
