"""What keeps the program a GPU program: refusals without a card, the
compile cache, the packages it may need, matmul precision, the config
surface and the peak table."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _json_lines(text):
    return [l for l in text.splitlines() if l.lstrip().startswith("{")]


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_exits_nonzero_without_gpu(where, tmp_path):
    """On the CPU — and in a directory holding chip_smoke.py and nothing
    else of the repo — the script fails and prints no result."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, str(script)], env=_cpu_env(), cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert not _json_lines(proc.stdout), proc.stdout


def test_chip_smoke_result_line_format():
    import chip_smoke

    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line(Dev(), 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }


def test_chip_smoke_four_refuses_fewer_than_four_gpus(monkeypatch, capsys):
    import jax

    import chip_smoke

    class Gpu:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda *a: [Gpu(), Gpu()])
    with pytest.raises(SystemExit) as exc:
        chip_smoke.phase0_device(four=True)
    assert exc.value.code != 0
    assert "needs 4 NVIDIA GPU(s)" in capsys.readouterr().err


def test_bench_exits_nonzero_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")], env=_cpu_env(),
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert not _json_lines(proc.stdout), proc.stdout
    assert "needs an NVIDIA GPU" in proc.stderr


# -------------------------------------------------------- compile cache
def _record_config(monkeypatch):
    import jax

    calls = {}
    monkeypatch.setattr(jax.config, "update", calls.__setitem__)
    return calls


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from tpumcia.utils.cache import enable_compilation_cache

    calls = _record_config(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compilation_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls  # jax reads the env


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    from tpumcia.utils.cache import enable_compilation_cache

    calls = _record_config(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert enable_compilation_cache() == want
    assert calls["jax_compilation_cache_dir"] == want


# ------------------------------------------------------------- packages
_BLOCKED_MAIN_PATH = r"""
import importlib.abc, sys

BLOCKED = {"flax", "sklearn", "h5py", "imageio", "matplotlib", "orbax"}


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked optional package: {name}")


sys.meta_path.insert(0, Block())
import numpy as np

import tpumcia
from tpumcia.config import HeadConfig, MeshConfig, PipelineConfig, SynthConfig
from tpumcia.io.synthetic import synthetic_mednist
from tpumcia.pipeline.run import run_pipeline

gray, labels, _ = synthetic_mednist(40, seed=0)
res = run_pipeline(gray, labels, config=PipelineConfig(
    mesh=MeshConfig(data=1), synth=SynthConfig(noise_channels=2),
    head=HeadConfig(num_steps=50), fast_path="always",
))
assert res.features.shape == (240, 69), res.features.shape
assert int(np.argmax(res.channel_result.total)) == 0
assert not BLOCKED & {m.split(".")[0] for m in sys.modules}
print("MAIN_PATH_OK")
"""


def test_main_path_runs_without_optional_packages():
    """flax, sklearn, h5py, imageio, matplotlib and orbax are extras: the
    fast main path must import and run with all of them blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_MAIN_PATH], env=_cpu_env(),
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "MAIN_PATH_OK" in proc.stdout


# ------------------------------------------------------------ precision
def _f32_dots(jaxpr):
    """Every dot_general with a float32 operand in ``jaxpr`` and its
    sub-jaxprs (jit, scan/map bodies, ...). The bf16 x bf16 one-hot count
    products are exact at any precision (0/1 operands, f32 accumulation);
    a float32 operand is what TF32 would round."""
    from jax.extend.core import ClosedJaxpr, Jaxpr

    def subs(v):
        if isinstance(v, ClosedJaxpr):
            yield v.jaxpr
        elif isinstance(v, Jaxpr):
            yield v
        elif isinstance(v, (tuple, list)):
            for x in v:
                yield from subs(x)

    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
            v.aval.dtype == np.float32 for v in eqn.invars
        ):
            yield eqn
        for v in eqn.params.values():
            for sub in subs(v):
                yield from _f32_dots(sub)


def _not_highest(jaxpr):
    from jax.lax import Precision

    return [
        str(e) for e in _f32_dots(jaxpr)
        if e.params["precision"] is None
        or any(p != Precision.HIGHEST for p in e.params["precision"])
    ]


@pytest.mark.parametrize("variant", ["plain", "masked", "synth"])
def test_fused_dispatch_f32_matmuls_are_highest(variant):
    """A float32 matmul at DEFAULT precision may run as TF32 on a GPU (10
    mantissa bits): every one inside the fused per-batch dispatch — stats,
    wire and the device feature block — must be pinned to HIGHEST."""
    import jax

    from tpumcia.features.extract import _batch_fused_dispatch
    from tpumcia.features.stats import rescale_lut_device

    rng = np.random.default_rng(0)
    if variant == "synth":
        imgs = rng.integers(0, 256, (2, 16, 16), dtype=np.uint8)
        args = (imgs, None, jax.random.key(0))
    else:
        imgs = rng.integers(0, 256, (2, 16, 16, 2), dtype=np.uint8)
        mask = rng.random((2, 16, 16, 2)) > 0.3 if variant == "masked" else None
        args = (imgs, mask, None)

    def fn(imgs, mask, key, lut):
        return _batch_fused_dispatch(
            imgs, mask, key, lut, levels=256,
            offset=(0, 5), keep_device=True, chunk_size=2,
            onehot_dtype="bfloat16", synth_noise=2 if variant == "synth" else 0,
        )

    jaxpr = jax.make_jaxpr(fn)(*args, rescale_lut_device(256)).jaxpr
    assert list(_f32_dots(jaxpr)), "expected the HIGHEST rescale matmuls"
    assert _not_highest(jaxpr) == []


def test_device_finalize_f32_matmuls_are_highest():
    import jax
    import jax.numpy as jnp

    from tpumcia.features.finalize import _finalize
    from tpumcia.features.stats import sufficient_stats

    rng = np.random.default_rng(1)
    stats = sufficient_stats(rng.integers(0, 256, (2, 16, 16, 2), dtype=np.uint8))
    jaxpr = jax.make_jaxpr(
        lambda st: _finalize(st, jnp, jnp.float32, True, True).values
    )(stats).jaxpr
    assert _not_highest(jaxpr) == []


# --------------------------------------------------------- config / peaks
def test_config_naming_use_pallas_is_rejected():
    from tpumcia.config import PipelineConfig

    with pytest.raises(ValueError, match=r"unknown config\.features key.*use_pallas"):
        PipelineConfig.from_dict({"features": {"use_pallas": "never"}})


def test_peak_table_keyed_by_device_kind():
    from benchmarks import mfu

    h100 = mfu.peaks("NVIDIA H100 80GB HBM3")
    assert h100["bf16_flops"] == 989e12 and h100["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(ValueError, match="no published peaks"):
        mfu.peaks("Some Other Accelerator")
    assert "of peak" in mfu.cnn_table("NVIDIA H100 80GB HBM3", 1000.0, 1000.0)
