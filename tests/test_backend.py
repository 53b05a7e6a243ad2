"""The platform table (maria_tpu/backend.py): gate selection, the
compile-cache rule and device-memory budgets."""

import os
import subprocess
import sys

import pytest

from maria_tpu import backend

GATES = sorted(backend.GATES)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("gate", GATES)
def test_gate_follows_the_platform_table(gate, platform, monkeypatch):
    """Each gate reads its side from the table, for the platform asked
    or the running one, and only from the table."""
    for side in (True, False):
        monkeypatch.setitem(backend.GATES, gate, {**backend.GATES[gate], platform: side})
        assert backend.use(gate, platform) is side
        monkeypatch.setattr(backend, "platform", lambda: platform)
        assert backend.use(gate) is side


def test_unknown_platform_is_an_error():
    with pytest.raises(ValueError, match="no 'matmul_fft' choice for platform 'metal'"):
        backend.use("matmul_fft", "metal")


def test_fft_gate_reads_the_table(monkeypatch):
    from maria_tpu.ops.fft import use_matmul_fft

    monkeypatch.delenv("MARIA_TPU_FFT", raising=False)
    for side in (True, False):
        monkeypatch.setitem(backend.GATES, "matmul_fft", {"cpu": side, "gpu": side})
        assert use_matmul_fft() is side
    monkeypatch.setenv("MARIA_TPU_FFT", "matmul")
    assert use_matmul_fft()


@pytest.mark.parametrize("preset", [True, False])
def test_compile_cache_rule(preset, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and nothing is
    set over it; otherwise a fixed directory inside the checkout."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    if preset:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    code = (
        "import jax\n"
        "from maria_tpu import backend\n"
        "print(backend.enable_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)), timeout=120)
    assert out.returncode == 0, out.stderr
    chosen, configured = out.stdout.split()
    expected = str(tmp_path / "cache") if preset else backend.DEFAULT_COMPILE_CACHE
    assert chosen == configured == expected
    assert "/tmp/" not in backend.DEFAULT_COMPILE_CACHE or preset
    assert backend.DEFAULT_COMPILE_CACHE.endswith(os.path.join("", ".jax_cache"))


def test_memory_budget_is_a_constant_on_the_cpu():
    assert backend.platform() == "cpu"
    assert backend.memory_budget(0.5, 1.25e9) == 1.25e9
