"""chip_smoke.py's phases, rehearsed at a tiny size on the CPU: the same
code paths and checks the card runs at full width. The script itself
refuses to run without a CUDA card."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

TINY = chip_smoke.Size(
    m2_instrument="MUSTANG-2", m2_duration=10.0, atlast_instrument="MUSTANG-2",
    atlast_duration=10.0, long_duration=20.0, sample_rate=20.0, ml_iters=3, repeats=1,
)


@pytest.mark.parametrize("phase", ["mustang2", "atlast", "noise", "streamed", "ml", "gates"])
def test_phase_at_tiny_size(phase, capsys):
    fields = getattr(chip_smoke, f"phase_{phase}")(TINY)
    assert isinstance(fields, dict) and fields
    assert f'"phase": "{phase}"' in capsys.readouterr().out


def test_multi_phase_on_four_virtual_devices():
    fields = chip_smoke.phase_multi(TINY, 4)
    assert fields["mesh"] == {"det": 2, "time": 2}


def test_refuses_without_a_card():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PATH": "/nonexistent"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
