"""The simulation and mapping path imports only numpy, scipy, jax and the
standard library: with pandas, h5py, yaml, matplotlib and tqdm blocked,
a tiny Simulation -> BinMapper still runs."""

import os
import subprocess
import sys

SCRIPT = r"""
import importlib.abc, sys

OPTIONAL = {"pandas", "h5py", "yaml", "matplotlib", "tqdm"}


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in OPTIONAL:
            raise ImportError(f"{name} is blocked")


sys.meta_path.insert(0, Block())
import numpy as np
import maria_tpu
from maria_tpu.mappers import BinMapper

sim = maria_tpu.Simulation(instrument="test/1deg", plans="five_second_stare",
                           site="green_bank", atmosphere="2d", noise=True, seed=1)
tod = sim.run()[0]
out = BinMapper([tod], frame="az/el", units="K_RJ").run()
assert np.isfinite(np.asarray(tod.signal)).all()
assert (np.asarray(out.weight) > 0).any()
assert not [m for m in sys.modules if m.split(".")[0] in OPTIONAL]
try:
    maria_tpu.site_data
except ImportError as e:
    assert "pandas" in str(e)
else:
    raise AssertionError("site_data needs pandas")
print("ok")
"""


def test_main_path_needs_no_optional_package(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "MARIA_TPU_CACHE_DIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env, capture_output=True,
                         text=True, timeout=600,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
