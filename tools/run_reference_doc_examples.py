"""Run the reference docs' code examples against maria_tpu.

Usage:
    python tools/extract_reference_doc_examples.py   # writes the JSON
    JAX_PLATFORMS=cpu python tools/run_reference_doc_examples.py [doc-substr ...]

Aliases the 'maria' module name to maria_tpu (including all submodules)
so `import maria` / `from maria.instrument import Band` resolve to our
package, seeds a namespace with the notebook-context stand-ins, then
execs each doc's blocks sequentially (240 s alarm per block). See
docs/reference-docs-parity.md for the scorecard.
"""
import importlib
import json
import os
import pkgutil
import sys
import traceback

os.environ.setdefault("MPLBACKEND", "Agg")

import maria_tpu

# alias maria -> maria_tpu for every (sub)module
sys.modules["maria"] = maria_tpu
for m in pkgutil.walk_packages(maria_tpu.__path__, prefix="maria_tpu."):
    try:
        mod = importlib.import_module(m.name)
    except Exception:
        continue
    sys.modules["maria" + m.name[len("maria_tpu"):]] = mod

import matplotlib.pyplot as plt

examples = json.load(open("/tmp/ref_doc_examples.json"))  # from the extractor below
only = sys.argv[1:] or None

PREAMBLE = """
import numpy as np
import maria
from maria import Band, Simulation, TOD, Planner, Plan
my_site = maria.get_site("green_bank")
my_instrument = maria.get_instrument("test/1deg")
my_plan = my_plans = maria.get_plan("five_second_stare", start_time=1.75e9, scan_center=(60.0, 45.0))
my_atmosphere = "2d"
my_cmb = None
my_map = my_input_map = maria.map.get("cluster")
from maria.mappers import BinMapper, MaximumLikelihoodMapper, compute_residual_map
_sim = Simulation(instrument=my_instrument, plans=my_plan, site=my_site, atmosphere="2d", noise=True, seed=7)
tod = tod1 = tod2 = _sim.run()[0]
data = np.random.standard_normal((64, 64)).astype("float32") * 1e-5
weight = np.ones_like(data)
units = "K_RJ"
ra, dec = 150.0, 10.0
nu1, nu2, nu3 = 90e9, 150e9, 220e9
sky_x = np.linspace(-0.05, 0.05, 16); sky_y = np.linspace(-0.05, 0.05, 16)
baseline_x = np.linspace(0, 100, 16); baseline_y = np.zeros(16); baseline_z = np.zeros(16)
f090 = maria.get_band("act/pa5/f090"); f150 = maria.get_band("act/pa5/f150")
band_1 = Band(center=150e9, width=30e9, NET_RJ=1e-5)
band_2 = {"center": 90e9, "width": 30e9, "NEP": 1e-15}
my_band = Band(center=150e9, width=30e9, NET_RJ=1e-5)
my_array = {"n": 37, "field_of_view": 0.2, "primary_size": 10, "bands": [my_band]}
map_in_some_other_units = maria.map.get("cluster").to("mK_RJ")
map_without_frequency_dim = maria.map.get("cluster")
import os as _os
_scratch = "/tmp/doc-harness-scratch"
_os.makedirs(_scratch, exist_ok=True)
_os.chdir(_scratch)
_m = maria.map.get("cluster")
_m.to_fits("my_fits_map.fits"); _m.to_hdf("my_hdf_map.h5")
tod.to_fits("filename.fits"); tod.to_hdf("filename.h5")
"""

# Per-(doc, block) setup: a few doc blocks describe their inputs only in
# prose ("an array with shape e.g. (4, 3, 256, 256)"); these hooks give
# the namespace exactly the shapes the prose describes.
BLOCK_SETUP = {
    ("usage/inputs/maps/maps.rst", 5): (
        "data = np.zeros((4, 3, 64, 64), dtype='float32'); "
        "weight = np.ones_like(data)"
    ),
    ("usage/inputs/maps/maps.rst", 6): (
        "data = np.zeros((4, 3, 12 * 16**2), dtype='float32'); "
        "weight = np.ones_like(data)"
    ),
}

results = {}
for doc, blocks in examples.items():
    if only and not any(o in doc for o in only):
        continue
    ns = {}
    exec(compile(PREAMBLE, "<preamble>", "exec"), ns)
    doc_results = []
    for i, block in enumerate(blocks):
        block = block.replace(", ...]", "]")  # docs' literal ellipses in lists
        setup = BLOCK_SETUP.get((doc, i))
        if setup:
            exec(compile(setup, f"{doc}[{i}] setup", "exec"), ns)
        import signal

        def _alarm(sig, frame):
            raise TimeoutError("block exceeded 240s")

        signal.signal(signal.SIGALRM, _alarm)
        signal.alarm(240)
        try:
            code = compile(block, f"{doc}[{i}]", "exec")
            exec(code, ns)
            doc_results.append({"block": i, "ok": True})
        except Exception as e:
            tb = traceback.format_exc().strip().splitlines()
            doc_results.append({
                "block": i, "ok": False,
                "error": f"{type(e).__name__}: {e}",
                "line": next((ln.strip() for ln in reversed(tb) if doc in ln), ""),
            })
        signal.alarm(0)
        plt.close("all")
    results[doc] = doc_results
    n_ok = sum(r["ok"] for r in doc_results)
    print(f"{doc}: {n_ok}/{len(doc_results)} ok", flush=True)

json.dump(results, open("/tmp/doc_example_results.json", "w"), indent=1)
print("\nFAILURES:")
for doc, rs in results.items():
    for r in rs:
        if not r["ok"]:
            print(f"  {doc}[{r['block']}]: {r['error'][:200]}")
