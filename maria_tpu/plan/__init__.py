"""Scan plans (reference: maria/plan/__init__.py:43-80)."""

from __future__ import annotations

import glob
import os

from ..io import read_json
from .patterns import SCAN_PATTERNS, all_patterns, get_scan_pattern_generator  # noqa: F401
from .plan import Plan, PlanList  # noqa: F401
from .planner import Planner  # noqa: F401

here = os.path.dirname(__file__)

PLAN_CONFIGS = {}
for path in sorted(glob.glob(f"{here}/configs/*.json")):
    PLAN_CONFIGS.update(read_json(path))

all_plans = sorted(PLAN_CONFIGS)

# kinematic/elevation sanity thresholds (reference: plan/plan.py:31-34)
MAX_ACCELERATION_WARN = 10  # deg/s^2
MIN_ELEVATION_WARN = 20  # deg
MIN_ELEVATION_ERROR = 10  # deg

# the typed fields a plan config may carry (reference: plan/__init__.py:75)
PLAN_FIELDS = {
    "start_time": (float, str),
    "duration": float,
    "sample_rate": float,
    "frame": str,
    "degrees": bool,
    "scan_center": tuple,
    "scan_pattern": str,
    "scan_options": dict,
}


class UnsupportedPlanError(Exception):
    def __init__(self, plan_name):
        super().__init__(
            f"'{plan_name}' is not a supported plan. Supported plans are {all_plans}.",
        )


def get_plan_config(plan_name: str = "ten_second_zenith_stare", **kwargs) -> dict:
    if plan_name not in PLAN_CONFIGS:
        raise UnsupportedPlanError(plan_name)
    config = dict(PLAN_CONFIGS[plan_name])
    config.update(kwargs)
    return config


def get_plan(plan_name: str = None, **kwargs) -> Plan:
    """A Plan from the registry, or built directly from kwargs when no
    name is given (the reference's get_plan accepts bare kwargs, e.g.
    get_plan(scan_pattern="stare", duration=60, ...))."""
    if "pointing_frame" in kwargs:  # reference alias (docs usage/inputs/plans)
        kwargs["frame"] = kwargs.pop("pointing_frame")
    if plan_name is None:
        if "scan_pattern" in kwargs or "scan_center" in kwargs:
            # fully-specified bare kwargs (reference docs get_plan form)
            return Plan.generate(**kwargs)
        # plain overrides (e.g. duration=) still modify the default plan
        plan_name = "ten_second_zenith_stare"
    if plan_name not in PLAN_CONFIGS and plan_name in SCAN_PATTERNS:
        # bare pattern name, e.g. Simulation(plans="stare")
        # (reference docs usage/getting-started)
        return Plan.generate(scan_pattern=plan_name, **kwargs)
    return Plan.generate(**get_plan_config(plan_name, **kwargs))


def validate_pointing_kwargs(kwargs: dict):
    """A plan needs an end: one of 'end_time' or 'duration' (reference
    maria/plan/__init__.py:87-94)."""
    if "end_time" not in kwargs and "duration" not in kwargs:
        raise ValueError("One of 'end_time' or 'duration' must be in the plan kwargs.")


def _build_plan_data():
    from ..utils import require

    pd = require("pandas")

    return pd.DataFrame(PLAN_CONFIGS).T.sort_index()


# reference parity: browsable tables / lowercase registry aliases;
# a DataFrame view, built on first use since pandas is optional
def __getattr__(name):
    if name == "plan_data":
        return _build_plan_data()
    raise AttributeError(name)
from .patterns import SCAN_PATTERNS as scan_patterns  # noqa: E402, F401
