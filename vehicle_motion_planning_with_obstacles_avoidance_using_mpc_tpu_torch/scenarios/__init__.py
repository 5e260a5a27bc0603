"""Demo worlds as data and their padded-tensor scenarios."""

from .demos import (
    DEMOS,
    DemoSpec,
    MPCParams,
    TerminalPolicy,
    default_params_for,
    demo_names,
    get_demo,
)
from .build import Scenario, ShapeSpec, build_scenario, shape_spec_for

__all__ = [
    "DEMOS", "DemoSpec", "MPCParams", "TerminalPolicy", "default_params_for",
    "demo_names", "get_demo", "Scenario", "ShapeSpec", "build_scenario",
    "shape_spec_for",
]
