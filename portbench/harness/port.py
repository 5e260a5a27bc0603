"""Handing the benchmark's inputs to the port: a world (a plain dict of
``reference/worlds.py``) as the port's ``DemoSpec``, and the solver
options of a configuration file as its ``IPMOptions``. Only the kinds
import this module; the reference never does."""

from __future__ import annotations

PORT = "vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch"


def demo_spec(world, params, name="bench"):
    """The port's DemoSpec of ``world`` with MPC parameters ``params``
    (a dict of ``MPCParams`` fields; the rest keep their defaults)."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios.demos import (
        DemoSpec, MPCParams, TerminalPolicy)

    return DemoSpec(
        name=name, x_lo=world["x_lo"], x_hi=world["x_hi"], start=world["start"],
        goal=world["goal"], static_lobs=world["static_lobs"], grid_rects=world["grid_rects"],
        dyn_obs_info=world["dyn_obs_info"], terminal_set=world["terminal_set"],
        terminal_policy=TerminalPolicy(world["ts_base"], world["ts_rel"]),
        sense_dis=world["sense_dis"], params=MPCParams(**params))


def options(d):
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        IPMOptions)

    return IPMOptions(**d)


def dtype_of(cfg):
    import torch

    return getattr(torch, cfg["precision"])


def same_shape(shape, world):
    """Refuse a world the port pads otherwise than the reference reads it
    (its obstacle slots and hyperplanes must line up with the plan's
    duals)."""
    from portbench.reference.worlds import shape_of

    if (shape.n_static, shape.n_dyn, shape.e_max) != shape_of(world):
        raise ValueError(f"the port's shape {shape} is not the reference's {shape_of(world)}")
