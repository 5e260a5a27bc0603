"""The comparisons that decide ``correct``, in numpy and plain PyTorch.

Free-time plans (the ticks' windows, the open loop's routes) are held to
the NLP the configuration states, worked out again here (``obca``,
``kkt``):

* ``viol_gap``: the largest gap, over every checked plan, between the
  violation the program reports for its plan (``IPMResult.viol``, on
  which its feasibility verdict rests) and the violation worked out here,
  relative to max(1, the latter). The program computes it in float32;
  the limit lies between float32's readings and the TF32 control's.
* ``obj_gap``: the same for the objective (``IPMResult.f`` against the
  configuration's objective of the plan): the program minimizes the
  stated objective.
* ``feas_viol``: the largest violation, worked out here, of a plan the
  program calls feasible. Its limit is the configuration's own:
  ``acceptable_viol_tol`` of the solver's options (Ipopt's acceptable
  level), plus the ``viol_gap`` limit for the program's float32 reading of
  it.
* ``feas_stat``: the largest scaled optimality error (``kkt``: the
  Lagrangian's gradient with multipliers fitted here, and
  complementarity), over a sample drawn from the seed of the plans the
  program calls feasible: a plan called feasible is a KKT point of the
  stated NLP, not merely a feasible one.
* ``infeas_share``: the share of plans the program could not make
  feasible, over the whole window (``max_infeasible_share``; the window
  batch's floor is bench.py's and chip_smoke.py's 0.99 feasible).

The limits are the cell's (``traffic/<name>.json`` ``limits``).

With ``control="tf32"`` the reference, computed in TF32, takes the
program's place in each of its outputs: the violation and the objective
it reports for a plan are worked out in TF32 (read by ``viol_gap`` and
``obj_gap``), and the plan's states are rolled out from its inputs in
TF32 (read by ``feas_viol`` and ``feas_stat``).
"""

from __future__ import annotations

import numpy as np

from . import kkt, obca, worlds


def plan_checks(cfg, hz, world, xref, plan, acceptable_viol_tol, infeas_share, limits,
                control=None, stat_sample=None, device="cpu"):
    """The numbers of free-time plans ``plan`` (x, u, T, lam, mu, viol, f,
    feas; B plans) solved toward the reference windows ``xref`` (B, 3,
    N+1) under the configuration's horizon block ``hz`` (its
    ``objective``), each ``(name, value, limit)``. ``stat_sample`` (an
    index array, default all) picks the plans ``feas_stat`` reads among
    those called feasible; ``device`` runs it."""
    m = cfg["model"]
    obs = worlds.obstacles(world, *worlds.shape_of(world))
    d = obca.free_time_data(obs, xref, {**m, "x_lo": world["x_lo"], "x_hi": world["x_hi"]})
    ob = hz["objective"]
    z = {k: np.asarray(plan[k], np.float64) for k in ("x", "u", "T", "lam", "mu")}
    viol_rep = np.asarray(plan["viol"], np.float64)
    f_rep = np.asarray(plan["f"], np.float64)
    if control == "tf32":
        viol_rep = obca.violation(z, d, rnd=obca.round_tf32)
        f_rep = obca.objective(z, d, ob, rnd=obca.round_tf32)
    viol = obca.violation(z, d)
    f = obca.objective(z, d, ob)
    gap = float(np.max(np.abs(viol_rep - viol) / np.maximum(1.0, viol)))
    fgap = float(np.max(np.abs(f_rep - f) / np.maximum(1.0, np.abs(f))))
    if control == "tf32":
        z["x"] = obca.rollout(d["x0"], z["u"], z["T"] * m["Ts"], rnd=obca.round_tf32)
        viol = obca.violation(z, d)
    feas = np.asarray(plan["feas"], bool)
    lim = limits
    fv = float(viol[feas].max()) if feas.any() else 0.0
    rows = np.arange(len(feas)) if stat_sample is None else np.asarray(stat_sample)
    rows = rows[feas[rows]]
    st = 0.0
    if rows.size:
        dd = {**d, **{k: d[k][rows] for k in obca.LANE_KEYS}}
        st = float(kkt.stationarity(dd, {k: v[rows] for k, v in z.items()}, ob,
                                    device=device).max())
    out = [("viol_gap", gap, lim["viol_gap"]),
           ("obj_gap", fgap, lim["obj_gap"]),
           ("feas_viol", fv, acceptable_viol_tol + lim["viol_gap"]),
           ("feas_stat", st, lim["feas_stat"])]
    if "max_infeasible_share" in lim:
        out.append(("infeas_share", float(infeas_share), lim["max_infeasible_share"]))
    return out
