"""Structured multi-start for the OBCA solves.

PyTorch counterpart of the JAX package's ``runtime/multistart.py``: solve
the same problem from a small set of structured initial trajectories in
one batch and keep the best feasible result:

  * the reference window itself (collision-free wrt static obstacles),
  * the previous open-loop plan shifted by one step,
  * a brake trajectory (stay at x0),
  * dodge-below / dodge-above variants that push the window out of the
    predicted union of sensed dynamic obstacles.

The JAX package vmaps one problem's candidates; here the B problems and
their nC candidates are flattened into ONE solver batch of B * nC lanes,
candidate-minor (lane ``b * nC + c``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..solver.ipm import IPMState


def candidate_inits(xref, x0, dyn_boxes=None, y_bounds=None, prev_plan=None,
                    clearance=0.85):
    """Host (numpy) list of (3, N+1) initial state trajectories for one
    problem, first column == x0 (the JAX package's ``candidate_inits``).

    Args:
      xref: (3, N+1) reference window; x0: (3,) current state.
      dyn_boxes: optional (N+1, 4) [xmin, ymin, xmax, ymax] of the union of
        sensed dynamic obstacles per horizon step (None -> no dodges).
      y_bounds: (lo, hi) drivable y band for dodge clipping.
      prev_plan: optional (3, N+1) previous open-loop plan.
    """
    xref = np.asarray(xref, float)
    x0 = np.asarray(x0, float)
    N = xref.shape[1] - 1
    out = []

    def with_theta(xy):
        dx = np.diff(xy[0])
        dy = np.diff(xy[1])
        th = np.arctan2(dy, dx)
        # keep the previous heading across zero-length segments
        for i in range(len(th)):
            if dx[i] == 0 and dy[i] == 0:
                th[i] = th[i - 1] if i > 0 else x0[2]
        th = np.concatenate([th, th[-1:]])
        tr = np.vstack([xy, th[None]])
        tr[:, 0] = x0
        return tr

    base = xref.copy()
    base[:, 0] = x0
    out.append(base)

    if prev_plan is not None:
        p = np.asarray(prev_plan, float)
        shifted = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        shifted[:, 0] = x0
        out.append(shifted)

    brake = np.tile(x0[:, None], (1, N + 1))
    out.append(brake)

    if dyn_boxes is not None:
        boxes = np.asarray(dyn_boxes, float)
        for mode in ("below", "above"):
            xy = xref[:2].copy()
            for k in range(N + 1):
                xmin, ymin, xmax, ymax = boxes[k]
                if xmin - 3.0 <= xy[0, k] <= xmax + 3.0:
                    if mode == "below":
                        xy[1, k] = min(xy[1, k], ymin - clearance)
                    else:
                        xy[1, k] = max(xy[1, k], ymax + clearance)
            if y_bounds is not None:
                xy[1] = np.clip(xy[1], y_bounds[0] + clearance,
                                y_bounds[1] - clearance)
            out.append(with_theta(xy))

    return out


def dodge_boxes(info, pos, vel, Ts, sensed, N):
    """(B, N+1, 4) boxes ``[x_lo, y_lo, x_hi, y_hi]`` around the sensed
    obstacles' predicted rectangles over the horizon, +-inf rows where
    none is sensed (``bench.py:350-367``): ``info`` (nD, 11) or (B, nD,
    11) obstacle rows, ``pos`` (B, nD, 2) their positions now, ``vel``
    (nD, 2) or (B, nD, 2), ``Ts`` (B,), ``sensed`` (B, nD) bool."""
    th = info[..., 2]
    ex = (torch.abs(info[..., 3] / 2 * torch.cos(th))
          + torch.abs(info[..., 4] / 2 * torch.sin(th))).unsqueeze(-2)
    ey = (torch.abs(info[..., 3] / 2 * torch.sin(th))
          + torch.abs(info[..., 4] / 2 * torch.cos(th))).unsqueeze(-2)
    ks = torch.arange(N + 1, dtype=pos.dtype, device=pos.device)
    centers = (pos[:, None] + ks[None, :, None, None] * Ts[:, None, None, None]
               * vel.unsqueeze(-3))                              # (B, N+1, nD, 2)
    inf = torch.full((), float("inf"), dtype=pos.dtype, device=pos.device)
    sm = sensed[:, None, :]
    return torch.stack([
        torch.where(sm, centers[..., 0] - ex, inf).amin(2),
        torch.where(sm, centers[..., 1] - ey, inf).amin(2),
        torch.where(sm, centers[..., 0] + ex, -inf).amax(2),
        torch.where(sm, centers[..., 1] + ey, -inf).amax(2)], dim=-1)


def candidate_inits_traced(xref, x0, dyn_boxes=None, y_bounds=None,
                           prev_plan=None, clearance=0.85):
    """Batched candidates (B, nC, 3, N+1): window, shifted previous plan
    (the window again when ``prev_plan`` is None), brake, and with
    ``dyn_boxes`` (B, N+1, 4) (+-inf rows where nothing is sensed) the
    dodge-below / dodge-above windows clipped to ``y_bounds = (lo (B,),
    hi (B,))``. nC = 3 without dodges, 5 with."""
    N = xref.shape[2] - 1
    B = xref.shape[0]

    def with_theta(xy):
        dx = torch.diff(xy[:, 0], dim=-1)
        dy = torch.diff(xy[:, 1], dim=-1)
        deg = (dx == 0) & (dy == 0)
        th_raw = torch.atan2(dy, dx)
        prev = x0[:, 2].to(th_raw.dtype)
        th = []
        for i in range(N):     # keep the previous heading across zero steps
            prev = torch.where(deg[:, i], prev, th_raw[:, i])
            th.append(prev)
        th = torch.stack(th + th[-1:], dim=1)
        tr = torch.cat([xy, th[:, None]], dim=1)
        tr[:, :, 0] = x0
        return tr

    base = xref.clone()
    base[:, :, 0] = x0
    if prev_plan is None:
        prev_plan = base
    shifted = torch.cat([prev_plan[:, :, 1:], prev_plan[:, :, -1:]], dim=2)
    shifted[:, :, 0] = x0
    brake = x0[:, :, None].expand(B, 3, N + 1)
    cands = [base, shifted, brake]

    if dyn_boxes is not None:
        bx = dyn_boxes
        in_x = (xref[:, 0] >= bx[..., 0] - 3.0) & (xref[:, 0] <= bx[..., 2] + 3.0)
        have = in_x & torch.isfinite(bx[..., 1])
        lo = (y_bounds[0] + clearance)[:, None]
        hi = (y_bounds[1] - clearance)[:, None]
        y_below = torch.where(have, torch.minimum(xref[:, 1], bx[..., 1] - clearance),
                              xref[:, 1])
        y_above = torch.where(have, torch.maximum(xref[:, 1], bx[..., 3] + clearance),
                              xref[:, 1])
        for yy in (y_below, y_above):
            yc = torch.minimum(torch.maximum(yy, lo), hi)
            cands.append(with_theta(torch.stack([xref[:, 0], yc], dim=1)))
    return torch.stack(cands, dim=1)


def _take(nt, idx):
    """Rows ``idx`` of every tensor (and dict of tensors) of a NamedTuple."""
    return type(nt)(*[{k: v[idx] for k, v in f.items()} if isinstance(f, dict)
                      else f[idx] for f in nt])


def make_multistart_solver(spec, solve, init_vars_fn, n_candidates,
                           warm_cands=(0, 1)):
    """Wrap a batched solver into an n-candidate multi-start.

    Returns ``msolve(data, x_inits (B, nC, 3, N+1), skip=None, warm=None,
    z_override=None) -> (picked IPMResult (B, ...), best (B,))``:

      * ``skip`` (B,) bool: a skipped problem's lanes start ``done``, run
        no iteration (they are left out of the batch the solver iterates)
        and report ``feas=False`` — the gate of the ladder's later rungs;
      * ``warm=(lam, mu[, valid])``: (B, n_k, nO, E) / (B, n_k, nO, 4)
        duals that start the candidates in ``warm_cands`` (where ``valid``
        (B,) holds); the others keep the geometric ``init_duals``;
      * ``z_override``: a dict of (B, ...) variables that candidate 0
        starts from (a sibling solve's full iterate, e.g. mpc6's for the
        mpc8 polish).

    The pick: feasible first, then the lowest objective, else the lowest
    ``1e18 + viol``; the first candidate on ties. After each call
    ``msolve.last`` holds ``{"rows": problems iterated, "iters": host-loop
    iterations}`` of that call (0 and 0 when every row was skipped).
    """
    warm_mask = np.zeros(n_candidates, bool)
    warm_mask[[c for c in warm_cands if c < n_candidates]] = True
    nC = n_candidates

    def msolve(data, x_inits, skip=None, warm=None, z_override=None):
        B = x_inits.shape[0]
        dev = x_inits.device
        rep = lambda t: t.repeat_interleave(nC, dim=0)
        data_l = type(data)(*[rep(f) for f in data])
        x_l = x_inits.reshape((B * nC,) + x_inits.shape[2:])
        z0 = init_vars_fn(spec, data_l, x_init=x_l)
        if warm is not None:
            uw = torch.as_tensor(warm_mask, device=dev).repeat(B)
            if len(warm) > 2:
                uw = uw & rep(warm[2])
            z0w = init_vars_fn(spec, data_l, x_init=x_l, lam_init=rep(warm[0]),
                               mu_init=rep(warm[1]))
            sel = uw[:, None, None, None]
            z0 = {**z0, "lam": torch.where(sel, z0w["lam"], z0["lam"]),
                  "mu": torch.where(sel, z0w["mu"], z0["mu"])}
        if z_override is not None:
            is_c0 = torch.zeros(B * nC, dtype=torch.bool, device=dev)
            is_c0[::nC] = True
            z0 = dict(z0)
            for k, v in z_override.items():
                m = is_c0.view((-1,) + (1,) * (z0[k].dim() - 1))
                z0[k] = torch.where(m, rep(v).to(z0[k].dtype), z0[k])
        if skip is None:
            skip = torch.zeros(B, dtype=torch.bool, device=dev)
        st = solve.init(data_l, z0)
        st = st._replace(done=st.done | rep(skip))
        run = torch.nonzero(~st.done).flatten()
        msolve.last = {"rows": run.numel() // nC, "iters": 0}
        if run.numel():
            sub = solve.iterate(_take(st, run), _take(data_l, run), 10 ** 9)
            msolve.last["iters"] = int(sub.it.max())
            fields = []
            for full, part in zip(st, sub):
                full = full.clone()
                full[run] = part
                fields.append(full)
            st = IPMState(*fields)
        res = solve.finalize(st, data_l)

        big = torch.full_like(res.f, 1e18)
        score = torch.where(res.feas, res.f, big + res.viol).reshape(B, nC)
        best = torch.argmin(score, dim=1)
        picked = _take(res, torch.arange(B, device=dev) * nC + best)
        return picked._replace(feas=picked.feas & ~skip), best

    msolve.last = {"rows": 0, "iters": 0}
    return msolve


__all__ = ["candidate_inits", "candidate_inits_traced", "make_multistart_solver"]
