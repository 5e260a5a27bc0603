"""The OBCA model's constraints worked out again, in numpy float64.

For a free-time plan ``z`` (x (B, 3, N+1), u (B, 2, N), T (B,), lam (B,
N, nO, E), mu (B, N, nO, 4)) and the problem's data, made here from the
world and the start (obstacles from ``worlds.obstacles``, never from the
program), :func:`violation` gives each lane's largest unscaled violation
of the NLP's constraints, as the reference repository's model states
them (``src/obca.py``; the port's ``models/obca.py`` writes the same):
unicycle dynamics (forward Euler, dt = T Ts), the start, the terminal
equality, the OBCA dual conditions for each static obstacle at steps 1..N
(norm and distance rows, stationarity), the state, input and time-scale
bounds and the acceleration limits. A plan with a small violation has a
dual certificate that its ego box keeps ``dmin`` from every obstacle.

``rnd`` rounds after each operation: the lower-precision control passes
a TF32 rounding (:func:`round_tf32`).
"""

from __future__ import annotations

import numpy as np


def round_tf32(a):
    """Round to TF32 (float32's exponent, a 10-bit mantissa), to nearest."""
    f = np.asarray(a, np.float32)
    i = f.view(np.uint32).astype(np.uint64)
    i = ((i + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return i.view(np.float32).astype(np.float64)


LANE_KEYS = ("x0", "xref", "xref_N", "u0", "T_lo", "T_max")   # free_time_data's per-lane rows


def free_time_data(obs, xref, p):
    """The problem data the checks need, per lane (B lanes), from the
    reference windows ``xref`` (B, 3, N+1) (column 0 the start, column N
    the terminal state): obstacles static (free time leaves dynamic
    obstacles out), the bounds of ``build_obca_data`` (time scale up to the
    signed coordinate-sum distance over N v_max Ts, plus one)."""
    xref = np.asarray(xref, np.float64)
    B, N = xref.shape[0], xref.shape[2] - 1
    x0, xref_N = xref[:, :, 0], xref[:, :, N]
    obs_mask = obs["static_mask"]
    dis = (xref_N[:, 0] - x0[:, 0]) + (xref_N[:, 1] - x0[:, 1])
    return {"x0": x0, "xref": xref, "xref_N": xref_N, "u0": np.zeros((B, 2)), "N": N,
            "A": obs["A"], "b": obs["b"], "lam_mask": obs["edge_mask"] * obs_mask[:, None],
            "obs_mask": obs_mask, "x_lo": np.asarray(p["x_lo"], float),
            "x_hi": np.asarray(p["x_hi"], float), "Ts": p["Ts"], "v_max": p["v_max"],
            "w_max": p["w_max"], "a_max": p["a_max"], "alpha_max": p["alpha_max"],
            "ego": p["ego"], "dmin": p["dmin"],
            "T_lo": np.full(B, 1e-4), "T_max": dis / (N * p["v_max"] * p["Ts"]) + 1.0}


def objective(z, d, ob, rnd=None):
    """(B,) the stated objective (``kkt``'s docstring writes it; weights
    ``ob``, the configuration's ``objective``) of each lane's plan."""
    r = rnd or (lambda a: a)
    x, u, T, lam, mu = (np.asarray(z[k], np.float64) for k in ("x", "u", "T", "lam", "mu"))
    if rnd is not None:
        x, u, T, lam, mu = map(r, (x, u, T, lam, mu))
    N = d["N"]
    sq = lambda a: r(a * a).reshape(a.shape[0], -1).sum(1)
    dt = r(T * d["Ts"])[:, None, None]
    dx = r(x[:, :, :N] - d["xref"][:, :, :N])
    dN = r(x[:, :, N] - d["xref_N"])
    du = np.concatenate([r(u[:, :, :1] - d["u0"][:, :, None]), r(u[:, :, 1:] - u[:, :, :-1])], 2)
    lm = d["lam_mask"][None, None]
    om = d["obs_mask"][None, None, :, None]
    pad = sq(r((1.0 - lm) * lam)) + sq(r((1.0 - om) * mu))
    real = sq(r(lm * lam)) + sq(r(om * mu))
    return (ob["q"] * sq(dx) + ob["r1"] * sq(u) + ob["r2"] * sq(r(du / dt)) + ob["p"] * sq(dN)
            + (N + 1) * (ob["time_c1"] * T + ob["time_c2"] * r(T * T))
            + 0.5 * ob["pad_pin"] * pad + 0.5 * ob["dual_prox"] * real)


def violation(z, d, rnd=None):
    """(B,) largest violation of each lane's constraints at ``z``."""
    r = rnd or (lambda a: a)
    x, u, T, lam, mu = (np.asarray(z[k], np.float64) for k in ("x", "u", "T", "lam", "mu"))
    if rnd is not None:
        x, u, T, lam, mu = map(r, (x, u, T, lam, mu))
    N = d["N"]
    dt = r(T * d["Ts"])[:, None]
    th = x[:, 2, :N]
    v, w = u[:, 0], u[:, 1]
    dyn = np.stack([
        r(r(x[:, 0, 1:] - x[:, 0, :N]) - r(dt * r(v * r(np.cos(th))))),
        r(r(x[:, 1, 1:] - x[:, 1, :N]) - r(dt * r(v * r(np.sin(th))))),
        r(r(x[:, 2, 1:] - x[:, 2, :N]) - r(dt * w))], axis=1)
    init = r(x[:, :, 0] - d["x0"])
    term = r(x[:, :, N] - d["xref_N"])
    A, b = d["A"], d["b"]                                     # (nO, E, 2), (nO, E)
    q1 = r(np.einsum("ied,bkie->bkid", A, lam))               # (B, N, nO, 2)
    blam = r(np.einsum("ie,bkie->bki", b, lam))
    m = d["obs_mask"][None, None, :]
    thk = x[:, 2, 1:]
    cth, sth = r(np.cos(thk))[..., None], r(np.sin(thk))[..., None]
    g1 = r(r(mu[..., 0] - mu[..., 2]) + m * r(r(cth * q1[..., 0]) + r(sth * q1[..., 1])))
    g2 = r(r(mu[..., 1] - mu[..., 3]) + m * r(r(-sth * q1[..., 0]) + r(cth * q1[..., 1])))
    B = x.shape[0]
    eq = np.concatenate([a.reshape(B, -1) for a in (dyn, init, term, g1, g2)], axis=1)

    lm = d["lam_mask"][None, None]
    mm = d["obs_mask"][None, None, :, None]
    ineq = [np.where(lm > 0, lam, 1.0), np.where(mm > 0, mu, 1.0)]
    for i in range(2):
        ineq += [r(x[:, i] - d["x_lo"][i]), r(d["x_hi"][i] - x[:, i])]
    umax = np.array([d["v_max"], d["w_max"]])
    for i in range(2):
        ineq += [r(u[:, i] + umax[i]), r(umax[i] - u[:, i])]
    ineq += [r(T - d["T_lo"])[:, None], r(d["T_max"] - T)[:, None]]
    du = np.concatenate([r(d["u0"][:, :, None] - u[:, :, :1]), r(u[:, :, :-1] - u[:, :, 1:])], 2)
    a_dt, al_dt = r(d["a_max"] * dt), r(d["alpha_max"] * dt)
    ineq += [r(a_dt - du[:, 0]), r(du[:, 0] + a_dt), r(al_dt - du[:, 1]), r(du[:, 1] + al_dt)]
    norm = np.where(m > 0, r(1.0 - r(r(q1[..., 0] ** 2) + r(q1[..., 1] ** 2))), 1.0)
    e = d["ego"]
    L, W = e[0] + e[2], e[1] + e[3]
    g = np.array([L / 2, W / 2, L / 2, W / 2])
    off = (e[0] + e[2]) / 2 - e[2]
    gmu = r(np.einsum("g,bkig->bki", g, mu))
    tx = r(x[:, 0, 1:] + r(r(np.cos(thk)) * off))[..., None]
    ty = r(x[:, 1, 1:] + r(r(np.sin(thk)) * off))[..., None]
    dist = r(r(r(-gmu + r(tx * q1[..., 0])) + r(ty * q1[..., 1])) - blam)
    ineq += [norm, np.where(m > 0, r(dist - d["dmin"]), 1.0)]
    ci = np.concatenate([a.reshape(B, -1) for a in ineq], axis=1)
    return np.maximum(np.abs(eq).max(1), np.maximum(-ci.min(1), 0.0))


def rollout(x0, u, dt, rnd=None):
    """(B, 3, N+1) states of the unicycle from ``x0`` (B, 3) under ``u``
    (B, 2, N) with step ``dt`` (B,), forward Euler, each operation
    rounded by ``rnd``."""
    r = rnd or (lambda a: a)
    N = u.shape[2]
    xs = [r(np.asarray(x0, np.float64))]
    dt = r(np.asarray(dt, np.float64))
    for k in range(N):
        p = xs[-1]
        v, w = r(u[:, 0, k]), r(u[:, 1, k])
        xs.append(np.stack([r(p[:, 0] + r(dt * r(v * r(np.cos(p[:, 2]))))),
                            r(p[:, 1] + r(dt * r(v * r(np.sin(p[:, 2]))))),
                            r(p[:, 2] + r(dt * w))], axis=1))
    return np.stack(xs, axis=2)
