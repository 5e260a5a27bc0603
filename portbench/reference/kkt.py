"""First-order optimality of free-time plans, worked out again in plain
PyTorch float64.

The OBCA NLP of a free-time plan (``obca.violation`` writes its
constraints) has the objective the configuration states
(``configs/<name>.json`` ``objective``):

    sum_{k<N} q |x_k - xref_k|^2 + r1 |u|^2 + r2 sum_k |du_k / dt|^2
    + p |x_N - xref_N|^2 + (N + 1)(c1 T + c2 T^2)
    + pad_pin / 2 |padded duals|^2 + dual_prox / 2 |real duals|^2

(du_0 = u_0 - u0, dt = T Ts). For each plan, :func:`stationarity`
builds the objective's gradient g and the Jacobian A = [J_E; J_I] of the
equality and inequality rows (``>= 0``) at the plan by automatic
differentiation, and takes its own multipliers: the least-squares fit

    min |g - J_E^T y - J_I^T w|^2 + |c_I * w|^2,   then w >= 0

(the complementarity term keeps multipliers off rows that are not
active; rows whose multiplier comes out negative are dropped and the fit
made again, a few times). Its number is Ipopt's scaled optimality error
at mu = 0 with those multipliers: max(|g - J^T (y, w)|_inf / s_d,
|c_I * w|_inf / s_c), s_d and s_c from the multipliers' mean size over
``s_max`` (Ipopt's 100). A plan is a KKT point of the stated NLP when it
is small; it does not depend on how the program scales its problem or
orders its rows. Nothing of the program is read but the plan itself.
"""

from __future__ import annotations

import numpy as np

S_MAX = 100.0
PASSES = 4
CHUNK_BYTES = 2 ** 31    # Jacobians and normal matrices of one block of lanes


def _lane_functions(d, w):
    """``(f, cons, mE)``: a lane's objective and its stacked rows
    ``[equalities; inequalities]`` as functions of its flat variables
    ``zf = [x (3(N+1)), u (2N), T, lam (N nO E), mu (N nO 4)]`` and its own
    data ``(x0, xref, T_max)``."""
    import torch

    N = d["N"]
    A = torch.as_tensor(d["A"], dtype=torch.float64)
    dev = w["device"]
    A, b = A.to(dev), torch.as_tensor(d["b"], dtype=torch.float64, device=dev)
    lm = torch.as_tensor(d["lam_mask"], dtype=torch.float64, device=dev)
    om = torch.as_tensor(d["obs_mask"], dtype=torch.float64, device=dev)
    nO, E = b.shape
    x_lo = torch.as_tensor(d["x_lo"], dtype=torch.float64, device=dev)
    x_hi = torch.as_tensor(d["x_hi"], dtype=torch.float64, device=dev)
    umax = torch.tensor([d["v_max"], d["w_max"]], dtype=torch.float64, device=dev)
    e = d["ego"]
    L, W = e[0] + e[2], e[1] + e[3]
    g_ego = torch.tensor([L / 2, W / 2, L / 2, W / 2], dtype=torch.float64, device=dev)
    off = (e[0] + e[2]) / 2 - e[2]
    Ts, T_lo = d["Ts"], float(d["T_lo"][0])
    ob = w["objective"]
    sizes = (3 * (N + 1), 2 * N, 1, N * nO * E, N * nO * 4)

    def split(zf):
        x, u, T, lam, mu = torch.split(zf, sizes)
        return (x.reshape(3, N + 1), u.reshape(2, N), T[0], lam.reshape(N, nO, E),
                mu.reshape(N, nO, 4))

    def f(zf, x0, xref, T_max):
        x, u, T, lam, mu = split(zf)
        dt = T * Ts
        dx = x[:, :N] - xref[:, :N]
        du = torch.cat([u[:, :1] - d["u0_lane"], u[:, 1:] - u[:, :-1]], dim=1) / dt
        dN = x[:, N] - xref[:, N]
        pad = ((1.0 - lm) * lam).square().sum() + ((1.0 - om)[:, None] * mu).square().sum()
        real = (lm * lam).square().sum() + (om[:, None] * mu).square().sum()
        return (ob["q"] * dx.square().sum() + ob["r1"] * u.square().sum()
                + ob["r2"] * du.square().sum() + ob["p"] * dN.square().sum()
                + (N + 1) * (ob["time_c1"] * T + ob["time_c2"] * T * T)
                + 0.5 * ob["pad_pin"] * pad + 0.5 * ob["dual_prox"] * real)

    def cons(zf, x0, xref, T_max):
        x, u, T, lam, mu = split(zf)
        dt = T * Ts
        th = x[2, :N]
        dyn = torch.stack([x[0, 1:] - x[0, :N] - dt * u[0] * torch.cos(th),
                           x[1, 1:] - x[1, :N] - dt * u[0] * torch.sin(th),
                           x[2, 1:] - x[2, :N] - dt * u[1]])
        q1 = torch.einsum("ied,kie->kid", A, lam)
        blam = torch.einsum("ie,kie->ki", b, lam)
        thk = x[2, 1:]
        c, s = torch.cos(thk)[:, None], torch.sin(thk)[:, None]
        g1 = (mu[..., 0] - mu[..., 2]) + om * (c * q1[..., 0] + s * q1[..., 1])
        g2 = (mu[..., 1] - mu[..., 3]) + om * (-s * q1[..., 0] + c * q1[..., 1])
        eq = [dyn.reshape(-1), x[:, 0] - x0, x[:, N] - xref[:, N], g1.reshape(-1),
              g2.reshape(-1)]
        one = torch.ones((), dtype=zf.dtype, device=zf.device)
        ineq = [torch.where(lm > 0, lam, one).reshape(-1),
                torch.where(om[:, None] > 0, mu, one).reshape(-1)]
        for i in range(2):
            ineq += [x[i] - x_lo[i], x_hi[i] - x[i]]
        for i in range(2):
            ineq += [u[i] + umax[i], umax[i] - u[i]]
        ineq += [(T - T_lo)[None], (T_max - T)[None]]
        du = torch.cat([d["u0_lane"] - u[:, :1], u[:, :-1] - u[:, 1:]], dim=1)
        a_dt, al_dt = d["a_max"] * dt, d["alpha_max"] * dt
        ineq += [a_dt - du[0], du[0] + a_dt, al_dt - du[1], du[1] + al_dt]
        norm = torch.where(om > 0, 1.0 - q1.square().sum(-1), one)
        gmu = torch.einsum("g,kig->ki", g_ego, mu)
        tx = (x[0, 1:] + torch.cos(thk) * off)[:, None]
        ty = (x[1, 1:] + torch.sin(thk) * off)[:, None]
        dist = -gmu + tx * q1[..., 0] + ty * q1[..., 1] - blam
        ineq += [norm.reshape(-1), torch.where(om > 0, dist - d["dmin"], one).reshape(-1)]
        return torch.cat(eq + ineq)

    mE = 3 * N + 6 + 2 * N * nO
    return f, cons, mE


def flat(z):
    """(B, n) float64 flat variables of plans ``z`` (x, u, T, lam, mu)."""
    B = np.asarray(z["x"]).shape[0]
    return np.concatenate([np.asarray(z[k], np.float64).reshape(B, -1)
                           for k in ("x", "u", "T", "lam", "mu")], axis=1)


def stationarity(d, z, objective, device="cpu"):
    """(B,) Ipopt's scaled optimality error at mu = 0 of each plan of ``z``
    (the free-time variables of B lanes) under data ``d``
    (``obca.free_time_data``) and the stated ``objective`` weights, with
    the multipliers fitted here; in blocks of lanes of about
    ``CHUNK_BYTES``."""
    import torch

    dev = torch.device(device)
    zf_all = flat(z)
    B = zf_all.shape[0]
    out = np.zeros(B)
    d = dict(d)
    d["u0_lane"] = torch.zeros((2, 1), dtype=torch.float64, device=dev)
    f, cons, mE = _lane_functions(d, {"objective": objective, "device": dev})
    grad = torch.func.vmap(torch.func.grad(f))
    jac = torch.func.vmap(torch.func.jacfwd(cons))
    cval = torch.func.vmap(cons)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    n = zf_all.shape[1]
    m = int(cval(t(zf_all[:1]), t(d["x0"][:1]), t(d["xref"][:1]), t(d["T_max"][:1])).shape[1])
    chunk = max(1, int(CHUNK_BYTES // (8 * (m * n + 3 * m * m))))
    for lo in range(0, B, chunk):
        sl = slice(lo, min(lo + chunk, B))
        args = (t(zf_all[sl]), t(d["x0"][sl]), t(d["xref"][sl]), t(d["T_max"][sl]))
        with torch.no_grad():
            g = grad(*args)
            J = jac(*args)                         # (b, m, n)
            c = cval(*args)
        out[sl] = _fit(g, J, c, mE).cpu().numpy()
    return out


def _fit(g, J, c, mE):
    """Scaled optimality error of each lane with its least-squares
    multipliers (see the module's docstring)."""
    import torch

    b, m, n = J.shape
    cI = c[:, mE:]
    keep = torch.ones((b, m - mE), dtype=torch.bool, device=J.device)
    M0 = J @ J.transpose(1, 2)
    rhs = (J @ g[..., None])[..., 0]
    eye = torch.eye(m, dtype=J.dtype, device=J.device)
    eps = 1e-12 * (1.0 + M0.diagonal(dim1=1, dim2=2).amax(1))
    for _ in range(PASSES):
        pen = torch.where(keep, cI.square(), torch.full_like(cI, 1e12))
        dd = torch.cat([torch.zeros((b, mE), dtype=J.dtype, device=J.device), pen], 1)
        M = M0 + torch.diag_embed(dd) + eps[:, None, None] * eye
        C, _ = torch.linalg.cholesky_ex(M)
        lam = torch.cholesky_solve(rhs[..., None], C)[..., 0]
        wI = lam[:, mE:]
        neg = keep & (wI < 0)
        if not bool(neg.any()):
            break
        keep = keep & ~neg
    lam = torch.cat([lam[:, :mE], torch.where(keep, wI.clamp(min=0.0), torch.zeros_like(wI))], 1)
    wI = lam[:, mE:]
    r = g - (J.transpose(1, 2) @ lam[..., None])[..., 0]
    sd = torch.clamp(lam.abs().sum(1) / m, min=S_MAX) / S_MAX
    sc = torch.clamp(wI.abs().sum(1) / (m - mE), min=S_MAX) / S_MAX
    return torch.maximum(r.abs().amax(1) / sd, (cI * wI).abs().amax(1) / sc)
