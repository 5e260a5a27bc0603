"""The OBCA optimal-control NLP as batched residual functions on tensors.

PyTorch counterpart of the JAX package's ``models/obca.py`` (the
reference's CasADi builders, ``src/obca.py:828-1758``). Every function
takes a leading lane dimension B: ``OBCAData`` fields are ``(B, ...)``
and the variable dict ``z`` holds

    x (B, 3, N+1)   u (B, 2, N)   lam (B, n_k, nO, E)   mu (B, n_k, nO, 4)
    T (B,)          (free-time variant only)

The flat variable order is the JAX package's ``ravel_pytree`` order,
which sorts the dict keys: ``[T, lam, mu, u, x]``. Torch keeps insertion
order, so :func:`ravel_z` sorts explicitly; every static index map
(:func:`ineq_identity_layout`, :func:`arrow_layout`, the solver's
layouts) depends on it.

Masking scheme (one problem shape serves every demo): inactive obstacle /
padded edge duals are pulled to zero by a quadratic penalty, their
stationarity rows degrade to ``mu0 - mu2 = 0`` / ``mu1 - mu3 = 0`` and
their inequality rows become the constant ``1 >= 0``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OBCASpec:
    """Static problem shape.

    Variants (reference solver methods):
      'free'         — time-optimal, terminal equality (obca_mpc4)
      'fix_terminal' — fixed Ts, terminal set (obca_mpc6)
      'fix_free_end' — fixed Ts, no terminal (obca_mpc8 fallback)
      'fix_eq_band'  — fixed Ts, terminal position equality + heading
                       band |theta_N - thetaref_N| <= theta_band
    Orthogonal switches:
      coupled_motion — obstacle translation over the horizon computed
                       in-graph as k * Ts * T * vel (free time only).
      obca_k0        — impose the OBCA block at k = 0 too (the reference
                       loops k = 0..N); default False, the k = 0 pose is
                       pinned by the initial equality.
      dual_reg       — proximal weight selecting the minimum-norm
                       contact multiplier ("relaxed OBCA").
    """

    N: int
    n_obs: int
    e_max: int
    variant: str  # 'free' | 'fix_terminal' | 'fix_free_end' | 'fix_eq_band'
    nx: int = 3
    nu: int = 2
    dual_reg: float = 1e-6
    coupled_motion: bool = False
    theta_band: float = 0.7853981633974483  # pi/4, src/obca.py:224-225
    obca_k0: bool = False

    def __post_init__(self):
        if self.variant not in ("free", "fix_terminal", "fix_free_end",
                                "fix_eq_band"):
            raise ValueError(f"unknown OBCA variant {self.variant!r}")
        if self.coupled_motion and self.variant != "free":
            raise ValueError("coupled motion needs free time")

    @property
    def free_time(self):
        return self.variant == "free"

    @property
    def k_lo(self):
        """First horizon step carrying OBCA duals/constraints."""
        return 0 if self.obca_k0 else 1

    @property
    def n_k(self):
        """Number of horizon steps carrying OBCA duals/constraints."""
        return self.N + 1 - self.k_lo


class OBCAData(NamedTuple):
    """Per-problem data, one row per lane."""

    x0: torch.Tensor          # (B, 3)
    u0: torch.Tensor          # (B, 2) previous applied input (accel anchor)
    xref: torch.Tensor        # (B, 3, N+1)
    A: torch.Tensor           # (B, N+1, nO, E, 2) hyperplane normals per step
    b: torch.Tensor           # (B, N+1, nO, E)
    edge_mask: torch.Tensor   # (B, nO, E)
    obs_mask: torch.Tensor    # (B, nO)
    x_lo: torch.Tensor        # (B, 2)
    x_hi: torch.Tensor        # (B, 2)
    u_lo: torch.Tensor        # (B, 2)
    u_hi: torch.Tensor        # (B, 2)
    Q: torch.Tensor           # (B, 3, 3)
    R1: torch.Tensor          # (B, 2, 2)
    R2: torch.Tensor          # (B, 2, 2)
    P: torch.Tensor           # (B, 3, 3)
    Ts: torch.Tensor          # (B,)
    dmin: torch.Tensor        # (B,)
    ego_g: torch.Tensor       # (B, 4) [L/2, W/2, L/2, W/2]
    ego_offset: torch.Tensor  # (B,)
    terminal_set: torch.Tensor  # (B, 2, 2) rows x/y, cols lo/hi
    T_max: torch.Tensor       # (B,) free-time upper bound on the time scale
    a_max: torch.Tensor       # (B,)
    alpha_max: torch.Tensor   # (B,)
    time_c1: torch.Tensor     # (B,)
    time_c2: torch.Tensor     # (B,)
    T_lo: torch.Tensor        # (B,) free-time lower bound
    obs_vel: torch.Tensor     # (B, nO, 2) used only under coupled_motion


_PIN_RHO = 1.0  # curvature of the padded-dual zero penalty


def z_keys(spec: OBCASpec):
    """The variable names in flat order (sorted, as ``ravel_pytree``)."""
    return (["T"] if spec.free_time else []) + ["lam", "mu", "u", "x"]


def ravel_z(spec: OBCASpec, z) -> torch.Tensor:
    """Variable dict -> (B, n) flat tensor in sorted-key order."""
    B = z["x"].shape[0]
    return torch.cat([z[k].reshape(B, -1) for k in z_keys(spec)], dim=1)


def unravel_z(spec: OBCASpec, zf: torch.Tensor):
    """(B, n) flat tensor -> variable dict (views into ``zf``)."""
    N, nO, E, nk = spec.N, spec.n_obs, spec.e_max, spec.n_k
    shapes = {"T": (), "lam": (nk, nO, E), "mu": (nk, nO, 4),
              "u": (2, N), "x": (3, N + 1)}
    B = zf.shape[0]
    out, off = {}, 0
    for k in z_keys(spec):
        cnt = int(np.prod(shapes[k])) if shapes[k] else 1
        piece = zf[:, off:off + cnt]
        out[k] = piece.reshape((B,) + shapes[k]) if shapes[k] else piece[:, 0]
        off += cnt
    return out


def _clip(v, lo, hi):
    """jnp.clip semantics: min(max(v, lo), hi)."""
    return torch.minimum(torch.maximum(v, lo), hi)


def init_vars(spec: OBCASpec, data: OBCAData, x_init=None, warm_duals=True,
              lam_init=None, mu_init=None):
    """Initial variables for a solve: states on the reference window
    (column 0 forced to x0), the time scale at its reachability estimate,
    inputs at the implied velocities and the OBCA duals at their analytic
    geometric values (:func:`init_duals`).

    Args:
      x_init: optional (B, 3, N+1) state guess, taken as given (the
        multistart candidates carry x0 in column 0).
      warm_duals: False starts the OBCA duals at zero.
      lam_init/mu_init: optional (B, n_k, nO, E) / (B, n_k, nO, 4) dual
        starts overriding both, masked to the real edges and obstacles.
    """
    if x_init is None:
        x = data.xref.clone()
        x[:, :, 0] = data.x0
    else:
        x = torch.as_tensor(x_init, dtype=data.x0.dtype, device=data.x0.device)

    gaps = torch.sqrt(torch.sum(torch.diff(x[:, :2], dim=-1) ** 2, dim=1)
                      + 1e-12)                                   # (B, N)
    if spec.free_time:
        # steps of length v_max*T*Ts must cover the largest inter-knot gap
        v_cap = 0.9 * data.u_hi[:, 0]
        T0 = _clip(gaps.amax(-1) / (v_cap * data.Ts),
                   torch.ones_like(v_cap), data.T_max)
        dt = T0 * data.Ts
    else:
        T0 = None
        dt = data.Ts

    v0 = _clip(gaps / dt[:, None], data.u_lo[:, :1], data.u_hi[:, :1])
    w0 = _clip(torch.diff(x[:, 2], dim=-1) / dt[:, None],
               data.u_lo[:, 1:], data.u_hi[:, 1:])
    u = torch.stack([v0, w0], dim=1)
    if lam_init is not None:
        dt_ = data.x0.dtype
        lam = (torch.as_tensor(lam_init, dtype=dt_, device=x.device)
               * (data.edge_mask * data.obs_mask[..., None])[:, None])
        mu = (torch.as_tensor(mu_init, dtype=dt_, device=x.device)
              * data.obs_mask[:, None, :, None])
    elif warm_duals:
        lam, mu = init_duals(spec, data, x)
    else:
        B = x.shape[0]
        lam = x.new_zeros((B, spec.n_k, spec.n_obs, spec.e_max))
        mu = x.new_zeros((B, spec.n_k, spec.n_obs, 4))

    z = {"x": x, "u": u, "lam": lam, "mu": mu}
    if spec.free_time:
        z["T"] = T0
    return z


def init_duals(spec: OBCASpec, data: OBCAData, x):
    """Analytic dual warm start: per (k, obstacle) all lambda weight
    kappa/||A_j|| on the most separating hyperplane (first index on ties,
    as ``jnp.argmax``), mu >= 0 from the stationarity rows via
    positive/negative parts. Returns ``lam (B, n_k, nO, E)``,
    ``mu (B, n_k, nO, 4)``."""
    kappa = 0.9
    kl = spec.k_lo
    x = x[:, :, kl:]
    A = data.A[:, kl:]
    b = data.b[:, kl:]
    lam_mask = data.edge_mask * data.obs_mask[..., None]        # (B, nO, E)
    off = data.ego_offset[:, None]
    tx = x[:, 0] + torch.cos(x[:, 2]) * off                     # (B, n_k)
    ty = x[:, 1] + torch.sin(x[:, 2]) * off
    t = torch.stack([tx, ty], dim=-1)                           # (B, n_k, 2)
    At_b = torch.einsum("bkied,bkd->bkie", A, t) - b
    norms = torch.sqrt(torch.sum(A * A, dim=-1))                # (B, n_k, nO, E)
    nrm = torch.clamp(norms, min=1e-9)
    score = torch.where(lam_mask[:, None] > 0, At_b / nrm,
                        torch.full_like(At_b, float("-inf")))
    best = torch.argmax(score, dim=-1)
    onehot = torch.nn.functional.one_hot(best, spec.e_max).to(x.dtype)
    lam = onehot * kappa / nrm * lam_mask[:, None]
    q1 = torch.einsum("bkied,bkie->bkid", A, lam)
    c = torch.cos(x[:, 2])[..., None]
    s = torch.sin(x[:, 2])[..., None]
    p = -(c * q1[..., 0] + s * q1[..., 1])
    q = -(-s * q1[..., 0] + c * q1[..., 1])
    relu = torch.relu
    mu = (torch.stack([relu(p), relu(q), relu(-p), relu(-q)], dim=-1)
          * data.obs_mask[:, None, :, None])
    return lam, mu


def _dt(spec, data, z):
    return z["T"] * data.Ts if spec.free_time else data.Ts


def _obca_terms(spec, data, z):
    """Per-(k, i) ``q1 = A^T lam`` (B, n_k, nO, 2) and ``b^T lam``
    (B, n_k, nO); under ``coupled_motion`` the offsets move with the
    optimized time scale: b_k = b + A (k * Ts * T * vel)."""
    lam = z["lam"]
    kl = spec.k_lo
    A = data.A[:, kl:]
    b = data.b[:, kl:]
    if spec.coupled_motion:
        ks = torch.arange(kl, spec.N + 1, dtype=b.dtype, device=b.device)
        delta = (ks[None, :, None, None] * (data.Ts * z["T"])[:, None, None, None]
                 * data.obs_vel[:, None])                    # (B, n_k, nO, 2)
        b = b + torch.einsum("bkied,bkid->bkie", A, delta)
    q1 = torch.einsum("bkied,bkie->bkid", A, lam)
    blam = torch.einsum("bkie,bkie->bki", b, lam)
    return q1, blam


def objective(spec: OBCASpec, data: OBCAData, z) -> torch.Tensor:
    """(B,) objective: tracking, input, acceleration, terminal and time
    costs plus the padded-dual pin and the dual proximal term."""
    x, u = z["x"], z["u"]
    N = spec.N
    dx = x[:, :, :N] - data.xref[:, :, :N]
    cost_x = torch.einsum("bit,bij,bjt->b", dx, data.Q, dx)
    cost_u = torch.einsum("bit,bij,bjt->b", u, data.R1, u)
    dt = _dt(spec, data, z)
    du = torch.cat([u[:, :, :1] - data.u0[:, :, None],
                    torch.diff(u, dim=-1)], dim=-1)
    dudt = du / dt[:, None, None]
    cost_acc = torch.einsum("bit,bij,bjt->b", dudt, data.R2, dudt)
    dN = x[:, :, N] - data.xref[:, :, N]
    cost_term = torch.einsum("bi,bij,bj->b", dN, data.P, dN)
    total = cost_x + cost_u + cost_acc + cost_term
    if spec.free_time:
        T = z["T"]
        total = total + (N + 1) * (data.time_c1 * T + data.time_c2 * T ** 2)
    lam_mask = (data.edge_mask * data.obs_mask[..., None])[:, None]
    obs_mask = data.obs_mask[:, None, :, None]
    pin = (torch.sum(((1.0 - lam_mask) * z["lam"]) ** 2, dim=(1, 2, 3))
           + torch.sum(((1.0 - obs_mask) * z["mu"]) ** 2, dim=(1, 2, 3)))
    prox = (torch.sum((lam_mask * z["lam"]) ** 2, dim=(1, 2, 3))
            + torch.sum((obs_mask * z["mu"]) ** 2, dim=(1, 2, 3)))
    return total + 0.5 * _PIN_RHO * pin + 0.5 * spec.dual_reg * prox


def eq_constraints(spec: OBCASpec, data: OBCAData, z) -> torch.Tensor:
    """(B, mE) stacked equality residuals (== 0)."""
    x, u = z["x"], z["u"]
    N = spec.N
    B = x.shape[0]
    dt = _dt(spec, data, z)[:, None]
    th = x[:, 2, :N]
    dyn = torch.stack([
        x[:, 0, 1:] - x[:, 0, :N] - dt * u[:, 0] * torch.cos(th),
        x[:, 1, 1:] - x[:, 1, :N] - dt * u[:, 0] * torch.sin(th),
        x[:, 2, 1:] - x[:, 2, :N] - dt * u[:, 1],
    ], dim=1)                                                  # (B, 3, N)
    parts = [dyn.reshape(B, -1), x[:, :, 0] - data.x0]
    if spec.variant == "free":
        parts.append(x[:, :, N] - data.xref[:, :, N])
    elif spec.variant == "fix_eq_band":
        parts.append(x[:, :2, N] - data.xref[:, :2, N])
    q1, _ = _obca_terms(spec, data, z)
    mu = z["mu"]
    cth = torch.cos(x[:, 2, spec.k_lo:])[..., None]
    sth = torch.sin(x[:, 2, spec.k_lo:])[..., None]
    m = data.obs_mask[:, None, :]
    g1 = (mu[..., 0] - mu[..., 2]) + m * (cth * q1[..., 0] + sth * q1[..., 1])
    g2 = (mu[..., 1] - mu[..., 3]) + m * (-sth * q1[..., 0] + cth * q1[..., 1])
    parts += [g1.reshape(B, -1), g2.reshape(B, -1)]
    return torch.cat(parts, dim=1)


def ineq_identity_layout(spec: OBCASpec):
    """Flat-z indices of the identity (bound) inequality rows
    ``sgn * z_flat[idx] + off >= 0``, in row order: lam, mu, x/y box
    (lower then upper per coordinate), u box, T box (free)."""
    N, nO, E = spec.N, spec.n_obs, spec.e_max
    sizes = {}
    off = 0
    for key, shape in (
        [("T", ())] if spec.free_time else []
    ) + [("lam", (spec.n_k, nO, E)), ("mu", (spec.n_k, nO, 4)),
         ("u", (2, N)), ("x", (3, N + 1))]:
        cnt = int(np.prod(shape)) if shape else 1
        sizes[key] = (off, shape)
        off += cnt

    def idx_of(key, *coords):
        base, shape = sizes[key]
        if not shape:
            return base
        return base + int(np.ravel_multi_index(coords, shape))

    rows = []
    rows.extend(range(sizes["lam"][0], sizes["lam"][0] + spec.n_k * nO * E))
    rows.extend(range(sizes["mu"][0], sizes["mu"][0] + spec.n_k * nO * 4))
    for i in range(2):
        lo = [idx_of("x", i, t) for t in range(N + 1)]
        rows.extend(lo)
        rows.extend(lo)
    for i in range(2):
        lo = [idx_of("u", i, t) for t in range(N)]
        rows.extend(lo)
        rows.extend(lo)
    if spec.free_time:
        rows.extend([idx_of("T"), idx_of("T")])
    return np.asarray(rows, dtype=np.int64)


def arrow_layout(spec: OBCASpec):
    """(K, E+4) flat-z indices of the per-(k, obstacle) dual blocks
    {lam[k, i, :], mu[k, i, :]} — the KKT system's block-arrow
    structure (no term couples two blocks)."""
    nO, E = spec.n_obs, spec.e_max
    base_lam = 1 if spec.free_time else 0
    base_mu = base_lam + spec.n_k * nO * E
    K = spec.n_k * nO
    blk = np.arange(K)
    lam_idx = base_lam + blk[:, None] * E + np.arange(E)[None, :]
    mu_idx = base_mu + blk[:, None] * 4 + np.arange(4)[None, :]
    return np.concatenate([lam_idx, mu_idx], axis=1).astype(np.int64)


def hessian_spine_probes(spec: OBCASpec):
    """Grouped (star-colored) HVP probes of the spine block of the
    Lagrangian Hessian and the static maps that reassemble the arrow
    pieces from the probe outputs (the JAX package's function of the same
    name, as numpy arrays equal to its own).

    Distinct horizon steps couple in the spine Hessian only through the
    R2 acceleration band (distance 1 in t) and the dense T row/column, so
    one probe sums all x_t (all y_t, all theta_t), three probes per input
    slot take v_t (w_t) by t mod 3, and T is a singleton probe.

    Returns a dict:
      probes:   (C, n) float64 spine probe matrix,
      scatter:  (M, 4) int64 (dest_row_pos, dest_col_pos, probe, src_flat):
                Hpp[r, c] = HV[probe][src_flat],
      pq_pos:   (S, K) int64 spine position adjacent to each dual block
                per slot group (x, y, theta[, T]),
      pq_group: (S,) int64 probe recovering that Hpq slice,
      p_idx:    (np,) int64 the spine layout these maps assume.
    """
    N, nO, E = spec.N, spec.n_obs, spec.e_max
    free = spec.free_time
    base_lam = 1 if free else 0
    base_mu = base_lam + spec.n_k * nO * E
    base_u = base_mu + spec.n_k * nO * 4
    base_x = base_u + 2 * N
    n = base_x + 3 * (N + 1)

    def u_flat(i, t):
        return base_u + i * N + t

    def x_flat(i, t):
        return base_x + i * (N + 1) + t

    p_list = ([0] if free else []) + list(range(base_u, n))
    pos = {f: i for i, f in enumerate(p_list)}
    groups, g_of = [], {}

    def new_group(cols):
        for c in cols:
            g_of[c] = len(groups)
        groups.append(cols)

    for i in range(3):                      # x, y, theta
        new_group([x_flat(i, t) for t in range(N + 1)])
    for i in range(2):                      # v, w: 3 colors each (R2 band)
        for m in range(3):
            new_group([u_flat(i, t) for t in range(N) if t % 3 == m])
    if free:
        new_group([0])                      # T: singleton, full row/col

    probes = np.zeros((len(groups), n))
    for g, cols in enumerate(groups):
        probes[g, cols] = 1.0

    quads = []

    def add(a, b):
        """Spine nonzero H[a, b] read from b's probe at row a, mirrored."""
        quads.append((pos[a], pos[b], g_of[b], a))
        quads.append((pos[b], pos[a], g_of[b], a))

    for t in range(N + 1):
        xs = [x_flat(i, t) for i in range(3)]
        for i in range(3):                  # Q/P same-step clique
            for j in range(i, 3):
                add(xs[i], xs[j])
        if t < N:
            add(xs[2], u_flat(0, t))        # dynamics (theta_t, v_t)
    for t in range(N):                      # R1/R2: same step + band
        for i in range(2):
            for j in range(2):
                if j >= i:
                    add(u_flat(i, t), u_flat(j, t))
                if t + 1 < N:
                    add(u_flat(i, t), u_flat(j, t + 1))
    if free:
        gT = g_of[0]
        for p in p_list:                    # T row/col, (T, T) included
            quads.append((pos[p], pos[0], gT, p))
            if p != 0:
                quads.append((pos[0], pos[p], gT, p))

    K = spec.n_k * nO
    ks = spec.k_lo + np.arange(K) // nO     # block -> horizon step
    pq_pos = [[pos[x_flat(i, k)] for k in ks] for i in range(3)]
    pq_group = [0, 1, 2]
    if free:
        pq_pos.append([pos[0]] * K)         # coupled motion's (T, lam)
        pq_group.append(g_of[0])
    return {
        "probes": probes,
        "scatter": np.asarray(quads, dtype=np.int64),
        "pq_pos": np.asarray(pq_pos, dtype=np.int64),
        "pq_group": np.asarray(pq_group, dtype=np.int64),
        "p_idx": np.asarray(p_list, dtype=np.int64),
    }


def ineq_identity_sgn_off(spec: OBCASpec, data: OBCAData):
    """(sgn, off), each (B, m_id), for the identity inequality rows in
    :func:`ineq_identity_layout` order. Masked dual rows get sgn = 0,
    off = 1 (the constant ``1 >= 0`` row)."""
    N = spec.N
    B = data.x0.shape[0]
    lam_m = (data.edge_mask * data.obs_mask[..., None])[:, None].expand(
        B, spec.n_k, spec.n_obs, spec.e_max).reshape(B, -1)
    mu_m = data.obs_mask[:, None, :, None].expand(
        B, spec.n_k, spec.n_obs, 4).reshape(B, -1)
    sgns = [lam_m, mu_m]
    offs = [1.0 - lam_m, 1.0 - mu_m]
    for i in range(2):
        np1 = data.x0.new_ones((B, N + 1))
        sgns += [np1, -np1]
        offs += [-data.x_lo[:, i:i + 1] * np1, data.x_hi[:, i:i + 1] * np1]
    for i in range(2):
        nn = data.x0.new_ones((B, N))
        sgns += [nn, -nn]
        offs += [-data.u_lo[:, i:i + 1] * nn, data.u_hi[:, i:i + 1] * nn]
    if spec.free_time:
        one = data.x0.new_ones((B, 1))
        sgns.append(torch.cat([one, -one], dim=1))
        offs.append(torch.stack([-data.T_lo, data.T_max], dim=1))
    return torch.cat(sgns, dim=1), torch.cat(offs, dim=1)


def ineq_constraints_dense(spec: OBCASpec, data: OBCAData, z) -> torch.Tensor:
    """(B, mD) non-bound inequality rows (>= 0): acceleration limits,
    terminal set / heading band, OBCA norm and distance conditions."""
    x, u = z["x"], z["u"]
    N = spec.N
    B = x.shape[0]
    obs_mask = data.obs_mask
    one = torch.ones((), dtype=x.dtype, device=x.device)
    dt = _dt(spec, data, z)
    du = torch.cat([data.u0[:, :, None] - u[:, :, :1],
                    u[:, :, :-1] - u[:, :, 1:]], dim=-1)
    a_dt = (data.a_max * dt)[:, None]
    al_dt = (data.alpha_max * dt)[:, None]
    parts = [a_dt - du[:, 0], du[:, 0] + a_dt, al_dt - du[:, 1], du[:, 1] + al_dt]
    if spec.variant == "fix_terminal":
        ts = data.terminal_set
        parts.append(torch.stack([x[:, 0, N] - ts[:, 0, 0],
                                  x[:, 1, N] - ts[:, 1, 0],
                                  ts[:, 1, 1] - x[:, 1, N]], dim=1))
    elif spec.variant == "fix_eq_band":
        dth = x[:, 2, N] - data.xref[:, 2, N]
        parts.append(torch.stack([spec.theta_band - dth,
                                  dth + spec.theta_band], dim=1))
    q1, blam = _obca_terms(spec, data, z)
    m = obs_mask[:, None, :]
    norm_row = torch.where(m > 0, 1.0 - torch.sum(q1 * q1, dim=-1), one)
    parts.append(norm_row.reshape(B, -1))
    gmu = torch.einsum("bg,bkig->bki", data.ego_g, z["mu"])
    kl = spec.k_lo
    off = data.ego_offset[:, None]
    tx = x[:, 0, kl:] + torch.cos(x[:, 2, kl:]) * off
    ty = x[:, 1, kl:] + torch.sin(x[:, 2, kl:]) * off
    dist = -gmu + tx[..., None] * q1[..., 0] + ty[..., None] * q1[..., 1] - blam
    dist_row = torch.where(m > 0, dist - data.dmin[:, None, None], one)
    parts.append(dist_row.reshape(B, -1))
    return torch.cat(parts, dim=1)


_IDENTITY_INDEX = {}


def _identity_index(spec: OBCASpec, device):
    """:func:`ineq_identity_layout` on ``device``, uploaded once (a
    captured solve may not copy from the host)."""
    key = (spec, str(device))
    if key not in _IDENTITY_INDEX:
        _IDENTITY_INDEX[key] = torch.as_tensor(ineq_identity_layout(spec), device=device)
    return _IDENTITY_INDEX[key]


def ineq_constraints(spec: OBCASpec, data: OBCAData, z) -> torch.Tensor:
    """(B, mI) inequality residuals (>= 0): identity rows first, then the
    dense rows."""
    zf = ravel_z(spec, z)
    idx = _identity_index(spec, zf.device)
    sgn, off = ineq_identity_sgn_off(spec, data)
    return torch.cat([sgn * zf[:, idx] + off,
                      ineq_constraints_dense(spec, data, z)], dim=1)


def signed_clearance(spec: OBCASpec, data: OBCAData, z) -> torch.Tensor:
    """(B, n_k, nO) per-(k, i) OBCA distance value (>= dmin when
    separated), for diagnostics and property tests."""
    q1, blam = _obca_terms(spec, data, z)
    kl = spec.k_lo
    x = z["x"][:, :, kl:]
    gmu = torch.einsum("bg,bkig->bki", data.ego_g, z["mu"])
    off = data.ego_offset[:, None]
    tx = x[:, 0] + torch.cos(x[:, 2]) * off
    ty = x[:, 1] + torch.sin(x[:, 2]) * off
    return -gmu + tx[..., None] * q1[..., 0] + ty[..., None] * q1[..., 1] - blam
