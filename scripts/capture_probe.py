"""Which library calls of the AD solver's Newton step a CUDA graph can
capture, on the card: torch.linalg.cholesky_ex, torch.cholesky_solve, two
torch.linalg.solve_triangular, a batched matmul, torch.func's vmap of
jacrev / grad / an HVP (jvp over grad), index_add_ and linalg.qr, each
captured after one eager call and replayed; prints one JSON line a call
(captured, with its replay ms on the host clock, or the error). A
batched cholesky_solve runs MAGMA's potrs_batched, which allocates inside
the call and invalidates the capture; two solve_triangular calls capture,
so solver/ad.py's Cholesky solves are written that way and every family
runs the graphed loop.

    python3 scripts/capture_probe.py          # on a machine with a GPU
"""

import json
import subprocess
import sys
import time


def try_capture(name, fn):
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            fn()
        g.replay()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            g.replay()
        torch.cuda.synchronize()
        row = {"name": name, "captured": True, "replay_ms": (time.perf_counter() - t0) / 5 * 1e3}
    except RuntimeError as e:
        torch.cuda.synchronize()
        row = {"name": name, "captured": False, "err": str(e)[:300]}
    print(json.dumps(row), flush=True)


def main():
    import torch
    from torch.func import grad, jacrev, jvp, vmap

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(torch.__version__, torch.version.cuda, torch.backends.cuda.preferred_linalg_library())
    dev = torch.device("cuda")
    for dt in (torch.float64, torch.float32):
        for B, n in ((512, 534), (32, 690)):
            A = torch.randn(B, n, n, dtype=dt, device=dev)
            A = A @ A.transpose(1, 2) + n * torch.eye(n, dtype=dt, device=dev)
            b = torch.randn(B, n, 1, dtype=dt, device=dev)

            def chol():
                L, info = torch.linalg.cholesky_ex(A, check_errors=False)
                return torch.where((info != 0)[:, None, None], float("nan"), L)

            L = chol()
            tag = f"{dt} {B}x{n}"
            try_capture(f"cholesky_ex {tag}", chol)
            try_capture(f"cholesky_solve {tag}", lambda: torch.cholesky_solve(b, L))
            try_capture(f"solve_triangular x2 {tag}", lambda: torch.linalg.solve_triangular(
                L.transpose(-1, -2), torch.linalg.solve_triangular(L, b, upper=False), upper=True))
            try_capture(f"matmul {tag}", lambda: A @ b)
            del A, L
            torch.cuda.empty_cache()
    n, m = 534, 156
    W = torch.randn(m, n, dtype=torch.float64, device=dev)
    Z = torch.randn(256, n, dtype=torch.float64, device=dev)
    P = torch.ones(256, dtype=torch.float64, device=dev)
    probes = torch.randn(18, n, dtype=torch.float64, device=dev)
    cfun = lambda z, p: torch.sin(W @ z) * p
    ffun = lambda z, p: (torch.cos(z) * z).sum() * p

    def hv(z, p):
        return vmap(lambda v: jvp(lambda z_: grad(ffun)(z_, p), (z,), (v,))[1])(probes)

    try_capture("vmap jacrev", lambda: vmap(jacrev(cfun))(Z, P))
    try_capture("vmap hvp", lambda: vmap(hv)(Z, P))
    try_capture("vmap grad", lambda: vmap(grad(ffun))(Z, P))
    idx = torch.randint(0, n, (1000,), device=dev)
    try_capture("index_add", lambda: torch.zeros(256, n, dtype=torch.float64, device=dev)
                .index_add_(1, idx, torch.ones(256, 1000, dtype=torch.float64, device=dev)))
    try_capture("qr", lambda: torch.linalg.qr(
        torch.randn(16, 300, 300, device=dev, dtype=torch.float64)))


if __name__ == "__main__":
    sys.exit(main())
