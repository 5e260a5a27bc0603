"""What the device loop (kernels/csrc/device_loop.cu) needs from the card's
CUDA stack, and whether the Newton body goes under a WHILE node: the
versions (PyTorch's CUDA, nvcc, the driver, the library's runtime), a toy
loop (a counter to 5, and a call with the flag 0 at the start, which must
run no iteration), and the node types of the fused solver's captured
Newton body at the fix shape, then that body under a WHILE node for three
iterations. Prints one JSON line a check.

    python3 scripts/device_loop_probe.py      # on a machine with a GPU
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def out(**row):
    print(json.dumps(row), flush=True)


def capture(fn, pool, stream):
    import torch

    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(stream):
        g.capture_begin(pool=pool)
        try:
            res = fn()
        finally:
            g.capture_end()
    return g, res


def toy(start_flag):
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels

    dev = torch.device("cuda:0")
    x = torch.zeros(1, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    count = torch.full((1,), -7, dtype=torch.int32, device=dev)
    s, pool = torch.cuda.Stream(), torch.cuda.graph_pool_handle()

    def pre():
        x.zero_()
        flag.fill_(start_flag)

    def body():
        x.add_(1.0)
        flag.copy_((x < 5).to(torch.int32))

    gp, _ = capture(pre, pool, s)
    gb, _ = capture(body, pool, s)
    gq, y = capture(lambda: x * 2, pool, s)
    ex = kernels.device_loop_build(gp.raw_cuda_graph(), gb.raw_cuda_graph(), gq.raw_cuda_graph(),
                                   flag, count)
    kernels.device_loop_launch(ex, dev)
    torch.cuda.synchronize()
    res = {"x": float(x), "y": float(y), "count": int(count)}
    kernels.device_loop_launch(ex, dev)   # a second launch of the same exec
    torch.cuda.synchronize()
    res["count_again"] = int(count)
    kernels.device_loop_destroy(ex)
    return res


def fused_body():
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        fix_fixture_batch)

    dev = torch.device("cuda:0")
    s6, _, data, cands = fix_fixture_batch(dtype=torch.float32, device=dev)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        ENTRY_OPTIONS)
    solve = make_obca_solver(s6, ENTRY_OPTIONS)
    st0 = solve.init(data)
    st = type(st0)(*[t.clone() for t in st0])
    solve.step(st, data)   # eager once: the kernels' per-shape caches
    torch.cuda.synchronize()
    left = torch.full((1,), 3, dtype=torch.int32, device=dev)
    flag = torch.ones(1, dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    s, pool = torch.cuda.Stream(), torch.cuda.graph_pool_handle()

    def body():
        new = solve.step(st, data)
        for o, n in zip(st, new):
            o.copy_(n)
        left.sub_(1)
        flag.copy_((left > 0).to(torch.int32))

    gb, _ = capture(body, pool, s)
    types = kernels.graph_node_types(gb.raw_cuda_graph())
    ex = kernels.device_loop_build(None, gb.raw_cuda_graph(), None, flag, count)
    kernels.device_loop_launch(ex, dev)
    torch.cuda.synchronize()
    it = int(st.it.max())
    kernels.device_loop_destroy(ex)
    return {"lanes": int(data.x0.shape[0]), "body_node_types": types, "count": int(count),
            "it_after": it, "finite": bool(torch.isfinite(st.zv).all())}


def main():
    import torch

    sh = lambda c: subprocess.run(c, shell=True, capture_output=True, text=True).stdout.strip()
    out(check="versions", torch=torch.__version__, torch_cuda=torch.version.cuda,
        nvcc=sh("nvcc --version | tail -2"),
        smi=sh("nvidia-smi --query-gpu=name,power.limit,driver_version --format=csv,noheader"))
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.kernels import build

    build.build_all()
    out(check="library", **kernels.device_loop_versions())
    for name, fn in (("toy flag 1", lambda: toy(1)), ("toy flag 0", lambda: toy(0)),
                     ("fused body", fused_body)):
        try:
            out(check=name, ok=True, **fn())
        except Exception as e:   # report and go on to the next check
            out(check=name, ok=False, error=f"{type(e).__name__}: {e}")


if __name__ == "__main__":
    main()
