"""Dry-run sweep driver: every live (arch x shape) cell on both meshes
(port of ``repro.launch.sweep``).

Each cell runs ``python -m repro_torch.launch.dryrun`` in a fresh
subprocess, so that a cell's fake world and its failures stay its own;
cells whose record exists are skipped, so the sweep resumes where it
stopped.

    python -m repro_torch.launch.sweep [--out build/dryrun] [--timeout S]
        [--meshes single,multi] [--shapes prefill_32k,decode_32k]
        [--archs mamba2-780m,recurrentgemma-2b] [--jobs N]

``--shapes`` keeps the cells of those shapes and ``--archs`` those of
those architectures; ``--jobs`` runs that many cells at once (each its
own process), in the order they are listed, each cell on every mesh
before the next.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def run_one(arch: str, shape: str, mesh: str, out_dir: str,
            timeout: int) -> tuple[str, list, float]:
    """One cell in its own process: (status, the output's last lines,
    seconds)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out_dir]
    if mesh == "multi":
        cmd.append("--multi-pod")
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
        out = r.stdout + r.stderr
        tail = out.strip().splitlines()[-3:]
        fname_path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
        status = "ok" if r.returncode == 0 and (
            any(ln.startswith("OK") for ln in out.splitlines())
            and os.path.exists(fname_path)) else "FAIL"
    except subprocess.TimeoutExpired:
        tail, status = ["timeout"], "TIMEOUT"
    return status, tail, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--archs", default=None)
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import live_cells

    cells = live_cells()
    if args.shapes:
        keep = args.shapes.split(",")
        cells = [(a, s) for a, s in cells if s in keep]
    if args.archs:
        keep = args.archs.split(",")
        cells = [(a, s) for a, s in cells if a in keep]
    meshes = args.meshes.split(",")
    todo = []
    for arch, shape in cells:
        for mesh in meshes:
            fname = f"{arch}__{shape}__{mesh}.json"
            if os.path.exists(os.path.join(args.out, fname)):
                continue
            todo.append((arch, shape, mesh))
    print(f"{len(todo)} cells to run ({len(cells)} live x {meshes})",
          flush=True)

    def one(i_cell):
        i, (arch, shape, mesh) = i_cell
        status, tail, dt = run_one(arch, shape, mesh, args.out,
                                   args.timeout)
        lines = [f"[{i+1}/{len(todo)}] {status} {arch} {shape} {mesh} "
                 f"({dt:.0f}s)"]
        if status != "ok":
            lines += ["    " + ln[:200] for ln in tail]
        print("\n".join(lines), flush=True)

    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        list(pool.map(one, enumerate(todo)))


if __name__ == "__main__":
    main()
