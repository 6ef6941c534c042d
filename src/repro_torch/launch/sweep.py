"""Dry-run sweep driver: every live (arch x shape) cell on both meshes
(port of ``repro.launch.sweep``).

Each cell runs ``python -m repro_torch.launch.dryrun`` in a fresh
subprocess, so that a cell's fake world and its failures stay its own;
cells whose record exists are skipped, so the sweep resumes where it
stopped.

    python -m repro_torch.launch.sweep [--out build/dryrun] [--timeout S]
        [--meshes single,multi]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--meshes", default="single,multi")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import live_cells

    cells = live_cells()
    meshes = args.meshes.split(",")
    todo = []
    for mesh in meshes:
        for arch, shape in cells:
            fname = f"{arch}__{shape}__{mesh}.json"
            if os.path.exists(os.path.join(args.out, fname)):
                continue
            todo.append((arch, shape, mesh))
    print(f"{len(todo)} cells to run ({len(cells)} live x {meshes})",
          flush=True)

    for i, (arch, shape, mesh) in enumerate(todo):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", args.out]
        if mesh == "multi":
            cmd.append("--multi-pod")
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            out = r.stdout + r.stderr
            tail = out.strip().splitlines()[-3:]
            fname_path = os.path.join(args.out,
                                      f"{arch}__{shape}__{mesh}.json")
            status = "ok" if r.returncode == 0 and (
                any(ln.startswith("OK") for ln in out.splitlines())
                and os.path.exists(fname_path)) else "FAIL"
        except subprocess.TimeoutExpired:
            tail, status = ["timeout"], "TIMEOUT"
        dt = time.time() - t0
        print(f"[{i+1}/{len(todo)}] {status} {arch} {shape} {mesh} "
              f"({dt:.0f}s)", flush=True)
        if status != "ok":
            for ln in tail:
                print("   ", ln[:200], flush=True)


if __name__ == "__main__":
    main()
