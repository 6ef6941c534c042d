"""Compare the machine code (SASS) of two builds of a kernel library.

    python -m repro_torch.kernels.compare_sass OLD.so NEW.so \\
        --extra plane_kernel="3, false" --extra product_kernel=false

Each kernel of OLD is held against its counterpart in NEW: the NEW
instantiation whose template arguments are OLD's followed by the
``--extra`` arguments given for that kernel (template parameters NEW
added, at the values meant to reproduce OLD's code; a kernel without
``--extra`` keeps its name).  Instructions and their encodings are
compared, not the listing's column padding.  Equal SASS means equal speed
on equal inputs, whatever a timing between two processes shows.  Prints each
kernel that differs and the counts, and exits 1 if any differs or has no
counterpart.  Needs ``cuobjdump`` (the CUDA toolkit) and ``c++filt``;
``_build.build`` leaves each tree's library under its ``build/repro_torch/``.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

_NAME = re.compile(r"(\w+)(<[^()]*>)?\(")


def _cuobjdump() -> str:
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda, "bin", "cuobjdump")
    return path if os.path.exists(path) else "cuobjdump"


def kernels(lib: str) -> dict[str, str]:
    """``{kernel<template arguments>: SASS text}`` of every function in
    ``lib``."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", out)
    names = subprocess.run(["c++filt"], input="\n".join(parts[1::2]),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    found = {}
    for name, body in zip(names, parts[2::2]):
        m = _NAME.search(name)
        found[m.group(1) + (m.group(2) or "") if m else name] = \
            _instructions(body)
    return found


def _instructions(body: str) -> str:
    """A function's SASS with each line's runs of whitespace collapsed:
    ``cuobjdump`` pads its columns to the longest instruction of the whole
    listing, so adding a kernel with longer instructions moves every other
    kernel's columns without changing an instruction or its encoding."""
    return "\n".join(" ".join(line.split()) for line in body.splitlines())


def counterpart(name: str, extra: dict[str, str]) -> str:
    """The NEW name of OLD kernel ``name``."""
    kernel, _, args = name.partition("<")
    if kernel not in extra:
        return name
    if not args:
        return f"{kernel}<{extra[kernel]}>"
    return f"{kernel}<{args[:-1]}, {extra[kernel]}>"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--extra", action="append", default=[],
                    metavar="KERNEL=ARGS",
                    help="template arguments NEW's KERNEL adds at the end")
    args = ap.parse_args(argv)
    extra = dict(e.split("=", 1) for e in args.extra)
    old, new = kernels(args.old), kernels(args.new)
    same = differ = missing = 0
    for name, body in sorted(old.items()):
        twin = counterpart(name, extra)
        if twin not in new:
            missing += 1
            print(f"no counterpart: {name} (looked for {twin})")
        elif new[twin] == body:
            same += 1
        else:
            differ += 1
            a, b = body.splitlines(), new[twin].splitlines()
            n = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            print(f"differs: {name} vs {twin} ({len(a)} / {len(b)} lines, "
                  f"{n} differ)")
    print(f"{len(old)} kernels in {args.old}, {len(new)} in {args.new}: "
          f"{same} identical, {differ} different, {missing} without a "
          f"counterpart")
    return 0 if differ == missing == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
