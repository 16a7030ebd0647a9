#!/usr/bin/env python3
"""Wall seconds of each kernel's ``nvcc``, all started together as
``build.build_all`` starts them, under two sets of flags.

    python3 scripts/kernel_build_times.py [VARIANT ...]

``as_built``: each source with the flags ``kernels/build.py`` gives it
(``--split-compile=0`` for the sources of ``SPLIT_COMPILE``); ``unsplit``:
every source with ``NVCC_FLAGS`` alone; ``all_split``: every source with
``--split-compile=0``.  Each variant compiles into a fresh temporary
directory, so nothing is cached.  One JSON line a variant: each source's
seconds from the start and exit code, and the first ptxas register
counts of each library.  Given variant names, only those run.  Needs the
CUDA toolkit (``nvcc``), no device.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(build, flags_of) -> dict:
    out_dir = tempfile.mkdtemp()
    procs, t0 = {}, time.perf_counter()
    for name in build.KERNELS:
        cmd = [build._nvcc(), *flags_of(name), "-o",
               os.path.join(out_dir, f"{name}.so"),
               str(build.CSRC / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    done = {}
    while len(done) < len(procs):
        for name, proc in procs.items():
            if name not in done and proc.poll() is not None:
                done[name] = [time.perf_counter() - t0, proc.returncode]
        time.sleep(0.1)
    regs = {}
    for name, proc in procs.items():
        log = proc.stdout.read()
        regs[name] = [line.split("Used")[1].split(",")[0].strip()
                      for line in log.splitlines() if "Used" in line][:6]
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"seconds_and_rc": done, "registers": regs}


def main() -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    variants = {
        "as_built": build._flags,
        "unsplit": lambda name: build.NVCC_FLAGS,
        "all_split": lambda name: build.NVCC_FLAGS + ["--split-compile=0"],
    }
    for tag, flags_of in variants.items():
        if sys.argv[1:] and tag not in sys.argv[1:]:
            continue
        print(json.dumps({"variant": tag, **run(build, flags_of)}),
              flush=True)


if __name__ == "__main__":
    main()
