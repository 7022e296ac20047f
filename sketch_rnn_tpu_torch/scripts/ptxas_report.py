"""Registers and spills of every kernel of the port's CUDA sources.

Builds each named source under ``sketch_rnn_tpu_torch/csrc/`` with the
flags of ``ops/_build.py`` plus ``-Xptxas -v`` (into a temporary file,
not the kernel cache) and prints one JSON line per kernel instantiation:
its demangled name (``c++filt``, where present), registers, stack frame
and spill stores and loads in bytes. A last line sums the spills by
source. Exits 1 when any kernel spills or a build fails. Needs nvcc::

    python -m sketch_rnn_tpu_torch.scripts.ptxas_report [probe_ln ...] \\
        [--match ln_lstm]
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from sketch_rnn_tpu_torch.ops import _build

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PROPS = re.compile(r"Function properties for (\w+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def parse(log: str):
    """``[{kernel, registers, stack, spill_stores, spill_loads}, ...]`` of
    one ``ptxas -v`` log (kernels only: device functions have no
    registers line of their own)."""
    out, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        m = _PROPS.search(line)
        if m and cur is not None and m.group(1) != cur["kernel"]:
            cur = None      # a device function's frame, not the kernel's
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def demangle(names):
    tool = shutil.which("c++filt")
    if tool is None:
        return list(names)
    proc = subprocess.run([tool], input="\n".join(names), text=True,
                          capture_output=True)
    got = proc.stdout.splitlines()
    return got if len(got) == len(names) else list(names)


def build(name: str):
    """``(returncode, log)`` of one source built with ``-Xptxas -v``."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", f"{tmp}/{name}.so", str(_build.CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc.returncode, proc.stdout + proc.stderr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", default=list(_build.SIGNATURES))
    ap.add_argument("--match", default="",
                    help="print only the kernels whose name holds this")
    args = ap.parse_args(argv)
    with ThreadPoolExecutor(len(args.sources)) as pool:
        logs = dict(zip(args.sources, pool.map(build, args.sources)))
    ok = True
    for name, (rc, log) in logs.items():
        if rc:
            print(json.dumps({"source": name, "build_failed": rc,
                              "log": log[-4000:]}), flush=True)
            ok = False
            continue
        kernels = parse(log)
        total = 0
        for k, pretty in zip(kernels, demangle([k["kernel"]
                                                for k in kernels])):
            spills = k.get("spill_stores", 0) + k.get("spill_loads", 0)
            total += spills
            if args.match in pretty:
                print(json.dumps({"source": name, **k, "kernel": pretty}),
                      flush=True)
        ok &= total == 0
        print(json.dumps({"source": name, "kernels": len(kernels),
                          "spill_bytes": total}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
