#!/usr/bin/env python3
"""Compare the kernel builds of two checkouts of the port, function by
function, on a machine with the CUDA toolkit.

    python3 quadrotorilqr_tpu_torch/tools/build_compare.py OLD NEW

Each ROOT is a checkout of the repository (for example the parent commit
unpacked with `git archive` into a git-ignored directory, and this tree).
The script builds both kernel libraries at once, one process per checkout
(or reuses a build already made), then, for every function the two builds
share (named as chip_smoke.py's `ptxas_summary` names them: kernel, dtype,
flags, model family), compares the `-Xptxas -v` lines (registers, spill
stores, stack bytes) and the SASS that `cuobjdump -sass` prints (addresses
and instruction encodings stripped). It prints each function that differs,
the functions only the new build has, and as its last line a JSON summary.
A change that must leave the other families' kernels as they were shows
zero differing functions.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

_LOAD = (
    "import json, sys; sys.path.insert(0, sys.argv[1]); "
    "from quadrotorilqr_tpu_torch.kernels import _build; lib = _build.load(); "
    "print(json.dumps({'path': str(lib.path), 'seconds': lib.build_seconds, "
    "'log': lib.build_log}))"
)


def _cuobjdump():
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda, "bin", "cuobjdump")


def sass_by_function(path):
    """{mangled name: [SASS text of each copy]} of a shared library, the
    addresses and the instruction encodings stripped."""
    out = subprocess.run([_cuobjdump(), "-sass", path], capture_output=True, text=True,
                         check=True).stdout
    funcs, name, body = {}, None, []
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                funcs.setdefault(name, []).append("\n".join(body))
            name, body = m.group(1), []
            continue
        if name is None:
            continue
        ins = re.sub(r"/\*[0-9a-fx]+\*/", "", line)
        ins = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", ins).strip()
        if ins:
            body.append(ins)
    if name:
        funcs.setdefault(name, []).append("\n".join(body))
    return funcs


def main(old, new):
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(os.path.dirname(here)))
    from chip_smoke import ptxas_summary

    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, root], stdout=subprocess.PIPE,
                              text=True) for root in (old, new)]
    builds = [json.loads(p.communicate()[0].strip().splitlines()[-1]) for p in procs]
    for root, b in zip((old, new), builds):
        took = "reused" if b["seconds"] is None else f"{b['seconds']:.1f} s"
        print(f"{root}: {os.path.basename(b['path'])}, build {took}", flush=True)

    def short(mangled):
        return next(iter(ptxas_summary(f"Compiling entry function '{mangled}'\n")))

    ptxas = [ptxas_summary(b["log"]) if b["log"] else None for b in builds]
    sass = [{short(k): v for k, v in sass_by_function(b["path"]).items()} for b in builds]
    shared = sorted(set(sass[0]) & set(sass[1]))
    sass_diff = [k for k in shared if sass[0][k] != sass[1][k]]
    ptxas_diff = []
    if ptxas[0] is not None and ptxas[1] is not None:
        ptxas_diff = [k for k in sorted(set(ptxas[0]) & set(ptxas[1]))
                      if ptxas[0][k] != ptxas[1][k]]
    for k in ptxas_diff:
        print(f"ptxas differs: {k}: {ptxas[0][k]} -> {ptxas[1][k]}")
    for k in sass_diff:
        print(f"SASS differs: {k}")
    for k in sorted(set(sass[1]) - set(sass[0])):
        print(f"new: {k}" + (f" {ptxas[1].get(k)}" if ptxas[1] else ""))
    print(json.dumps({
        "old": old, "new": new, "sass_functions": [len(sass[0]), len(sass[1])],
        "sass_shared": len(shared), "sass_differs": len(sass_diff),
        "ptxas_functions": [None if p is None else len(p) for p in ptxas],
        "ptxas_differs": None if None in ptxas else len(ptxas_diff),
    }))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2]))
