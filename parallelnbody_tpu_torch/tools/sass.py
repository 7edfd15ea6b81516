#!/usr/bin/env python3
"""The inner loops of the kernel library's SASS, counted.

    python3 -m parallelnbody_tpu_torch.tools.sass [LIBRARY] [--dump DIR]

For every kernel in LIBRARY (default: the library of this checkout's
sources, built if needed), `cuobjdump -sass` gives the machine code; the
innermost backward-branch loop that holds the most MUFU.RSQ is the loop over
sources (one rsqrt a pair or node-target term); for a tensor-core kernel
(K5-K7) the one that also holds HMMA is reported too (`tensor_loop`: V4's
band loop runs on the FP32 pipes alone). Printed, one JSON line per
kernel: its instructions, rsqrts, instructions per pair (instructions /
MUFU.RSQ), instructions by opcode, the kernel's whole length in
instructions (`kernel_instructions`: what an unrolled loop costs the
instruction cache), and the registers and static shared memory that
`ptxas -v` reported in the build log kept beside the library
(`<library>.log`). With --dump, each loop's SASS text is written to DIR.

Needs the CUDA toolkit's cuobjdump (beside nvcc), not a GPU. Any built
library can be read, so two checkouts' kernels can be compared.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
from pathlib import Path

from parallelnbody_tpu_torch.kernels import build

_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRA = re.compile(r"\bBRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
_PTXAS_FN = re.compile(r"Function properties for (\S+)")
_PTXAS_USE = re.compile(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$")


def _functions(sass):
    """({mangled name: [(address, instruction text)]}, {name: {label:
    address of the instruction that follows it}})."""
    funcs, labels, name, pending = {}, {}, None, []
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.match(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[name][lab] = addr
            pending = []
            funcs[name].append((addr, m.group(2)))
    return funcs, labels


def _opcode(text):
    tok = text.split()
    if tok and tok[0].startswith("@"):
        tok = tok[1:]
    return tok[0] if tok else ""


def inner_loops(lib_path):
    """{mangled kernel name: {instructions, pairs, per_pair, opcodes,
    text, kernel_instructions}} for the innermost loop of each kernel that
    holds the most MUFU.RSQ (pairs = its MUFU.RSQ count), with
    `tensor_loop` (the same keys but text) for the one of those with
    HMMA, where there is one."""
    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    funcs, labels = _functions(sass)
    out = {}
    for name, insns in funcs.items():
        loops = []
        for addr, text in insns:
            m = _BRA.search(text)
            if not m:
                continue
            target = (labels[name].get(m.group(1)) if m.group(1)
                      else int(m.group(2), 16))
            if target is not None and target <= addr:
                loops.append((target, addr))
        inner = [(a, b) for a, b in loops
                 if not any(a <= c and d <= b and (c, d) != (a, b)
                            for c, d in loops)]
        best = tensor = None
        for a, b in inner:
            text = [t for x, t in insns if a <= x <= b]
            body = [_opcode(t) for t in text]
            mufu = sum(op.startswith("MUFU.RSQ") for op in body)
            if not mufu:
                continue
            rec = {"instructions": len(body), "pairs": mufu,
                   "per_pair": len(body) / mufu,
                   "opcodes": dict(collections.Counter(
                       op.split(".")[0] for op in body).most_common()),
                   "text": text}
            if best is None or mufu > best["pairs"]:
                best = rec
            if "HMMA" in rec["opcodes"] and (tensor is None
                                             or mufu > tensor["pairs"]):
                tensor = rec
        if best:
            out[name] = dict(best, kernel_instructions=len(insns))
            if tensor is not None:
                out[name]["tensor_loop"] = {k: v for k, v in tensor.items()
                                            if k != "text"}
    return out


def ptxas_usage(lib_path):
    """{mangled name: (registers, static shared bytes)} from the build log
    beside the library."""
    out, name = {}, None
    log = Path(lib_path).with_suffix(".log")
    for line in log.read_text().splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            name = m.group(1)
            continue
        m = _PTXAS_USE.search(line)
        if m and name:
            out[name] = (int(m.group(1)), int(m.group(2) or 0))
            name = None
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("library", nargs="?", default=None)
    ap.add_argument("--dump", metavar="DIR", default=None)
    opts = ap.parse_args()
    lib = Path(opts.library) if opts.library else build.build()
    usage = ptxas_usage(lib)
    for name, rec in inner_loops(lib).items():
        text = rec.pop("text")
        if opts.dump:
            os.makedirs(opts.dump, exist_ok=True)
            with open(os.path.join(opts.dump, f"{name[-60:]}.sass"), "w") as f:
                f.write("\n".join(text) + "\n")
        regs, smem = usage.get(name, (None, None))
        print(json.dumps({"kernel": name, "library": lib.name,
                          "registers": regs, "static_smem_bytes": smem,
                          **rec}), flush=True)


if __name__ == "__main__":
    main()
