"""Count the SASS instructions of the kernels in built CUDA libraries.

    python3 tools/sass_census.py LIB.so [LIB.so ...] [--match REGEX]
        [--min-loop N]

For every kernel of each library whose demangled name matches REGEX (all
of them by default) prints one line: its instructions in all, by class,
and the same counts for each innermost loop of at least N instructions
(the instructions between a backward branch and its target that hold no
other backward branch).  A static census: what the compiler emitted, not
what a run executes; an inner loop's counts are what one trip of it
issues.  Needs ``cuobjdump`` (the CUDA toolkit's, or the copy in Triton's
package) and ``c++filt``.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

# instruction classes, by opcode prefix (the first that matches)
CLASSES = (
    ("ldgsts", ("LDGSTS",)),
    ("lds", ("LDS",)),
    ("sts", ("STS",)),
    ("ldg", ("LDG",)),
    ("stg", ("STG",)),
    ("local", ("LDL", "STL")),
    ("cvt", ("F2F", "F2FP", "HADD2.F32", "I2F", "F2I", "PRMT")),
    ("fp32", ("FFMA", "FADD", "FMUL", "FMNMX", "FSEL", "FSETP")),
    ("int", ("IMAD", "IADD", "LOP", "SHF", "LEA", "ISETP", "SEL", "IMNMX")),
    ("bar", ("BAR",)),
    ("shfl", ("SHFL",)),
)
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
BRANCH = re.compile(r"^(?:@!?U?P\w+\s+)?BRA(?:\.\S+)?\s+(?:\S+,\s*)?0x([0-9a-f]+)")


def cuobjdump():
    cands = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton

        cands.append(str(Path(triton.__file__).parent / "backends" / "nvidia"
                         / "bin" / "cuobjdump"))
    except ImportError:
        pass
    for c in cands:
        if c and Path(c).exists():
            return c
    raise SystemExit("sass_census: no cuobjdump")


def functions(sass):
    """(mangled name, [(address, instruction text)]) per kernel."""
    out = []
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        insns = [(int(a, 16), text) for a, text in INSN.findall(block)]
        out.append((name, insns))
    return out


def opcode(text):
    return re.sub(r"^@!?U?P\w+\s+", "", text).split(" ", 1)[0]


def census(insns):
    """Counts by class ('other' for the rest) and in all ('n')."""
    c = Counter()
    for _, text in insns:
        op = opcode(text)
        for cls, prefixes in CLASSES:
            if op.startswith(prefixes):
                c[cls] += 1
                break
        else:
            c["other"] += 1
    c["n"] = len(insns)
    return c


def inner_loops(insns):
    """The innermost loops as (first address, last address) pairs."""
    loops = []
    for addr, text in insns:
        m = BRANCH.match(text)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    return sorted(
        (t, b) for t, b in loops
        if not any((t2, b2) != (t, b) and t <= t2 and b2 <= b
                   for t2, b2 in loops))


def fmt(c):
    keys = ["n"] + [k for k, _ in CLASSES] + ["other"]
    return " ".join(f"{k} {c[k]}" for k in keys if c[k])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("libs", nargs="+")
    ap.add_argument("--match", default="")
    ap.add_argument("--min-loop", type=int, default=1)
    args = ap.parse_args()
    tool = cuobjdump()
    for lib in args.libs:
        sass = subprocess.run([tool, "-sass", lib], check=True,
                              capture_output=True, text=True).stdout
        funcs = functions(sass)
        names = subprocess.run(["c++filt"], input="\n".join(
            n for n, _ in funcs), check=True, capture_output=True,
            text=True).stdout.splitlines()
        for (_, insns), name in zip(funcs, names):
            label = re.sub(r"\(.*$", "", re.sub(r"^.*?::", "", name))
            if not re.search(args.match, label):
                continue
            loops = [census([i for i in insns if t <= i[0] <= b])
                     for t, b in inner_loops(insns)]
            loops = [c for c in loops if c["n"] >= args.min_loop]
            print(f"sass {Path(lib).name} {label}: {fmt(census(insns))}")
            for k, c in enumerate(loops):
                print(f"sass {Path(lib).name} {label} inner loop {k}: "
                      f"{fmt(c)}")


if __name__ == "__main__":
    main()
