"""Compare the production kernels of two source trees: ptxas's report
(registers, shared memory, stack, spills) and the SASS of every kernel.

    python scripts/ptxas_diff.py OLD_CSRC NEW_CSRC [--out DIR]

Each ``*.cu`` of both ``kernels/csrc`` directories is compiled by nvcc with
the production flags of ``repro_torch.kernels.build`` (one nvcc per
library, all started together; the flags are the same for both trees),
into ``DIR`` (default ``build/ptxas_diff``).  For every kernel the script
prints its ptxas lines from both trees and whether they match, and
compares ``cuobjdump -sass`` of the two libraries function by function
(the ``identifier`` lines, which name the source file, and the per-file
ids of anonymous namespaces in mangled names left out).  Exits
1 on any difference, 2 when a build fails.  Runs where nvcc is, on the
machine with the card.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
#: the per-file id nvcc mangles into names from an anonymous namespace
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def _plain(text: str) -> str:
    """``text`` with the anonymous namespaces' per-file ids taken out, so
    one kernel has one name in both trees."""
    return _ANON.sub("_GLOBAL__N__", text)


def ptxas_lines(log: str) -> dict:
    """{kernel: [its 'stack frame ... spill' and 'Used ...' lines]} from an
    ``nvcc -Xptxas -v`` log."""
    out, cur, props = {}, None, None
    for line in _plain(log).splitlines():
        line = line.strip()
        m = _ENTRY.search(line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, [])
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            out.setdefault(props, [])
            continue
        if "stack frame" in line and props is not None:
            out[props].append(line)
            props = None
        elif line.startswith("ptxas info    : Used") and cur is not None:
            out[cur].append(line.split(":", 1)[1].strip())
    return out


def sass_functions(lib: Path) -> dict:
    """{function: its SASS lines} from ``cuobjdump -sass``."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in _plain(text).splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = []
        elif cur is not None and "identifier" not in line:
            out[cur].append(line.rstrip())
    return out


def compile_tree(csrc: Path, out: Path, nvcc: str) -> dict:
    """{source name: (library, ptxas log)} of every ``*.cu`` in csrc."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for cu in sorted(csrc.glob("*.cu")):
        lib = out / f"{cu.stem}.so"
        cmd = [nvcc, *build._flags(cu.stem), "-o", str(lib), str(cu)]
        procs[cu.stem] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    res = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {csrc / name}.cu:\n{log}")
            raise SystemExit(2)
        res[name] = (lib, log)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ptxas_diff")
    args = ap.parse_args(argv)
    nvcc = build._nvcc()
    trees = {tag: compile_tree(csrc, args.out / tag, nvcc)
             for tag, csrc in (("old", args.old), ("new", args.new))}
    differ = 0
    names = sorted(set(trees["old"]) | set(trees["new"]))
    for name in names:
        if name not in trees["old"] or name not in trees["new"]:
            print(f"{name}: only in one tree")
            differ += 1
            continue
        (old_lib, old_log), (new_lib, new_log) = (trees["old"][name],
                                                  trees["new"][name])
        old_p, new_p = ptxas_lines(old_log), ptxas_lines(new_log)
        for kernel in sorted(set(old_p) | set(new_p)):
            same = old_p.get(kernel) == new_p.get(kernel)
            differ += not same
            print(f"{name} {kernel}: ptxas {'same' if same else 'DIFFERS'}")
            for tag, rep in (("old", old_p), ("new", new_p)):
                for line in rep.get(kernel, ["(absent)"]):
                    print(f"    {tag}: {line}")
        old_s, new_s = sass_functions(old_lib), sass_functions(new_lib)
        for fn in sorted(set(old_s) | set(new_s)):
            a, b = old_s.get(fn), new_s.get(fn)
            if a == b:
                print(f"{name} {fn}: SASS same ({len(a)} lines)")
                continue
            differ += 1
            n = (sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
                 if a is not None and b is not None else -1)
            print(f"{name} {fn}: SASS DIFFERS ({n} lines)")
    print(f"ptxas_diff: {len(names)} libraries, {differ} difference(s)")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
