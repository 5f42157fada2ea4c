"""The batched step's two kernels side by side in SASS: K7's single step
(csrc/bdecode.cu `lane_step_kernel<read>`) and K9/K10's step loop
(csrc/bloop.cuh `lane_steps_kernel<read>`), for every weight read both
are built for.

    python3 -m bark_tpu_torch.probes.lane_sass [--out DIR]

It needs nvcc and cuobjdump (the CUDA toolkit), not a device: it builds
the library as the port does (`_build.build`), dumps its objects with
`cuobjdump -sass` and reports, for each kernel instance:

- from the objects' `-Xptxas -v` reports: registers, stack frame, spill
  stores and loads;
- from the SASS: its instructions, by opcode (the mnemonic before its
  first '.'), the reads of the thread index (`S2R ... SR_TID`), local
  memory (LDL/STL) and shared memory (LDS/STS) instructions;
- its innermost loops with HMMA (mma.sync: the products' chunk loops,
  around their waits): where each starts, its instructions by opcode,
  its HMMA, its thread-index reads and its shared and global loads,
  largest first.

Then, per read, the opcodes whose counts differ most between the loop and
the single step. Prints log lines on stderr and one `lane_sass` JSON line
on stdout (without the loops' text); lane_sass.json in `--out` (default:
the checkout's chiprun_out/) holds the record with the SASS text of each
HMMA loop.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")
_KERNEL = re.compile(r"(lane_steps?_kernel)INS_\d+(\w+?)EEEE?EvNS_")
_READ = re.compile(r"(DenseRead|PackedRead)I(13__nv_bfloat16|f)"
                   r"(6__half|f)?(Lb[01])?")
_TYPES = {"13__nv_bfloat16": "bf16", "f": "f32", "6__half": "f16"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def read_name(mangled: str) -> str:
    """`PackedRead<bf16,f16,min0>` for a mangled read's template
    arguments."""
    m = _READ.match(mangled)
    if m is None:
        return mangled
    args = [_TYPES[m.group(2)]]
    if m.group(3):
        args.append(_TYPES[m.group(3)])
    if m.group(4):
        args.append("min" + m.group(4)[-1])
    return f"{m.group(1)}<{','.join(args)}>"


def functions(dump: str) -> dict:
    """{function name: [(address, instruction text)]} of a `cuobjdump
    -sass` listing."""
    out, cur = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(text: str) -> str:
    """The mnemonic of an instruction, its predicate and modifiers aside."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def _counts(instrs) -> dict:
    ops = collections.Counter(opcode(t) for _, t in instrs)
    return dict(
        instructions=len(instrs),
        tid_reads=sum("S2R" in t and "SR_TID" in t for _, t in instrs),
        HMMA=ops["HMMA"], LDS=ops["LDS"], STS=ops["STS"], LDG=ops["LDG"],
        LDL=ops["LDL"], STL=ops["STL"], ops=ops)


def hmma_loops(instrs) -> list:
    """A function's innermost loops with HMMA (a product's chunk loop,
    around its waits), largest first: each backward branch's [target,
    branch] range that holds an HMMA and no other such range, with its
    counts (`_counts`) and its instructions' text (`sass`)."""
    index = {a: i for i, (a, _) in enumerate(instrs)}
    spans = set()
    for i, (addr, text) in enumerate(instrs):
        m = _BRANCH.search(text)
        if m and opcode(text) == "BRA":
            t = int(m.group(1), 16)
            if (t <= addr and t in index and any(
                    opcode(x) == "HMMA" for _, x in instrs[index[t]:i + 1])):
                spans.add((index[t], i))
    out = []
    for s, e in sorted(spans):
        if any((s2, e2) != (s, e) and s <= s2 and e2 <= e
               for s2, e2 in spans):
            continue
        c = _counts(instrs[s:e + 1])
        c["ops"] = dict(c["ops"].most_common())
        out.append(dict(start=hex(instrs[s][0]), **c,
                        sass=[t for _, t in instrs[s:e + 1]]))
    return sorted(out, key=lambda r: -r["instructions"])


def ptxas_properties(report: str) -> dict:
    """{function name: registers, stack frame and spills} of a `-Xptxas -v`
    report."""
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def compare(dumps: dict, reports: dict) -> dict:
    """Per read, the two kernels' records and the opcodes whose counts
    differ most (loop - single step). `dumps` and `reports`: the SASS
    listings and ptxas reports of the objects that hold them."""
    funcs, props = {}, {}
    for text in dumps.values():
        funcs.update(functions(text))
    for text in reports.values():
        props.update(ptxas_properties(text))
    kernels = collections.defaultdict(dict)
    for name, instrs in funcs.items():
        m = _KERNEL.search(name)
        if m is None:
            continue
        c = _counts(instrs)
        kernels[read_name(m.group(2))][m.group(1)] = dict(
            **props.get(name, {}), **c,
            hmma_loops=hmma_loops(instrs))
    out = {}
    for read, pair in sorted(kernels.items()):
        if len(pair) != 2:
            continue
        one, loop = pair["lane_step_kernel"], pair["lane_steps_kernel"]
        diff = collections.Counter(loop["ops"])
        diff.subtract(one["ops"])
        for rec in (one, loop):
            rec["ops"] = dict(rec["ops"].most_common(12))
        out[read] = dict(
            single_step=one, loop=loop,
            op_diff=dict(sorted(((k, v) for k, v in diff.items() if v),
                                key=lambda kv: -abs(kv[1]))[:16]))
    return out


def brief(rec: dict) -> dict:
    """`compare`'s record of one read without the loops' SASS text."""
    return {k: ({**v, "hmma_loops": [{f: x for f, x in lp.items()
                                      if f != "sass"}
                                     for lp in v["hmma_loops"]]}
                if isinstance(v, dict) and "hmma_loops" in v else v)
            for k, v in rec.items()}


def summary(read: str, rec: dict) -> str:
    """`compare`'s record of one read as log lines."""
    lines = [f"  {read}:"]
    for kind in ("single_step", "loop"):
        r = rec[kind]
        hm = r["hmma_loops"]
        lines.append(
            f"    {kind:11s} regs {r.get('registers')} spill "
            f"{r.get('spill_stores')}/{r.get('spill_loads')} B, "
            f"{r['instructions']} instructions, {r['tid_reads']} thread-"
            f"index reads, LDL/STL {r['LDL']}/{r['STL']}; HMMA loops "
            + ", ".join(f"{lp['instructions']} instr ({lp['HMMA']} HMMA, "
                        f"{lp['tid_reads']} tid, {lp['LDS']} LDS)"
                        for lp in hm))
    lines.append(f"    loop - single step: {rec['op_diff']}")
    return "\n".join(lines)


def record() -> dict:
    """`compare` on the library's bdecode, bloop and bloop_f32 objects,
    built first unless they are."""
    from bark_tpu_torch.kernels import _build
    from bark_tpu_torch.probes.cache import _cuobjdump

    _build.build()
    dumps, reports = {}, {}
    for src in ("bdecode.cu", "bloop.cu", "bloop_f32.cu"):
        obj = _build._object_path(_build.SRC_DIR / src)
        dumps[src] = subprocess.run([_cuobjdump(), "-sass", str(obj)],
                                    capture_output=True, text=True,
                                    check=True).stdout
        reports[src] = obj.with_suffix(".ptxas.txt").read_text()
    return compare(dumps, reports)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--out", default=os.path.join(root, "chiprun_out"))
    args = ap.parse_args(argv)
    sys.path.insert(0, root)
    rec = record()
    for read, r in rec.items():
        log(summary(read, r))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "lane_sass.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"lane_sass": {read: brief(r)
                                    for read, r in rec.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
