"""What the build made of the kernels: instruction counts and opcodes read
from their SASS, and registers and spills read from `ptxas -v`.

`listing()` runs `cuobjdump -sass` on the built library (and keeps the text
beside it, `build/kernels/libgraph_kernels_<sha>.sass`); `per_item_ops()`
counts, for one kernel, the instructions a thread issues for one item.  The
bound of a kernel is those counts times the items, over the card's issue
rate.  Not counted: uniform-datapath instructions (opcodes `U*`, issued once
per warp, not per thread), `NOP`, and the padding after the last `EXIT`.

  straight-line kernel  every counted instruction up to the last EXIT (where
                        the body branches, this is the longer path's bound
                        from above)
  grid-stride loop      the instructions of the loop that loads from global
                        memory, divided by the int32 items its loads carry
                        (a load of w bits carries w / 32: LDG.E.128 four);
                        where the loop has 64- or 128-bit loads, its 32-bit
                        ones are gathers of a table (relabel_gather's) and
                        carry no item of their own

`opcodes()` gives the base opcodes of each function whose name holds a
kernel's name (so a check can ask whether the prefill kernel issues HGMMA and
UTMALDG); `ptxas_usage()` parses the `ptxas -v` report that `build` keeps
beside each library.
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .build import build, cuda_tool

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)")
_TARGET = re.compile(r"\bBRA(?:\.\w+)*\s+(0x[0-9a-f]+)")
_WIDTH = re.compile(r"\.(64|128)(?:\.|$)")
_PTXAS_FUNC = re.compile(r"(?:Compiling entry function|Function properties for)\s+'?([^'\s]+)'?")
_PTXAS_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def listing(lib: Optional[Path] = None) -> str:
    """SASS of the kernel library (built first if need be)."""
    lib = lib or build()
    out = lib.with_suffix(".sass")
    if not out.exists():
        cmd = [cuda_tool("cuobjdump"), "-sass", str(lib)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"cuobjdump failed ({r.returncode}): {' '.join(cmd)}\n{r.stderr}")
        out.write_text(r.stdout)
    return out.read_text()


def _functions(text: str) -> Dict[str, List[Tuple[int, str, str]]]:
    """function name -> [(address, opcode, line)]."""
    funcs: Dict[str, List[Tuple[int, str, str]]] = {}
    body = None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            body = funcs.setdefault(m.group(1), [])
            continue
        m = _INSTR.match(line) if body is not None else None
        if m:
            body.append((int(m.group(1), 16), m.group(2), line))
    return funcs


def _counted(op: str) -> bool:
    return not (op.startswith("U") or op == "NOP")


def _items(op: str) -> int:
    """int32 items one global load carries, from its width (32 bits unless
    the opcode says 64 or 128)."""
    m = _WIDTH.search(op)
    return int(m.group(1)) // 32 if m else 1


def per_item_ops(text: str, kernel: str) -> int:
    """Instructions one thread issues per item in the function whose name
    holds `kernel` (one template instance: pass its mangled arguments too,
    as in `bucket_hist_kernelILi8E`)."""
    funcs = _functions(text)
    names = [n for n in funcs if kernel in n]
    if len(names) != 1:
        raise KeyError(f"{kernel!r} names {len(names)} functions in the SASS listing")
    body = funcs[names[0]]
    index_of = {a: i for i, (a, _, _) in enumerate(body)}
    # a branch back to an instruction before it closes a loop [target, branch]
    for i, (_, op, line) in enumerate(body):
        t = _TARGET.search(line) if op.startswith("BRA") else None
        start = index_of.get(int(t.group(1), 16), i) if t else i
        if start < i:
            loop = [o for _, o, _ in body[start:i + 1]]
            loads = [_items(o) for o in loop if o.startswith("LDG")]
            items = sum(w for w in loads if w > 1) or sum(loads)
            if items:
                return -(-sum(_counted(o) for o in loop) // items)
    last_exit = max(i for i, (_, op, _) in enumerate(body) if op == "EXIT")
    return sum(_counted(op) for _, op, _ in body[:last_exit + 1])


def opcodes(text: str, kernel: str) -> Dict[str, Set[str]]:
    """function name -> its base opcodes (before the first '.'), for every
    function whose name holds `kernel`."""
    return {name: {op.split(".")[0] for _, op, _ in body}
            for name, body in _functions(text).items() if kernel in name}


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """function name -> registers, stack frame and spill bytes, from a
    `ptxas -v` report."""
    usage: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = _PTXAS_FUNC.search(line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
            continue
        if name is None:
            continue
        m = _PTXAS_STACK.search(line)
        if m:
            usage[name].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if m:
            usage[name]["registers"] = int(m.group(1))
    return usage
