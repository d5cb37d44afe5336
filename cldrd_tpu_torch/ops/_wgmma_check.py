"""A check of the built kernels' machine code for wgmma register hazards.

``wgmma.mma_async`` reads its register operands (the A fragments of the
register-A form) and writes its accumulators asynchronously, until a
``wgmma.wait_group`` retires its group. An instruction that writes an A
fragment's registers, or touches the accumulators, before that wait races
with the tensor cores: the product may read the new value, and the result
then varies from run to run. This module reads the SASS that ``cuobjdump``
prints for a library and follows every path from each ``HGMMA`` (the SASS
of ``wgmma.mma_async``) to the ``WARPGROUP.DEPBAR`` (``wait_group``) that
retires it, reporting each such instruction on the way.

In SASS, the last ``HGMMA`` of a group carries ``gsb0`` (its commit), and
``WARPGROUP.DEPBAR.LE gsb0, N`` waits until at most N groups are pending:
a group is retired there once N or more groups were committed after it.
"""
from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Set

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")
_FUNC = re.compile(r"Function : (\S+)")
_REG = re.compile(r"\bR(\d+)(\.64)?\b")
_SHAPE = re.compile(r"HGMMA\.64x(\d+)x")


class Insn(NamedTuple):
    addr: int
    pred: str      # "" or the guard, e.g. "@!P0"
    op: str        # opcode with its modifiers
    args: List[str]
    text: str


class Hazard(NamedTuple):
    function: str
    hgmma: Insn
    insn: Insn
    kind: str      # "A written" or "accumulator touched"

    def __str__(self):
        return (f"{self.function}: {self.kind} at {self.insn.addr:#06x} "
                f"({self.insn.text}) while the HGMMA at "
                f"{self.hgmma.addr:#06x} ({self.hgmma.text}) may run")


def parse(sass: str) -> Dict[str, List[Insn]]:
    """``{function: [instructions in address order]}`` from cuobjdump's
    ``-sass`` listing."""
    out: Dict[str, List[Insn]] = {}
    cur: Optional[List[Insn]] = None
    for line in sass.splitlines():
        f = _FUNC.search(line)
        if f:
            cur = out.setdefault(f.group(1), [])
            continue
        m = _LINE.search(line)
        if not m or cur is None:
            continue
        text = m.group(2).strip()
        pred = ""
        if text.startswith("@"):
            pred, text = text.split(None, 1)
        parts = text.split(None, 1)
        args = ([a.strip() for a in parts[1].split(",")]
                if len(parts) > 1 else [])
        cur.append(Insn(int(m.group(1), 16), pred, parts[0], args,
                        f"{pred} {text}".strip()))
    return out


def _regs(token: str, width: int = 1) -> Set[int]:
    m = re.fullmatch(r"-?\|?R(\d+)(\.[A-Z0-9_.]+)?\|?", token)
    if not m:
        return set()
    return set(range(int(m.group(1)), int(m.group(1)) + width))


def _written(insn: Insn) -> Set[int]:
    """General registers an instruction writes (its first register
    operand, widened by the opcode's vector width)."""
    op, args = insn.op, insn.args
    if not args or op.startswith(("ST", "RED", "BRA", "BAR", "LDGSTS",
                                  "WARPGROUP", "DEPBAR", "MEMBAR", "SYNCS",
                                  "UTMA", "UBLKCP", "R2P", "EXIT", "FENCE")):
        return set()
    first = 1 if op.startswith("SHFL") else 0  # SHFL: predicate first
    if first >= len(args):
        return set()
    if op.startswith("HGMMA"):
        m = _SHAPE.match(op)
        width = int(m.group(1)) // 2 if m else 1
    elif ".128" in op or op.startswith("LDSM") and op.endswith(".4"):
        width = 4
    elif (".64" in op or "WIDE" in op or op.startswith("CS2R")
          or op.startswith("LDSM") and op.endswith(".2")):
        width = 2
    else:
        width = 1
    return _regs(args[first], width)


def _touched(insn: Insn) -> Set[int]:
    """Registers named anywhere in an instruction (a 64-bit address
    ``R2.64`` names R2 and R3)."""
    out: Set[int] = set()
    for a in insn.args:
        for m in _REG.finditer(a):
            r = int(m.group(1))
            out.update((r, r + 1) if m.group(2) else (r,))
    return out | _written(insn)


def _successors(insns: List[Insn], i: int, index: Dict[int, int]):
    insn = insns[i]
    nxt = [i + 1] if i + 1 < len(insns) else []
    if insn.op.startswith("BRA"):
        target = next((a for a in insn.args if a.startswith("0x")), None)
        to = [index[int(target, 16)]] if target and int(
            target, 16) in index else []
        return to + (nxt if insn.pred else [])
    if insn.op.startswith(("EXIT", "RET", "BRX", "JMX", "JMP")):
        return nxt if insn.pred and insn.op.startswith("EXIT") else []
    return nxt


def _is_commit(insn: Insn) -> bool:
    return insn.op.startswith("HGMMA") and "gsb0" in insn.args


def _retire_depth(insn: Insn) -> Optional[int]:
    if insn.op.startswith("WARPGROUP.DEPBAR") and insn.args:
        return int(insn.args[-1], 0)
    return None


def hazards_in(function: str, insns: List[Insn]) -> List[Hazard]:
    """Every instruction that writes an in-flight HGMMA's register-A
    operand, or names its accumulators, on some path before the
    ``WARPGROUP.DEPBAR`` that retires it."""
    index = {insn.addr: i for i, insn in enumerate(insns)}
    found: List[Hazard] = []
    for h, hg in enumerate(insns):
        if not hg.op.startswith("HGMMA"):
            continue
        acc = _written(hg)
        a_regs = (_regs(hg.args[1], 4) if len(hg.args) > 1
                  and hg.args[1].startswith("R") else set())
        seen = set()
        stack = [(s, _is_commit(hg), 0)
                 for s in _successors(insns, h, index)]
        while stack:
            i, committed, after = stack.pop()
            key = (i, committed, min(after, 8))
            if key in seen:
                continue
            seen.add(key)
            insn = insns[i]
            depth = _retire_depth(insn)
            if depth is not None and committed and after >= depth:
                continue  # retired on this path
            if insn.op.startswith("HGMMA"):
                if _is_commit(insn):
                    committed, after = True, after + (1 if committed else 0)
                # a later product of the chain may share the accumulators
            else:
                if a_regs & _written(insn):
                    found.append(Hazard(function, hg, insn, "A written"))
                if acc & _touched(insn):
                    found.append(Hazard(function, hg, insn,
                                        "accumulator touched"))
            stack.extend((s, committed, after)
                         for s in _successors(insns, i, index))
    return found


def hazards(sass: str) -> List[Hazard]:
    return [hz for fn, insns in parse(sass).items()
            for hz in hazards_in(fn, insns)]


def cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("cuobjdump not found (it comes with the CUDA toolkit)")


def library_sass(path) -> str:
    return subprocess.run([cuobjdump(), "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout


def check_libraries(paths: Iterable) -> Dict[str, int]:
    """``{library: HGMMA count}``; raises listing every hazard found."""
    counts, bad = {}, []
    for path in paths:
        sass = library_sass(path)
        counts[Path(path).name] = sum(
            insn.op.startswith("HGMMA")
            for insns in parse(sass).values() for insn in insns)
        bad += [f"{Path(path).name}: {hz}" for hz in hazards(sass)]
    if bad:
        raise AssertionError("wgmma register hazards:\n" + "\n".join(bad))
    return counts
