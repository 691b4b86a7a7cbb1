"""Instructions per draw of the built kernels, read from their SASS.

The draw loops of the hand-written kernels are bound by instruction
issue: an SM issues one warp instruction per scheduler per cycle, 128
lane instructions in all. So the count of SASS instructions a loop
issues per draw, times the draws, over 132 SMs x 128 lanes x the SM
clock, is the least time the loop can take on the card (its issue
floor), whatever the operations are.

``disassemble(lib)`` runs ``cuobjdump -sass`` on a built library;
``functions(text)`` splits its output into kernels; ``draw_loops(instrs)``
finds each loop that holds a Box-Muller angle (``sincos_2pi``'s
``floorf`` is one ``FRND.FLOOR`` per pair of normals, i.e. per two
draws) and no such loop inside it, and counts its instructions per
draw, its shuffles, its shared-memory loads and stores and its warp
barriers. In a lane group's loop (one lane's share of the draws) the
count is per draw per lane. A loop is the span from a backward branch's target to the branch.
Where a loop body branches (a guard that skips code), the count is of
every instruction in the span, an upper bound on what one pass issues.
Nothing here needs a card; ``disassemble`` needs the CUDA toolkit.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from collections import Counter

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"\bBRA(?:\.\S+)?\s+(?:`\()?(0x[0-9a-f]+)")
ANGLE_OP = "FRND.FLOOR"   # one per Box-Muller pair (two draws)
STUB_MULTIPLIER = "0x2c1b3c6d"   # stub_bits' mixing multiply (common.cuh)


def cuobjdump() -> str:
    path = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(path):
        raise RuntimeError("cuobjdump not found (looked on PATH and in "
                           "$CUDA_HOME/bin)")
    return path


def disassemble(lib) -> str:
    """``cuobjdump -sass`` of a built library."""
    return subprocess.run([cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def opcode(text: str) -> str:
    """The opcode of one instruction, without its predicate."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def functions(text: str) -> dict[str, list[tuple[int, str]]]:
    """Kernel (mangled name) -> its instructions as (address, text)."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return out


def loops(instrs) -> list[tuple[int, int]]:
    """(first, last) instruction positions of every loop: a branch whose
    target lies at or before it."""
    pos = {addr: i for i, (addr, _) in enumerate(instrs)}
    spans = []
    for i, (_, text) in enumerate(instrs):
        m = _TARGET.search(text)
        if m and opcode(text).startswith("BRA"):
            j = pos.get(int(m.group(1), 16))
            if j is not None and j <= i:
                spans.append((j, i))
    return spans


def draw_loops(instrs) -> list[dict]:
    """Each innermost loop with Box-Muller angles: its position, its
    instructions, its ``FRND.FLOOR`` count, the instructions per draw,
    whether it draws the stub stream (``stub_bits``' multiplier) and its
    ten commonest opcodes."""
    def angles(span):
        body = instrs[span[0]:span[1] + 1]
        return sum(opcode(t) == ANGLE_OP for _, t in body)

    found = [s for s in set(loops(instrs)) if angles(s)]
    inner = [s for s in found
             if not any(o != s and s[0] <= o[0] and o[1] <= s[1]
                        for o in found)]
    out = []
    for a, b in sorted(inner):
        body = instrs[a:b + 1]
        ops = Counter(opcode(t) for _, t in body)

        def count(*prefixes):
            return sum(n for op, n in ops.items()
                       if op.split(".")[0] in prefixes)

        out.append(dict(start=hex(body[0][0]), end=hex(body[-1][0]),
                        instructions=len(body), angles=ops[ANGLE_OP],
                        per_draw=len(body) / (2 * ops[ANGLE_OP]),
                        stub=any(STUB_MULTIPLIER in t for _, t in body),
                        shuffles=count("SHFL"), shared=count("STS", "LDS"),
                        syncs=count("WARPSYNC", "BAR", "NANOSLEEP"),
                        top=dict(ops.most_common(10))))
    return out


def issue_floor_ms(per_draw: float, draws: int, walkers: int,
                   sm_clock_mhz: float, sms: int = 132,
                   lanes: int = 128) -> float:
    """Milliseconds the card needs to issue ``per_draw`` instructions for
    each of ``draws`` draws of ``walkers`` walkers, at one instruction
    per lane per cycle on ``sms`` SMs of ``lanes`` lanes."""
    return per_draw * draws * walkers / (sms * lanes * sm_clock_mhz * 1e3)
