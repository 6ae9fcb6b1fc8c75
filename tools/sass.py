"""Instruction counts from a kernel's SASS (cuobjdump -sass), for the
instruction-issue floors that chip_smoke.py prints beside a kernel's
bound.

A warp scheduler issues at most one instruction a cycle and a Hopper SM
has four, so a kernel whose warps issue I instructions in all takes at
least I / (4 x SMs x clock). The counts here are of one pass through a
stretch of straight code or one iteration of a loop, along the shortest
path the code can take without a CALL (a predicated branch may go either
way; a CALL leads to the out-of-line slow path of an IEEE division or
root, which ordinary operands never take), so the floor they give is a
lower bound on issue.

Only parsing lives here, so the CPU tests can hold it to a listing; the
listing itself comes from `disassemble` on a machine with the CUDA
toolkit.
"""

from __future__ import annotations

import dataclasses
import heapq
import re
import subprocess
from pathlib import Path

SCHEDULERS_PER_SM = 4      # warp schedulers per SM (Hopper)

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-fA-F]+)\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*([.$\w][\w.$]*):\s*$")
_TARGET = re.compile(r"`\(([^)]+)\)|\b(0x[0-9a-fA-F]+)\b")


@dataclasses.dataclass
class Instr:
    addr: int
    pred: str          # "" or the guard, e.g. "@!P0"
    op: str            # opcode with modifiers, e.g. "LDS.128"
    text: str          # the whole instruction
    target: int | None = None   # a branch's or call's target address


def disassemble(lib: Path, cuobjdump: str) -> str:
    """cuobjdump -sass of a shared library or object."""
    return subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def functions(listing: str) -> dict[str, list[Instr]]:
    """{mangled name: instructions} of every function in a listing, branch
    and call targets resolved to addresses (cuobjdump prints either a
    label, `(.L_x_3), or an address)."""
    out: dict[str, list[Instr]] = {}
    name = None
    labels: dict[str, int] = {}
    pending: list[str] = []
    raw: list[tuple[Instr, str | None]] = []

    def close():
        if name is None:
            return
        for ins, ref in raw:
            if ref is not None:
                ins.target = (int(ref, 16) if ref.startswith("0x")
                              else labels.get(ref))
        out[name] = [ins for ins, _ in raw]

    for line in listing.splitlines():
        m = _FUNC.match(line)
        if m:
            close()
            name, labels, pending, raw = m.group(1), {}, [], []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        addr, body = int(m.group(1), 16), m.group(2).strip()
        for lab in pending:
            labels[lab] = addr
        pending = []
        pred = ""
        if body.startswith("@"):
            pred, body = body.split(None, 1)
        op = body.split(None, 1)[0]
        ref = None
        if op.startswith(("BRA", "CALL", "BRX", "JMP")):
            t = _TARGET.search(body)
            if t:
                ref = t.group(1) or t.group(2)
        raw.append((Instr(addr, pred, op, body), ref))
    close()
    return out


def find(funcs: dict[str, list[Instr]], key: str) -> list[Instr]:
    """The one function whose name holds `key`."""
    hits = [n for n in funcs if key in n]
    if len(hits) != 1:
        raise KeyError(f"{key!r} matches {hits}")
    return funcs[hits[0]]


def _conditional(ins: Instr) -> bool:
    """A branch that may fall through: a guard other than @PT, or an
    operand besides its target (BRA.U !UP0, BRA.DIV UR4, ...)."""
    if ins.pred and ins.pred != "@PT":
        return True
    rest = _TARGET.sub("", ins.text.split(None, 1)[1] if " " in ins.text else "")
    return bool(rest.strip(" ,"))


def _successors(code):
    """For each instruction, the indices that may come next (empty: the
    path ends there)."""
    idx = {c.addr: k for k, c in enumerate(code)}
    out = []
    for i, ins in enumerate(code):
        if ins.op.startswith(("EXIT", "RET")):
            nxt = [i + 1] if ins.pred and ins.pred != "@PT" else []
        elif ins.op.startswith(("BRX", "JMX", "JMP", "CALL")):
            nxt = []        # a CALL is a slow path, taken by no counted path
        elif ins.op.startswith("BRA"):
            t = idx.get(ins.target)
            nxt = ([] if t is None else [t]) + ([i + 1] if _conditional(ins)
                                                 else [])
        else:
            nxt = [i + 1]
        out.append([j for j in nxt if j < len(code)])
    return out


def shortest_path(code, start, done, counted=lambda ins: False, need=0,
                  succ=None):
    """Fewest instructions (NOPs free) from code[start] to an instruction
    for which done(index) holds, passing exactly `need` instructions for
    which counted() is true, and no branch to a lower address than start
    (a loop is counted one iteration at a time). succ: each instruction's
    successors (default _successors(code)). Returns (instructions, path
    indices) or raises ValueError."""
    succ = _successors(code) if succ is None else succ
    heap = [(0, start, 0)]
    dist = {(start, 0): 0}
    parent = {(start, 0): None}
    while heap:
        cost, i, got = heapq.heappop(heap)
        if cost > dist[(i, got)]:
            continue
        ins = code[i]
        now = got + bool(counted(ins))
        if now > need:
            continue
        cost += not ins.op.startswith("NOP")
        if done(i) and now == need:
            path, key = [], (i, got)
            while key is not None:
                path.append(key[0])
                key = parent[key]
            return cost, path[::-1]
        for j in succ[i]:
            if j < start:
                continue
            if cost < dist.get((j, now), float("inf")):
                dist[(j, now)] = cost
                parent[(j, now)] = (i, got)
                heapq.heappush(heap, (cost, j, now))
    raise ValueError("no path to the goal")


def _loops(code, body_op: str) -> list[tuple[int, int, int]]:
    """(span, head, backward branch) of every loop holding an instruction
    whose opcode starts with body_op."""
    loops = []
    idx = {c.addr: k for k, c in enumerate(code)}
    for i, ins in enumerate(code):
        if ins.op.startswith("BRA") and ins.target is not None \
                and ins.target <= ins.addr:
            head = idx[ins.target]
            if any(c.op.startswith(body_op) for c in code[head:i + 1]):
                loops.append((i - head, head, i))
    if not loops:
        raise ValueError(f"no loop holds {body_op}")
    return loops


def _iteration(code, head, back, body_op, marker=lambda ins: False):
    """The shortest path from a loop's head to its backward branch that
    passes every instruction of the loop whose opcode starts with body_op
    or for which marker(instr) holds: (count, path)."""
    def counted(ins):
        return ins.op.startswith(body_op) or marker(ins)

    need = sum(map(counted, code[head:back + 1]))
    cost, path = shortest_path(code, head, lambda k: k == back, counted, need)
    return cost, [code[k] for k in path]


def loop_iteration(code, body_op: str) -> tuple[int, list[Instr]]:
    """Instructions of one iteration of the innermost loop holding an
    instruction whose opcode starts with body_op: the shortest path from
    the loop's head to its backward branch that passes every such
    instruction of the loop (a branch around the work, e.g. for an
    excluded triangle, is not an iteration's cost). Returns (count,
    path)."""
    _, head, back = min(_loops(code, body_op))
    return _iteration(code, head, back, body_op)


def loop_through(code, loop_op: str, marker, need: int):
    """Instructions of one iteration of the innermost loop holding an
    instruction whose opcode starts with loop_op, along the shortest path
    from its head to its backward branch that passes exactly `need`
    instructions for which marker(instr) holds; a loop inside it may be
    taken any number of times. E.g. B1's edge loop (the loop of the
    score's root, MUFU.RSQ) through no division (an edge no lane projects)
    or through one (MUFU.RCP: one projection), or K8's backward's step
    loop through no MATCH (no lane hands its sums to the warp). Returns
    (count, path)."""
    _, head, back = min(_loops(code, loop_op))
    cost, path = shortest_path(code, head, lambda k: k == back, marker, need)
    return cost, [code[k] for k in path]


def loop_per_unit(code, body_op: str, marker, per: int = 1,
                  through=lambda ins: False):
    """Instructions a unit of a loop's work, where a unit is `per`
    instructions for which marker(instr) holds (one IEEE reciprocal a
    ray-triangle test; four draws a RIS candidate), so that a loop the
    compiler unrolled, or one written to do several units an iteration,
    counts what one unit costs. An iteration is loop_iteration's path that
    also passes every instruction of the loop that is marked or for which
    through(instr) holds (a branch around the work, e.g. around the
    reciprocal of a degenerate triangle's determinant or around a disabled
    lane's target function, is not an iteration's cost). Of the loops
    holding body_op, the one whose iteration does the most units; of
    those, the cheapest a unit. Returns (instructions a unit, units an
    iteration, path)."""
    best = None
    for _, head, back in _loops(code, body_op):
        cost, path = _iteration(code, head, back, body_op,
                                lambda ins: marker(ins) or through(ins))
        units = sum(1 for ins in path if marker(ins)) / per
        if units and (best is None or (units, -cost / units)
                      > (best[1], -best[0])):
            best = (cost / units, units, path)
    if best is None:
        raise ValueError("no loop iteration passes a marked instruction")
    return best


def straight_after(code, after_op: str | None, counted_op: str, need: int):
    """Instructions from the last `after_op` (e.g. the staging barrier,
    BAR.SYNC; None: the function's start) to an EXIT along the shortest
    path that passes exactly `need` instructions whose opcode starts with
    counted_op (e.g. 24 MUFU.EX2 for 24 taps). Returns (count, path)."""
    starts = [0] if after_op is None else [
        i for i, c in enumerate(code) if c.op.startswith(after_op)]
    if not starts:
        raise ValueError(f"no {after_op}")
    start = starts[-1]
    cost, path = shortest_path(
        code, start,
        lambda k: code[k].op.startswith("EXIT") and not code[k].pred,
        counted=lambda ins: ins.op.startswith(counted_op), need=need)
    return cost, [code[k] for k in path]


def around_loop(code, head, back, through=lambda ins: False):
    """Instructions from the function's start to an unpredicated EXIT along
    the shortest path that takes the loop code[head:back + 1] as no
    iteration (a branch into the loop goes on after its backward branch)
    and passes every instruction for which through(instr) holds that lies
    on such a path from the start to an exit (no CALL is followed, so a
    slow path's instructions are not among them): the work around a loop,
    e.g. a tap loop's centre merge, its preheader and the resolve, for a
    loop whose iterations loop_per_unit counts. Returns (count, path)."""
    def exits(k):
        return code[k].op.startswith("EXIT") and not code[k].pred

    succ = [[back + 1 if head <= j <= back else j for j in nxt]
            for nxt in _successors(code)]
    succ = [[j for j in nxt if j < len(code)] for nxt in succ]
    for k in range(head, back + 1):
        succ[k] = []
    reach, todo = {0}, [0]
    while todo:
        for j in succ[todo.pop()]:
            if j not in reach:
                reach.add(j)
                todo.append(j)
    back_to = {k: [] for k in range(len(code))}
    for i, nxt in enumerate(succ):
        for j in nxt:
            back_to[j].append(i)
    coreach = {k for k in reach if exits(k)}
    todo = list(coreach)
    while todo:
        for i in back_to[todo.pop()]:
            if i in reach and i not in coreach:
                coreach.add(i)
                todo.append(i)
    need = sum(1 for k in coreach if through(code[k]))
    cost, path = shortest_path(code, 0, exits, counted=through, need=need,
                               succ=succ)
    return cost, [code[k] for k in path]


def issue_floor_ms(instructions: float, n_sm: int, clock_mhz: float) -> float:
    """Least time the card takes to issue `instructions` warp instructions
    at SCHEDULERS_PER_SM an SM a cycle."""
    return instructions / (SCHEDULERS_PER_SM * n_sm * clock_mhz * 1e3)
