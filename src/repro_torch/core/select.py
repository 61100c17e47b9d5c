"""Fragment selection for reads — §3.1.

Between each pair of *transition points* exactly one physical-video
fragment must be chosen; the objective couples per-segment transcode
cost c_t with a look-back cost c_l that is waived when the previous
segment continued the same physical video (its frames are already in Ω,
the decoded set). The paper solves this with Z3; we ship:

  * ``solve_z3``     — the paper-faithful SMT encoding (z3.Optimize),
  * ``solve_dp``     — beyond-paper exact DP. Look-back only couples
    *adjacent* segments (Ω matters only via "did the previous segment
    pick the same view"), so dp[i][k] = c(i,k) + min_j dp[i-1][j] +
    [j≠k]·c_l(i,k) is exact and O(S·K²) — this removes the SMT solver
    from the read critical path while producing the same optimum
    (asserted against both Z3 and brute force in tests),
  * ``solve_greedy`` — the paper's dependency-naïve baseline (min c_t
    per segment, look-back ignored at choice time but paid at replay),
  * ``solve_brute``  — exponential oracle for tests.

Joint multi-request planning (beyond-paper): ``VSS.read_batch`` builds
ONE problem per logical video covering the *union* of every concurrent
request's segments — each request's endpoints become transition points,
``demands`` records how many requests need each segment, and a fragment
chosen once serves every overlapping request (decode/transcode is paid
once over the union, which is exactly the existing objective on the
bigger problem).  ``restrict_to_segments`` then slices the joint
solution back into one per-request plan.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SegmentChoice:
    """One candidate fragment for one segment."""

    video_idx: int  # identity of the physical video this fragment is cut from
    transcode: float  # c_t for this segment
    lookback: float  # c_l paid iff the previous segment chose a different video


@dataclasses.dataclass
class SelectionProblem:
    segments: List[Tuple[float, float]]  # consecutive [t0, t1) intervals
    choices: List[List[SegmentChoice]]  # per segment, ≥1 each
    # joint batch plans: how many concurrent requests need each segment
    # (None = single-request problem; sharing means a chosen fragment
    # is decoded once however many requests demand the segment, so the
    # solvers' objective is unchanged — demands is bookkeeping for
    # restriction, introspection and tests)
    demands: Optional[List[int]] = None

    def __post_init__(self):
        assert len(self.segments) == len(self.choices)
        assert all(self.choices), "every segment needs at least one choice"
        if self.demands is not None:
            assert len(self.demands) == len(self.segments)
            assert all(d >= 1 for d in self.demands)


@dataclasses.dataclass
class Selection:
    assignment: List[int]  # choice index per segment
    cost: float

    def chosen(self, problem: SelectionProblem) -> List[SegmentChoice]:
        return [problem.choices[i][a] for i, a in enumerate(self.assignment)]


def replay_cost(problem: SelectionProblem, assignment: Sequence[int]) -> float:
    """True cost of an assignment (used to score greedy fairly)."""
    total = 0.0
    prev_video = None
    for i, a in enumerate(assignment):
        ch = problem.choices[i][a]
        total += ch.transcode
        if prev_video != ch.video_idx:
            total += ch.lookback
        prev_video = ch.video_idx
    return total


def restrict_to_segments(
    problem: SelectionProblem,
    selection: Selection,
    indices: Sequence[int],
) -> Tuple[SelectionProblem, Selection]:
    """Slice a solved joint problem down to one request's segments.

    ``indices`` must be increasing positions into ``problem.segments``
    (a request's own interval is a contiguous run of joint segments —
    its endpoints are transition points of the joint problem).  The
    returned selection keeps the joint assignment, so fragments shared
    across requests stay shared; its cost is the standalone replay cost
    of the slice (look-back at the slice boundary is charged even when
    the joint plan continued the same video — the conservative
    per-request view of a shared decode).
    """
    segs = [problem.segments[i] for i in indices]
    choices = [problem.choices[i] for i in indices]
    demands = (
        [problem.demands[i] for i in indices]
        if problem.demands is not None else None
    )
    sub = SelectionProblem(segs, choices, demands)
    assignment = [selection.assignment[i] for i in indices]
    return sub, Selection(assignment, replay_cost(sub, assignment))


def solve_greedy(problem: SelectionProblem) -> Selection:
    assignment = [
        min(range(len(chs)), key=lambda k: chs[k].transcode)
        for chs in problem.choices
    ]
    return Selection(assignment, replay_cost(problem, assignment))


def solve_dp(problem: SelectionProblem) -> Selection:
    n = len(problem.segments)
    # dp[k] = best cost ending with choice k at current segment
    first = problem.choices[0]
    dp = [c.transcode + c.lookback for c in first]
    back: List[List[int]] = []
    for i in range(1, n):
        chs = problem.choices[i]
        prev_chs = problem.choices[i - 1]
        ndp, nback = [], []
        for k, c in enumerate(chs):
            best_j, best = None, float("inf")
            for j, pc in enumerate(prev_chs):
                extra = 0.0 if pc.video_idx == c.video_idx else c.lookback
                v = dp[j] + extra
                if v < best:
                    best, best_j = v, j
            ndp.append(best + c.transcode)
            nback.append(best_j)
        dp = ndp
        back.append(nback)
    k = min(range(len(dp)), key=lambda i_: dp[i_])
    cost = dp[k]
    assignment = [k]
    for i in range(n - 2, -1, -1):
        k = back[i][k]
        assignment.append(k)
    assignment.reverse()
    return Selection(assignment, cost)


def solve_brute(problem: SelectionProblem) -> Selection:
    best, best_assignment = float("inf"), None
    for assignment in itertools.product(
        *[range(len(c)) for c in problem.choices]
    ):
        cost = replay_cost(problem, assignment)
        if cost < best:
            best, best_assignment = cost, list(assignment)
    return Selection(best_assignment, best)


def solve_z3(
    problem: SelectionProblem, timeout_ms: int = 10_000
) -> Selection:
    """Paper-faithful SMT encoding (z3.Optimize, integer-scaled costs)."""
    import z3

    scale = 1_000_000  # costs → integers for the optimizer
    opt = z3.Optimize()
    opt.set("timeout", timeout_ms)
    n = len(problem.segments)
    xs = [z3.Int(f"x_{i}") for i in range(n)]
    terms = []
    for i, chs in enumerate(problem.choices):
        opt.add(xs[i] >= 0, xs[i] < len(chs))
        # transcode term
        t_expr = z3.IntVal(0)
        for k, c in enumerate(chs):
            t_expr = z3.If(xs[i] == k, int(round(c.transcode * scale)), t_expr)
        terms.append(t_expr)
        # look-back term: paid unless the previous segment used the same video
        l_expr = z3.IntVal(0)
        for k, c in enumerate(chs):
            lb = int(round(c.lookback * scale))
            if i == 0:
                l_expr = z3.If(xs[i] == k, lb, l_expr)
            else:
                same_prev = z3.Or(
                    *[
                        xs[i - 1] == j
                        for j, pc in enumerate(problem.choices[i - 1])
                        if pc.video_idx == c.video_idx
                    ]
                )
                l_expr = z3.If(
                    xs[i] == k, z3.If(same_prev, 0, lb), l_expr
                )
        terms.append(l_expr)
    total = z3.Sum(terms)
    opt.minimize(total)
    if opt.check() != z3.sat:
        raise RuntimeError("z3 found no solution for fragment selection")
    model = opt.model()
    assignment = [model[x].as_long() for x in xs]
    return Selection(assignment, replay_cost(problem, assignment))


def solve(
    problem: SelectionProblem, method: str = "dp", **kw
) -> Selection:
    return {
        "dp": solve_dp,
        "z3": solve_z3,
        "greedy": solve_greedy,
        "brute": solve_brute,
    }[method](problem, **kw)
