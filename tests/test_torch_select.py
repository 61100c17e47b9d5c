"""Fragment selection (§3.1): DP exactness vs brute force and Z3 — the
reference's `tests/test_select.py` on the port — and the same selections
as the reference's solvers on the same seeded problems."""
import random

import pytest

from repro.core import select as jselect
from repro_torch.core import select as tselect

from repro_torch.core.select import (
    SegmentChoice,
    SelectionProblem,
    replay_cost,
    solve_brute,
    solve_dp,
    solve_greedy,
    solve_z3,
)

try:  # property-based when the wheel is present, seeded sweep otherwise
    import hypothesis.strategies as st
    from hypothesis import given, settings

    @st.composite
    def problems(draw):
        n_seg = draw(st.integers(1, 5))
        n_vid = draw(st.integers(1, 4))
        choices = []
        for _ in range(n_seg):
            k = draw(st.integers(1, n_vid))
            vids = draw(
                st.lists(st.integers(0, n_vid - 1), min_size=k, max_size=k,
                         unique=True)
            )
            chs = [
                SegmentChoice(
                    v,
                    draw(st.floats(0, 100, allow_nan=False)),
                    draw(st.floats(0, 50, allow_nan=False)),
                )
                for v in vids
            ]
            choices.append(chs)
        segs = [(float(i), float(i + 1)) for i in range(n_seg)]
        return SelectionProblem(segs, choices)

    def _problem_cases(max_examples):
        def deco(fn):
            return settings(max_examples=max_examples, deadline=None)(
                given(problems())(fn)
            )
        return deco

except ImportError:
    import random

    def _make_problem(seed):
        r = random.Random(seed)
        n_seg = r.randint(1, 5)
        n_vid = r.randint(1, 4)
        choices = []
        for _ in range(n_seg):
            vids = r.sample(range(n_vid), r.randint(1, n_vid))
            choices.append([
                SegmentChoice(v, r.uniform(0, 100), r.uniform(0, 50))
                for v in vids
            ])
        segs = [(float(i), float(i + 1)) for i in range(n_seg)]
        return SelectionProblem(segs, choices)

    def _problem_cases(max_examples):
        def deco(fn):
            cases = [_make_problem(s) for s in range(min(max_examples, 60))]
            return pytest.mark.parametrize("p", cases)(fn)
        return deco


@_problem_cases(150)
def test_dp_matches_brute_force(p):
    dp = solve_dp(p)
    brute = solve_brute(p)
    assert abs(dp.cost - brute.cost) < 1e-6
    assert abs(replay_cost(p, dp.assignment) - dp.cost) < 1e-6


@_problem_cases(25)
def test_z3_matches_dp(p):
    pytest.importorskip("z3")
    z = solve_z3(p)
    dp = solve_dp(p)
    assert abs(z.cost - dp.cost) < 1e-5  # same optimum (ties may differ)


@_problem_cases(100)
def test_greedy_never_beats_optimal(p):
    g = solve_greedy(p)
    dp = solve_dp(p)
    assert g.cost >= dp.cost - 1e-9


def test_lookback_waived_on_continuation():
    """Choosing the same video across adjacent segments pays c_l once."""
    chs = [
        [SegmentChoice(0, 10.0, 5.0), SegmentChoice(1, 9.0, 50.0)],
        [SegmentChoice(0, 10.0, 5.0), SegmentChoice(1, 9.0, 50.0)],
    ]
    p = SelectionProblem([(0.0, 1.0), (1.0, 2.0)], chs)
    best = solve_dp(p)
    # video 1 is cheaper per-segment but pays a huge entry cost; staying
    # on video 0 (10+5+10) beats entering video 1 (9+50+9)
    assert [chs[i][a].video_idx for i, a in enumerate(best.assignment)] == [0, 0]


def _seeded_problem(S, seed, demands=False):
    """The same problem in the selection module ``S`` of either package,
    from ``seed``: up to 7 segments over up to 5 videos."""
    r = random.Random(seed)
    n_seg, n_vid = r.randint(1, 7), r.randint(1, 5)
    choices = []
    for _ in range(n_seg):
        vids = r.sample(range(n_vid), r.randint(1, n_vid))
        choices.append([
            S.SegmentChoice(v, r.uniform(0, 100), r.uniform(0, 50))
            for v in vids
        ])
    segs = [(float(i), float(i + 1)) for i in range(n_seg)]
    dem = [r.randint(1, 3) for _ in range(n_seg)] if demands else None
    return S.SelectionProblem(segs, choices, dem)


@pytest.mark.parametrize("method", ["dp", "greedy", "brute"])
@pytest.mark.parametrize("seed", range(8))
def test_solvers_match_reference(seed, method):
    for demands in (False, True):
        pj = _seeded_problem(jselect, seed, demands)
        pt = _seeded_problem(tselect, seed, demands)
        a, b = jselect.solve(pj, method), tselect.solve(pt, method)
        assert b.assignment == a.assignment
        assert b.cost == a.cost
        assert tselect.replay_cost(pt, b.assignment) == \
            jselect.replay_cost(pj, a.assignment)


@pytest.mark.parametrize("seed", range(4))
def test_restrict_to_segments_matches_reference(seed):
    pj = _seeded_problem(jselect, seed + 100, demands=True)
    pt = _seeded_problem(tselect, seed + 100, demands=True)
    idx = list(range(len(pj.segments)))[seed % 2:] or [0]
    sj, selj = jselect.restrict_to_segments(pj, jselect.solve_dp(pj), idx)
    st_, selt = tselect.restrict_to_segments(pt, tselect.solve_dp(pt), idx)
    assert st_.segments == sj.segments and st_.demands == sj.demands
    assert (selt.assignment, selt.cost) == (selj.assignment, selj.cost)
