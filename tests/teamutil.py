"""Pure-Python models of a team of k threads sharing one ray on a 32-lane
warp (``csrc/geom.cuh`` ``team_mask``, ``group_min``, ``next_box``,
``vote``; the sweeps of ``csrc/bvh.cu``, ``csrc/intersect.cu`` and
``csrc/binned.cu``; the id-order walk of ``csrc/resident.cu``'s any hit),
for the CPU tests: a
CUDA kernel cannot run here, so its combine rules are held against the
twins' ``torch.min``/``any`` through these."""

INF = float("inf")
NONE = 2**31 - 1         # csrc/geom.cuh kNone: no row, no box
CHECK = 4                # csrc/bvh.cu and intersect.cu kCheck: rows a thread between votes


def team_mask(lane, k):
    """``csrc/geom.cuh :: team_mask`` for the warp lane ``lane``."""
    return 0xFFFFFFFF if k >= 32 else ((1 << k) - 1) << (lane & ~(k - 1))


def warp_group_min(vals, k):
    """``group_min`` on a 32-lane warp: each lane's ``(t, id)``, the
    butterfly of shuffles over xor offsets below k, each reading only lanes
    in its team's mask. Returns every lane's result."""
    vals = list(vals)
    off = k // 2
    while off > 0:
        nxt = []
        for lane, (t, c) in enumerate(vals):
            src = lane ^ off
            assert team_mask(lane, k) >> src & 1            # the shuffle stays in the team
            ot, oc = vals[src]
            nxt.append((ot, oc) if (ot < t or (ot == t and oc < c)) else (t, c))
        vals = nxt
        off //= 2
    return vals


def team_sweep(ts_lanes, base, k):
    """The closest kernel's leaf sweep for the 32 / k teams of a warp, team
    m sweeping the screened row values ``ts_lanes[m]`` (inf: no hit): thread
    j keeps its strict first minimum of rows j, j + k, ... from (inf, NONE),
    then ``group_min``. Returns every lane's ``(t, row)``."""
    vals = []
    for lane in range(32):
        ts, j = ts_lanes[lane // k], lane % k
        bt, br = INF, NONE
        for r in range(j, len(ts), k):
            if ts[r] < bt:
                bt, br = ts[r], base + r
        vals.append((bt, br))
    return warp_group_min(vals, k)


def team_successor(entries_lanes, last, k):
    """``next_group``/``next_leaf`` for the teams of a warp: thread j scans
    boxes j, j + k, ... for the least entered (entry, id) after its team's
    ``last``, then ``group_min``."""
    vals = []
    for lane in range(32):
        es, j = entries_lanes[lane // k], lane % k
        le, lc = last[lane // k]
        be, bc = INF, NONE
        for c in range(j, len(es), k):
            e = es[c]
            if e < INF and (e > le or (e == le and c > lc)) and e < be:
                be, bc = e, c
        vals.append((be, bc))
    return warp_group_min(vals, k)


def team_vote(hits_lanes, k, check=CHECK):
    """The any hit's split sweep for the 32 / k teams of a warp, team m over
    the rows ``hits_lanes[m]`` (True: the row is hit): thread j tests rows b
    + c k + j for c < ``check`` (none past the end), the team votes after
    each such block of ``check * k`` rows and stops at the first vote that
    finds a hit. Returns per team ``(hit, rows tested)``."""
    out = []
    for m in range(32 // k):
        hits, tested, found = hits_lanes[m], 0, False
        for b in range(0, len(hits), check * k):
            mine = []
            for j in range(k):
                lane_hit = False
                for c in range(check):
                    r = b + c * k + j
                    if not lane_hit and r < len(hits):
                        tested += 1
                        lane_hit = hits[r]
                mine.append(lane_hit)
            if any(mine):
                found = True
                break
        out.append((found, tested))
    return out


def team_ballot(preds, k):
    """``(__ballot_sync(mask, pred) & mask) >> first lane`` on a 32-lane warp
    (``preds[lane]``): each lane's team's bits, bit j its thread j's."""
    ballot = sum(1 << lane for lane in range(32) if preds[lane])
    return [(ballot & team_mask(lane, k)) >> (lane & ~(k - 1)) for lane in range(32)]


def team_in_order(entered_lanes, hits_lanes, k, check=CHECK):
    """``csrc/resident.cu``'s any hit for the 32 / k teams of a warp, team m
    over the boxes ``entered_lanes[m]`` (True: entered) and the rows of each
    box, ``hits_lanes[m][box]`` (True: the row is hit): boxes base .. base +
    k - 1 at a time, thread j testing box base + j, the team's ballot gives
    the entered ones, each swept in ascending id by the vote
    (:func:`team_vote`) up to the first hit. The lanes of a team that has
    finished vote True into the ballot (they are outside every other team's
    mask). Returns per team ``(hit, boxes swept, rows tested)``."""
    teams = 32 // k
    state = [[False, 0, 0] for _ in range(teams)]
    for base in range(0, max(len(e) for e in entered_lanes), k):
        preds = []
        for lane in range(32):
            m, c = lane // k, base + lane % k
            preds.append(state[m][0] or (c < len(entered_lanes[m]) and entered_lanes[m][c]))
        bits = team_ballot(preds, k)
        for m in range(teams):
            b = bits[m * k]
            assert all(x == b for x in bits[m * k:(m + 1) * k])     # the team agrees
            while b and not state[m][0]:
                j = (b & -b).bit_length() - 1                       # __ffs - 1
                b &= b - 1
                hit, tested = team_vote([hits_lanes[m][base + j]] + [[]] * (teams - 1), k,
                                        check)[0]
                state[m] = [hit, state[m][1] + 1, state[m][2] + tested]
    return [tuple(s) for s in state]
