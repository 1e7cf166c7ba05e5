"""K13's walk on K8's lane teams (csrc/g1_win.cu) on the CPU, where it cannot
run: the kernel's table build and window walk over integers, with K8's
formulas compiled from the source in each schedule (test_torch_glv.py: two
products a round for Pair, up to four for Four), a warp of points at a
time as the kernel groups them, held against the recorded JAX
``scalar_mul_windowed`` (``record_slice14.py``) and against the plain
version on warps that mix zero, edge and random scalars."""

import numpy as np
import pytest
import torch

from slice14_fixture import rec, t
from test_torch_glv import GLV_SRC, VarPt, _glv_add, _glv_dbl, _jac
from zkdl_tpu_torch.curve import convert, g1, host_g1
from zkdl_tpu_torch.field import fp, fr, mp
from zkdl_tpu_torch.utils import build

WIN_SRC = " ".join((build.CSRC / "g1_win.cu").read_text().split())
# points a warp in each form (32 lanes over the layout's lanes a point)
FORMS = {"four": ("four", 8), "pair": ("two", 16)}


def _digit(k: int, w: int) -> int:
    return (k >> (4 * w)) & 15


def k13_model(points, scalars, schedule: str, pts_per_warp: int):
    """g1_windowed_kernel over warps of pts_per_warp points (a partial last
    warp as it is: its mirrored lanes repeat point n - 1, which moves no
    window): the warp's highest nonzero window; where there is none the
    result is (0, 0, 0); else each point's table (t[0] = O, t[1] = P, t[j] =
    Glv::add(t[j - 1], P) in the layout's schedule) and the walk from that
    window, four doubles a window below it and Glv::add(out, t[digit])."""
    out = []
    for lo in range(0, len(points), pts_per_warp):
        warp = list(zip(points, scalars))[lo: lo + pts_per_warp]
        start = max(max((w for w in range(64) if _digit(k, w)), default=-1) for _, k in warp)
        for p, k in warp:
            acc = VarPt(0, 0, 0)
            if start >= 0:
                table, e = [VarPt(0, 0, 0), p], p
                for _ in range(2, 16):
                    e = _glv_add(e, p, schedule)
                    table.append(e)
                for w in range(start, -1, -1):
                    if w < start:
                        for _ in range(4):
                            acc = _glv_dbl(acc, schedule)
                    acc = _glv_add(acc, table[_digit(k, w)], schedule)
            out.append(acc)
    return out


def _values(p: g1.G1Jac):
    return [_jac(q) for q in convert.jac_from_device(p)]


@pytest.mark.parametrize("form", sorted(FORMS))
def test_k13_team_walk_gives_the_jax_limbs(form):
    """The recorded set: G, a NUMS candidate, O and (r^2, -r^3, 0) under 0,
    1, r - 1, the cofactor, 2^256 - 1, r and 2^256 - r (the equal-point
    double, p + (-p) to z = 0), then random; every Jacobian coordinate equal
    to JAX's."""
    pts = g1.G1Jac(*(t(f"win/points.{c}") for c in "xyz"))
    schedule, per_warp = FORMS[form]
    got = k13_model(_values(pts), fr.to_ints(rec("win/scalars")), schedule, per_warp)
    assert got == _values(g1.G1Jac(*(t(f"win/out.{c}") for c in "xyz")))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_k13_team_walk_equals_plain_on_mixed_warps(form):
    """Warps that mix scalar 0, 1, 15 (one window), r and random scalars on
    random points, the identity and points of order 3 (off the subgroup,
    their tables reach O): the model gives scalar_mul_windowed_plain's
    limbs, and the group product where the point lies in the subgroup."""
    rng = np.random.default_rng(1501)
    rand = [int.from_bytes(rng.bytes(32), "little") % fr.P_INT for _ in range(12)]
    pts = [host_g1.scalar_mul(host_g1.GENERATOR, k) for k in rand[:6]]
    order3 = [host_g1.JacPoint(0, 2, 1), host_g1.JacPoint(0, fp.P_INT - 2, 1)]
    points = pts + [host_g1.JacPoint(0, 0, 0)] + order3 + pts[:3]
    scalars = [0, 1, 15, fr.P_INT, rand[6], rand[7], rand[8], rand[9], rand[10], 0, 1 << 200, rand[11]]
    dev_pts = convert.jac_to_device(points, "cpu")
    sc = torch.from_numpy(np.stack([mp.limbs_from_int(k, 8) for k in scalars]))
    schedule, per_warp = FORMS[form]
    got = k13_model(_values(dev_pts), scalars, schedule, per_warp)
    assert got == _values(g1.scalar_mul_windowed_plain(dev_pts, sc))
    for p, k, q in zip(points[:6], scalars[:6], got[:6]):
        assert host_g1.to_affine(host_g1.JacPoint(*q)) == host_g1.to_affine(host_g1.scalar_mul(p, k))


def test_k13_kernel_source_matches_the_model():
    """The statements of g1_win.cu that k13_model mirrors, and the shared
    table build and add it calls (g1_team.cuh)."""
    for line in ("start = __reduce_max_sync(FULL, top_window(s) + 1) - 1;", "if (start >= 0) {",
                 "build_table(tm, P, tab, stash, role == 0, (TABLES == SHARED || live) && role == 0);",
                 "for (int w = start; w >= 0; --w) {", "if (w < start) {",
                 "for (int j = 0; j < 4; ++j) out = G::dbl(tm, out);", "out = G::add(tm, out, Shared{e});",
                 "e = tab + digit(k, w) * ENTRY_WORDS;", "const uint32_t* g = tab + digit(k, w) * ENTRY_WORDS;",
                 "return (int)((k[w >> 3] >> (4 * (w & 7))) & 15u);", "Pt out{};"):
        assert line in WIN_SRC, line
    team = " ".join(GLV_SRC.split())
    for line in ("for (int k = 2; k < GLV_ENTRIES; ++k) {", "e = Glv<T>::add(tm, e, Shared{stash}, generic);",
                 "put_entry(dst, Pt{}); put_entry(dst + ENTRY_WORDS, B);"):
        assert line in team, line
