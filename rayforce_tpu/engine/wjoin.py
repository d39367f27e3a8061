"""Device window join (window-join / window-join1).

The reference sorts the right table by keys, finds a per-left-row
window [li, ri] of right rows via per-row binary searches, and reduces
each range (core/join.c:358-489, core/index.c:3287-3347, core/aggr.c
AGGR_ITER INDEX_TYPE_WINDOW). Per-row binary search is a big random
gather, so the device plan replaces every search with ONE event sort
(which of the two is faster on the GPU has not been measured):

  entries = right rows (tie 0) ++ lo events (tie +/-1) ++ hi events
  sort by (key code, time, tie)          -- 3-key lax.sort
  prefix  = cumsum(is_right)             -- position into sorted right
  unsort events -> p_lo, p_hi per left row

Window boundaries then clamp to each key group's [g_fi, g_ti] range
(dense counts via the one-hot matmul + cumsum — no searches), exactly
mirroring ops/join.py window_ranges. Aggregates over the sorted right
columns:

  count/sum/avg  cumsum + boundary diffs (null-skipping, like aggr.py)
  min/max        disjoint sparse table: log2(nr) precomputed levels,
                 one 2-gather lookup per row: ans = op(L[k][li],
                 R[k][ri]) with k = msb(li ^ ri)
  first/last     gather at window endpoints

Everything runs in a handful of device dispatches; result columns are
lazy (DevPending), sized len(left).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..core import types as T
from ..core.obj import Obj, DevPending
from . import device as dev
from . import groupby as G
from .join import _key_ranges, _pack_codes

SUM_TYPE = {T.U8: T.I64, T.I16: T.I64, T.I32: T.I32, T.I64: T.I64,
            T.F64: T.F64}
MINMAX_OK = (T.B8, T.U8, T.I16, T.I32, T.I64, T.DATE, T.TIME,
             T.TIMESTAMP, T.F64)


def _null_mask_t(arr, rtype: int):
    if rtype == T.F64:
        return jnp.isnan(arr)
    nv = T.NULL_BY_TYPE.get(rtype)
    if nv is None:
        return jnp.zeros(arr.shape, bool)
    return arr == np.int64(nv)


# -- disjoint sparse table ----------------------------------------------------

def _lim(dtype, op):
    if dtype == jnp.float64:
        return jnp.float64(np.inf if op == "min" else -np.inf)
    if dtype == jnp.int32:
        return jnp.int32(0x7FFFFFFF if op == "min" else -0x80000000)
    return jnp.int64(G.KEY_MAX if op == "min" else G.I64_MIN)


def _cum_op(x, op):
    """Cumulative min/max along axis 1 (lax.cummin / cummax hang on
    this backend). For big arrays with short axis 1, a lax.scan over
    the columns keeps only O(1) live buffers — the unrolled
    log-doubling variant left ~levels*steps full-size transients
    alive and OOMed the 20M-row window-join build."""
    fn = jnp.minimum if op == "min" else jnp.maximum
    R, B = x.shape
    if R * B > (1 << 22) and B <= 256:
        def step(carry, col):
            c2 = fn(carry, col)
            return c2, c2
        init = jnp.full((R,), _lim(x.dtype, op), x.dtype)
        _, ys = jax.lax.scan(step, init, x.T)
        return ys.T
    m = x
    d = 1
    while d < B:
        shifted = jnp.concatenate(
            [jnp.full((m.shape[0], d), _lim(m.dtype, op), m.dtype),
             m[:, :-d]], axis=1)
        m = fn(m, shifted)
        d *= 2
    return m


_DST_BLOG = 7                 # 128-element base blocks
_DST_B = 1 << _DST_BLOG


def _msb(x):
    k = jnp.zeros_like(x)
    xx = x
    for shift in (16, 8, 4, 2, 1):
        m = xx >= (1 << shift)
        k = k + jnp.where(m, shift, 0)
        xx = jnp.where(m, xx >> shift, xx)
    return k


def _dst_levels(vals, op, n_levels, offset_bits=0):
    """Disjoint-sparse-table levels offset_bits..offset_bits+n_levels-1
    over vals: level j covers blocks of 2^(off+j+1) — left half holds
    suffix-op toward the center, right half prefix-op away. A query
    [l, r] with msb(l ^ r) == off+j is op(lvl[j][l], lvl[j][r])."""
    n = vals.shape[0]
    levels = []
    for j in range(n_levels):
        bs = 1 << (offset_bits + j + 1)
        if bs >= 2 * n and j > 0:
            break
        pn = -(-n // bs) * bs
        v = jnp.concatenate(
            [vals, jnp.full(pn - n, _lim(vals.dtype, op),
                            vals.dtype)]).reshape(-1, bs)
        half = bs // 2
        lsuf = jnp.flip(_cum_op(jnp.flip(v[:, :half], axis=1), op),
                        axis=1)
        rpre = _cum_op(v[:, half:], op)
        levels.append(jnp.concatenate([lsuf, rpre],
                                      axis=1).reshape(-1)[:n])
    return levels


def _dst_build(vals, op):
    """Two-level range-op structure sized for 20M+ rows (a flat
    disjoint sparse table would need log2(n) full copies — 25 GB at
    20M f64). Mini-DST handles ranges inside one 128-block; block
    prefix/suffix + a summary DST handle the rest."""
    n = vals.shape[0]
    pn = -(-n // _DST_B) * _DST_B
    v = jnp.concatenate(
        [vals, jnp.full(pn - n, _lim(vals.dtype, op),
                        vals.dtype)]).reshape(-1, _DST_B)
    prefix = _cum_op(v, op).reshape(-1)[:n]
    suffix = jnp.flip(_cum_op(jnp.flip(v, axis=1), op),
                      axis=1).reshape(-1)[:n]
    fn = jnp.minimum if op == "min" else jnp.maximum
    bsum = v.min(axis=1) if op == "min" else v.max(axis=1)
    mini = _dst_levels(vals, op, _DST_BLOG)
    bdst = _dst_levels(bsum, op, 40)   # summaries: log2(nb) levels
    return {"mini": mini, "prefix": prefix, "suffix": suffix,
            "bsum": bsum, "bdst": bdst, "fn": fn}


def _dst_query(vals, tab, op, li, ri):
    """Range op over [li, ri] per row; li <= ri (caller masks)."""
    fn = tab["fn"]
    same = li == ri
    k = _msb((li ^ ri).astype(jnp.int32))
    base = vals[li]

    # same 128-block: mini DST level k, looked up with flat 1D
    # gathers over the concatenated levels
    n = vals.shape[0]
    if tab["mini"]:
        mflat = jnp.concatenate(tab["mini"])
        mk = jnp.clip(k, 0, len(tab["mini"]) - 1)
        off = mk.astype(jnp.int64) * n
        small = fn(mflat[off + li], mflat[off + ri])
    else:
        small = base

    # cross-block: suffix[li] ++ block summaries strictly between
    # ++ prefix[ri]
    bli = li >> _DST_BLOG
    bri = ri >> _DST_BLOG
    edge = fn(tab["suffix"][li], tab["prefix"][ri])
    lo_b = bli + 1
    hi_b = bri - 1
    has_mid = lo_b <= hi_b
    s_lo = jnp.clip(lo_b, 0, tab["bsum"].shape[0] - 1)
    s_hi = jnp.clip(hi_b, 0, tab["bsum"].shape[0] - 1)
    if tab["bdst"]:
        nb = tab["bsum"].shape[0]
        bk = _msb((s_lo ^ s_hi).astype(jnp.int32))
        bflat = jnp.concatenate(tab["bdst"])
        bkk = jnp.clip(bk, 0, len(tab["bdst"]) - 1)
        boff = bkk.astype(jnp.int64) * nb
        mid = fn(bflat[boff + s_lo], bflat[boff + s_hi])
        mid = jnp.where(s_lo == s_hi, tab["bsum"][s_lo], mid)
    else:
        mid = tab["bsum"][s_lo]
    ident = _lim(vals.dtype, op)
    mid = jnp.where(has_mid, mid, ident)
    cross = fn(edge, mid)

    out = jnp.where(k < _DST_BLOG, small, cross)
    return jnp.where(same, base, out)


# -- jitted phase kernels -----------------------------------------------------

_bound_cache: dict = {}


def _boundaries_fn(nl, nr, n_codes, tp, n_pay, pay_dtypes,
                   pack=None):
    """Aggregate input columns ride this sort as payloads instead of
    being gathered by the sorted row order afterwards.

    `pack` = (tmin, tbits) when (code, biased time) fit one i64 sort
    key: unstable single-key sorts replace the stable multi-key ones;
    None keeps the stable multi-key path (e.g. full-range ns
    timestamps)."""
    key = (nl, nr, n_codes, tp, n_pay, pay_dtypes, pack)
    if key in _bound_cache:
        return _bound_cache[key]

    def fn(lcode, rcode, rt, lo, hi, *pays):
        return _boundary_core(lcode, rcode, rt, lo, hi, pays,
                              n_codes, tp, pack)

    f = jax.jit(fn)
    _bound_cache[key] = f
    return f


def _boundary_core(lcode, rcode, rt, lo, hi, pays, n_codes, tp, pack,
                   lvalid=None):
    """Event-sort window boundaries (the body shared by the jitted
    single-chip entry and the per-chip stage of the mesh kernel).
    Shapes come from the arrays; `lvalid` masks received-buffer pad
    rows in mesh mode (their ok goes False). Trash RIGHT rows must
    carry rcode == n_codes (they count into the trash bucket and sort
    after every real code)."""
    nl = lcode.shape[0]
    nr = rcode.shape[0]
    riota = jnp.arange(nr, dtype=jnp.int32)
    if pack is not None:
        tmin, tbits = pack
        # riota rides as a SECOND KEY, not a payload: rows tied on
        # (code, time) must keep original order — the reference's
        # right-table xasc is a stable LSD radix sort (core/sort.c),
        # and first/last gather the boundary row of the tie run. An
        # unstable 1-key sort returned an arbitrary tied row (caught
        # by the seed-8 window-join fuzz: last over a column whose
        # tied boundary row was null).
        sorted_r = jax.lax.sort(
            [(rcode << tbits) | (rt - tmin), riota] + list(pays),
            num_keys=2, is_stable=False)
        spk, sr = sorted_r[0], sorted_r[1]
        src = spk >> tbits
        srt = (spk & ((np.int64(1) << tbits) - 1)) + tmin
        spays = sorted_r[2:]
    else:
        sorted_r = jax.lax.sort([rcode, rt, riota] + list(pays),
                                num_keys=2, is_stable=True)
        src, srt, sr = sorted_r[0], sorted_r[1], sorted_r[2]
        spays = sorted_r[3:]
    # per-code counts/starts by searchsorted over the ALREADY-SORTED
    # right keys: n_codes+1 probes x log2(nr) gathers instead of a
    # one-hot matmul scan over all rows.
    # starts_ext[c] = rows with code < c; the n_codes probe lands on
    # the first trash row (trash sorts last), so cnt excludes trash.
    probes = jnp.arange(n_codes + 1, dtype=jnp.int64)
    if pack is not None:
        tmin_, tbits_ = pack
        starts_ext = jnp.searchsorted(spk, probes << tbits_,
                                      side="left").astype(jnp.int64)
    else:
        starts_ext = jnp.searchsorted(src, probes,
                                      side="left").astype(jnp.int64)
    cnt = starts_ext[1:] - starts_ext[:-1]
    starts = starts_ext[:-1]
    lc32 = jnp.clip(lcode, 0, n_codes - 1).astype(jnp.int32)
    g_cnt = cnt[lc32]
    g_fi = starts[lc32]
    g_ti = g_fi + g_cnt - 1
    has_group = g_cnt > 0

    lo_tie = jnp.int32(1 if tp == 0 else -1)
    codes_all = jnp.concatenate([rcode, lcode, lcode])
    times_all = jnp.concatenate([rt, lo, hi])
    ties = jnp.concatenate([jnp.zeros(nr, jnp.int32),
                            jnp.full(nl, lo_tie, jnp.int32),
                            jnp.ones(nl, jnp.int32)])
    eidx = jnp.concatenate([jnp.full(nr, -1, jnp.int32),
                            jnp.arange(2 * nl, dtype=jnp.int32)])
    if pack is not None:
        tmin, tbits = pack
        ekey = (codes_all << (tbits + 2)) | \
            ((times_all - tmin) << 2) | \
            (ties + 1).astype(jnp.int64)
        _ek, seidx = jax.lax.sort([ekey, eidx], num_keys=1,
                                  is_stable=False)
    else:
        _sc, _st2, _tt, seidx = jax.lax.sort(
            [codes_all, times_all, ties, eidx], num_keys=3,
            is_stable=True)
    is_right = seidx < 0
    prefix = jnp.cumsum(is_right.astype(jnp.int64))
    # unsort events: pack (event id, prefix) into one key — the
    # prefix fits below bit 36 (nr <= 2^36)
    key2 = jnp.where(is_right, jnp.int64(2 * nl),
                     seidx.astype(jnp.int64))
    upk = (key2 << 36) | prefix
    upks = jax.lax.sort([upk], num_keys=1, is_stable=False)[0]
    pref_by_event = upks & ((np.int64(1) << 36) - 1)
    p_lo = pref_by_event[:nl]
    p_hi = pref_by_event[nl:2 * nl]
    p_lo_r = p_lo - 1
    p_lo_l = p_lo
    p_hi_r = p_hi - 1

    if tp == 0:
        li = jnp.where(p_lo_r < g_fi, g_fi,
                       jnp.minimum(p_lo_r, g_ti))
    else:
        li = jnp.where((p_lo_l > g_ti) | (p_lo_l < g_fi), g_fi,
                       jnp.maximum(p_lo_l, g_fi))
    ri = jnp.where(p_hi_r < g_fi, g_fi, jnp.minimum(p_hi_r, g_ti))
    safe_li = jnp.clip(li, 0, max(nr - 1, 0)).astype(jnp.int32)
    safe_ri = jnp.clip(ri, 0, max(nr - 1, 0)).astype(jnp.int32)
    # window emptiness from the event prefixes alone, with no per-row
    # time probes srt[li] / srt[ri]:
    # - tp==1 (closed [lo, hi]): p_hi - p_lo = the group's right
    #   rows inside the window (both events sit in the group's
    #   sorted span; tie order places boundary rows correctly);
    # - tp==0 (prevailing window, li reaches back to the last row
    #   at-or-before lo): nonempty iff the group has ANY row
    #   at-or-before hi, i.e. p_hi exceeds the group's base
    #   prefix g_fi.
    if tp == 1:
        valid = has_group & (p_hi - p_lo > 0)
    else:
        valid = has_group & (p_hi - g_fi > 0)
    ok = valid & (li <= ri)
    if lvalid is not None:
        ok = ok & lvalid
    return (sr, safe_li, safe_ri, ok) + tuple(spays)


@jax.jit
def _k_count(li, ri, ok):
    return jnp.where(ok, (ri - li + 1).astype(jnp.int64), 0)


@partial(jax.jit, static_argnames=("rtype", "last"))
def _k_first_last(sv, li, ri, ok, rtype, last):
    """Window first/last SKIP NULLS to the nearest non-null row inside
    [li, ri] (reference first-non-null-slot semantics, aggr.c:394-438;
    oracle-pinned by the wjoin_nulls goldens). Nearest-non-null
    position arrays come from one associative min/max scan over the
    sorted right order."""
    n = sv.shape[0]
    nt = rtype if rtype != T.ENUM else T.SYMBOL
    nn = _null_mask_t(sv, nt)
    iota = jnp.arange(n, dtype=jnp.int32)
    if last:
        prv = jnp.where(nn, jnp.int32(-1), iota)
        prv = jax.lax.associative_scan(jnp.maximum, prv)
        pos = prv[ri]
        okfl = ok & (pos >= li)
    else:
        nxt = jnp.where(nn, jnp.int32(n), iota)
        nxt = jax.lax.associative_scan(jnp.minimum, nxt, reverse=True)
        pos = nxt[li]
        okfl = ok & (pos <= ri)
    g = sv[jnp.clip(pos, 0, max(n - 1, 0))]
    if rtype == T.F64:
        return jnp.where(okfl, g, jnp.float64(np.nan))
    nv = T.NULL_BY_TYPE.get(nt)
    if nv is None:
        return jnp.where(okfl, g, 0)
    return jnp.where(okfl, g, np.int64(nv).astype(g.dtype))


@partial(jax.jit, static_argnames=("rtype", "want_avg"))
def _k_sum_avg(sv, li, ri, ok, rtype, want_avg):
    nn = _null_mask_t(sv, rtype)
    vz = jnp.where(nn, 0, sv).astype(jnp.float64)
    cs = jnp.concatenate([jnp.zeros(1, jnp.float64), jnp.cumsum(vz)])
    s = cs[ri + 1] - cs[li]
    cn = jnp.concatenate([jnp.zeros(1, jnp.float64),
                          jnp.cumsum(nn.astype(jnp.float64))])
    n_null = cn[ri + 1] - cn[li]
    if not want_avg:
        # window sum PROPAGATES nulls (ADD accumulators, aggr.c;
        # oracle-pinned: any null in the window -> typed null), and an
        # EMPTY window sums to typed NULL, not 0 (reference Null
        # macro; wjoin_nulls goldens)
        if rtype == T.F64:
            s = jnp.where(n_null > 0, jnp.float64(np.nan), s)
            return jnp.where(ok, s, jnp.float64(np.nan))
        nv = np.int64(T.NULL_BY_TYPE.get(SUM_TYPE.get(rtype, T.I64),
                                         T.NULL_I64))
        si = jnp.where(n_null > 0, nv, s.astype(jnp.int64))
        return jnp.where(ok, si, nv)
    c = (ri + 1 - li).astype(jnp.float64) - n_null
    a = jnp.where(c > 0, s / c, jnp.float64(np.nan))
    return jnp.where(ok & (c > 0), a, jnp.float64(np.nan))


@partial(jax.jit, static_argnames=("rtype",))
def _k_dev(sv, li, ri, ok, rtype):
    """Window DEV via shifted cumulative moments over the sorted right
    column (reference aggr.c:2806 aggr_map_dev_window). The in-kernel
    non-null mean shift conditions E[x'^2] - E[x']^2 to fmt precision
    (|x'| <= data span). Nulls skip; empty windows yield 0Nf."""
    nn = _null_mask_t(sv, rtype)
    v = sv.astype(jnp.float64)
    vz = jnp.where(nn, 0.0, v)
    cnt_all = jnp.maximum((~nn).sum().astype(jnp.float64), 1.0)
    c0 = vz.sum() / cnt_all
    x = jnp.where(nn, 0.0, v - c0)
    z = jnp.zeros(1, jnp.float64)
    cs = jnp.concatenate([z, jnp.cumsum(x)])
    cs2 = jnp.concatenate([z, jnp.cumsum(x * x)])
    cc = jnp.concatenate([z, jnp.cumsum((~nn).astype(jnp.float64))])
    s = cs[ri + 1] - cs[li]
    s2 = cs2[ri + 1] - cs2[li]
    c = cc[ri + 1] - cc[li]
    safe = jnp.where(c > 0, c, 1.0)
    mean = s / safe
    var = s2 / safe - mean * mean
    # noise floor: the cumsum-difference cancellation error is bounded
    # by eps * (global second moment); a constant/single-value window's
    # true variance (0) otherwise surfaces as ~1e-5 garbage that fmt
    # prints in scientific notation while the host path prints 0.00
    floor = (x * x).sum() * np.float64(2.0 ** -48) / safe
    var = jnp.where(var <= floor, 0.0, var)
    outv = jnp.sqrt(jnp.maximum(var, 0.0))
    return jnp.where(ok & (c > 0), outv, jnp.float64(np.nan))


# min/max run the range structure over i32 VALUE RANKS (two extra
# sorts) and look the winning value up at the very end, so the sparse
# table holds 4-byte ranks instead of 8-byte values.

@jax.jit
def _k_rank_vals_nf(sv):
    """(ranks, sorted values) of a NULL-FREE column in ONE executable,
    shared by the min and the max aggregate over the same column (the
    rank permutation is direction-independent once there are no nulls
    to re-map). The rank sort's key output IS the sorted-value table,
    so computing them together saves a whole extra sort of the column."""
    n = sv.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    vo, order = jax.lax.sort([sv, iota], num_keys=1, is_stable=True)
    _o, rank = jax.lax.sort([order, iota], num_keys=1, is_stable=True)
    return rank, vo


@partial(jax.jit, static_argnames=("rtype",))
def _k_minmax_pair_nf(sv, li, ri, ok, rtype):
    """Window min AND max of a null-free column in one executable:
    the rank sorts and the sorted-value table are computed once and the
    two sparse tables share the fused program."""
    n = sv.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    _k, order = jax.lax.sort([sv, iota], num_keys=1, is_stable=True)
    _o, rank = jax.lax.sort([order, iota], num_keys=1, is_stable=True)
    vo = jax.lax.sort([sv], num_keys=1)[0]
    outs = []
    for op in ("min", "max"):
        red = _minmax_from_rank_impl(rank, li, ri, op)
        outs.append(_k_value_from_sorted(vo, red, ok, rtype, op))
    return tuple(outs)


_FLAT_MAX = 600_000_000   # flat table cells cap (~2.4 GB of i32)


def _flat_st_minmax(rank, li, ri, op):
    """Classic sparse table over i32 ranks: K=log2(n) precomputed
    levels (L[k][i] = op over [i, i+2^k)), ONE flat concat, and a
    2-gather query op(L[k][li], L[k][ri-2^k+1]) with k = msb(len).
    ~8 i32 gathers of the two-level disjoint structure collapse to 2;
    the i32 rank payload keeps the table at n*log2(n)*4 bytes."""
    n = rank.shape[0]
    K = max((n - 1).bit_length(), 1)
    fn = jnp.minimum if op == "min" else jnp.maximum
    ident = _lim(rank.dtype, op)
    levels = [rank]
    cur = rank
    for k in range(1, K):
        sh = 1 << (k - 1)
        if sh >= n:
            break
        shifted = jnp.concatenate(
            [cur[sh:], jnp.full(sh, ident, cur.dtype)])
        cur = fn(cur, shifted)
        levels.append(cur)
    flat = jnp.concatenate(levels)
    span = (ri - li + 1).astype(jnp.int32)
    k = jnp.clip(_msb(jnp.maximum(span, 1)), 0, len(levels) - 1)
    off = k.astype(jnp.int64) * n
    a = flat[jnp.clip(off + li, 0, flat.shape[0] - 1)]
    blen = jnp.left_shift(jnp.int64(1), k.astype(jnp.int64))
    b = flat[jnp.clip(off + ri + 1 - blen, 0, flat.shape[0] - 1)]
    return fn(a, b)


def _minmax_from_rank_impl(rank, li, ri, op):
    n = int(rank.shape[0])
    K = max((n - 1).bit_length(), 1)
    if n * K <= _FLAT_MAX:
        return _flat_st_minmax(rank, li, ri, op)
    tab = _dst_build(rank, op)
    return _dst_query(rank, tab, op, li, ri)


@partial(jax.jit, static_argnames=("op",))
def _k_minmax_from_rank(rank, li, ri, op):
    return _minmax_from_rank_impl(rank, li, ri, op)


@partial(jax.jit, static_argnames=("rtype", "op"))
def _k_value_from_sorted(vo, red, ok, rtype, op):
    n = vo.shape[0]
    safe = jnp.clip(red, 0, n - 1)
    out = vo[safe]
    if rtype == T.F64:
        return jnp.where(ok, out, jnp.float64(np.nan))
    nv2 = np.int64(T.NULL_BY_TYPE.get(rtype, T.NULL_I64))
    return jnp.where(ok, out, nv2.astype(out.dtype))


@partial(jax.jit, static_argnames=("rtype", "op"))
def _k_minmax_rank(sv, li, ri, ok, rtype, op):
    n = sv.shape[0]
    is_min = op == "min"
    if rtype == T.F64:
        key = jnp.where(jnp.isnan(sv), _lim(jnp.float64, op), sv)
    else:
        key = sv.astype(jnp.int64)
        nv = T.NULL_BY_TYPE.get(rtype)
        if nv is not None:
            key = jnp.where(key == np.int64(nv),
                            _lim(jnp.int64, op), key)
    iota = jnp.arange(n, dtype=jnp.int32)
    _k, order = jax.lax.sort([key, iota], num_keys=1, is_stable=True)
    _o, rank = jax.lax.sort([order, iota], num_keys=1, is_stable=True)
    return _minmax_from_rank_impl(rank, li, ri, op)


@partial(jax.jit, static_argnames=("rtype", "op"))
def _k_minmax_value(sv, red, li, ri, ok, rtype, op):
    """Resolve winning ranks to values (the one padded 64-bit gather,
    isolated in its own executable so the transient fits).

    Reference all-null-window semantics (oracle-probed with i32 TIME
    columns; aggr.c AGGR_ITER INDEX_TYPE_WINDOW with min-init INF /
    max-init NULL, ops.h:180-190): an EMPTY window is typed NULL for
    both ops; a NON-EMPTY ALL-NULL window is typed INF for min and
    typed NULL for max. For f64 max the -inf init is ambiguous against
    real -inf data, so emptiness there comes from an exact per-window
    non-null count."""
    n = sv.shape[0]
    is_min = op == "min"
    if rtype == T.F64:
        key = jnp.where(jnp.isnan(sv), _lim(jnp.float64, op), sv)
    else:
        key = sv.astype(jnp.int64)
        nv = T.NULL_BY_TYPE.get(rtype)
        if nv is not None:
            key = jnp.where(key == np.int64(nv),
                            _lim(jnp.int64, op), key)
    vo = jax.lax.sort([key], num_keys=1)[0]
    safe = jnp.clip(red, 0, n - 1)
    out = vo[safe]
    if rtype == T.F64:
        if is_min:
            # all-null windows surface naturally as +inf (min init)
            return jnp.where(ok, out, jnp.float64(np.nan))
        nn = _null_mask_t(sv, rtype)
        cn = jnp.concatenate([jnp.zeros(1, jnp.int64),
                              jnp.cumsum((~nn).astype(jnp.int64))])
        n_valid = cn[ri + 1] - cn[li]
        return jnp.where(ok & (n_valid > 0), out,
                         jnp.float64(np.nan))
    nv2 = np.int64(T.NULL_BY_TYPE.get(rtype, T.NULL_I64))
    if is_min:
        inf_t = np.int64(T.INF_BY_TYPE.get(rtype, T.INF_I64))
        out = jnp.where(out == G.KEY_MAX, inf_t, out)
        return jnp.where(ok, out, nv2)
    # int max: the I64_MIN all-null sentinel cannot collide with real
    # data (it IS the i64 null; narrower types never reach it)
    return jnp.where(ok & (out != G.I64_MIN), out, nv2)


@jax.jit
def _k_bounds4(lo, hi):
    return jnp.stack([lo.min(), lo.max(), hi.min(), hi.max()])


# -- mesh (multi-chip) window join --------------------------------------------

_mesh_wj_cache: dict = {}
last_profile: dict = {}   # {"engine": "dist-wjoin" | "device-wjoin"}


def _mesh_wjoin_kernel(mesh, n_codes, tp, cap_l, cap_r, cap_b,
                       nl_total, aggs_spec, pay_dtypes):
    """Distributed window join: both tables exchange by key-code
    ownership (code % n_dev — the dist_asof_probe pattern,
    parallel/dist.py), each chip runs the event-sort boundary core +
    range aggregates over its complete key partition (windows never
    cross keys, so per-chip results are exact), and each result lane
    routes BACK to the chip owning its left row (global row id //
    shard) through a second capacity-bounded all_to_all — outputs come
    out row-sharded in the left table's original order with NO
    replicating all_gather (VERDICT r03 item 4: the old return path
    gathered every lane over the full exchange capacity, ~4x the rows;
    the reference's scatter moves ids, not rows,
    core/index.c:2556-2729). Code and row-id lanes ride as i32. The
    reference's single biggest published win (window join,
    core/join.c:358-489, index.c:3287-3347) distributed over the mesh.

    aggs_spec: tuple of (op, lane_idx | None, rtype) over the deduped
    right payload lanes. Returns (ovf_l[1], ovf_r[1], ovf_b[1]
    replicated, *agg_lanes[nl_total] row-sharded); nonzero overflow
    means a (src, dst) bucket exceeded its capacity — the caller
    retries with it doubled (nothing drops silently)."""
    from ..parallel import dist
    from jax.sharding import PartitionSpec as P
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    n_local = -(-n_codes // n_dev)
    n_pay = len(pay_dtypes)

    def payfill(dt):
        return np.float64(np.nan) if np.dtype(dt) == np.float64 \
            else np.int64(0)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=tuple(P(axis) for _ in range(5 + n_pay)),
             out_specs=tuple([P(), P(), P()] +
                             [P(axis)] * len(aggs_spec)),
             check_vma=False)
    def kernel(lcode, lo, hi, rcode, rts, *rpays):
        nl = lcode.shape[0]
        nr = rcode.shape[0]
        me = jax.lax.axis_index(axis).astype(jnp.int64)
        lrow = me * nl + jnp.arange(nl, dtype=jnp.int64)
        lvalid_in = lrow < nl_total

        def route(dest_code, valid, lanes, cap):
            n = dest_code.shape[0]
            dst = jnp.where(valid,
                            (dest_code % n_dev).astype(jnp.int32),
                            np.int32(n_dev))
            order = jnp.argsort(dst, stable=True)
            ds = dst[order]
            live = ds < n_dev
            within = jnp.arange(n, dtype=jnp.int32) - \
                jnp.searchsorted(ds, ds,
                                 side="left").astype(jnp.int32)
            ok_ = live & (within < cap)
            ovf = jax.lax.psum(
                (live & ~ok_).sum().astype(jnp.int64), axis)
            slot = jnp.where(ok_, ds * cap + within,
                             np.int32(n_dev) * cap)
            outs = []
            for lane, fill in lanes:
                ls = lane[order]
                buf = jnp.full((n_dev * cap,), fill, dtype=ls.dtype)
                buf = buf.at[slot].set(ls, mode="drop")
                outs.append(jax.lax.all_to_all(
                    buf.reshape(n_dev, cap), axis, 0, 0,
                    tiled=False).reshape(-1))
            return ovf, outs

        # codes and global row ids ride the wire as i32 (n_codes and
        # row counts are < 2^31); timestamps stay i64
        ovf_l, louts = route(
            lcode, lvalid_in,
            [(lcode.astype(jnp.int32), np.int32(-1)),
             (lo, np.int64(0)), (hi, np.int64(0)),
             (lrow.astype(jnp.int32), np.int32(-1))], cap_l)
        xlcode, xlo, xhi, xlrow = louts
        ovf_r, routs = route(
            rcode, rcode >= 0,
            [(rcode.astype(jnp.int32), np.int32(-1)),
             (rts, np.int64(0))] +
            [(pv, payfill(dt)) for pv, dt in zip(rpays, pay_dtypes)],
            cap_r)
        xrcode, xrts = routs[0], routs[1]
        xpays = routs[2:]

        # local dense code space: codes owned by this chip are exactly
        # {c : c % n_dev == me}, remapped densely by c // n_dev
        lval = xlrow >= 0
        llocal = jnp.where(lval, xlcode.astype(jnp.int64) // n_dev,
                           jnp.int64(n_local))
        rlocal = jnp.where(xrcode >= 0,
                           xrcode.astype(jnp.int64) // n_dev,
                           jnp.int64(n_local))
        bres = _boundary_core(llocal, rlocal, xrts, xlo, xhi,
                              tuple(xpays), n_local, tp, None,
                              lvalid=lval)
        _sr, li, ri, ok = bres[0], bres[1], bres[2], bres[3]
        spays = bres[4:]

        lanes_out = []
        for op, lane, rtype in aggs_spec:
            sv = spays[lane] if lane is not None else None
            if op == "count":
                lanes_out.append(_k_count(li, ri, ok))
            elif op in ("first", "last"):
                lanes_out.append(_k_first_last(sv, li, ri, ok, rtype,
                                               op == "last"))
            elif op in ("sum", "avg"):
                lanes_out.append(_k_sum_avg(sv, li, ri, ok, rtype,
                                            op == "avg"))
            elif op == "dev":
                lanes_out.append(_k_dev(sv, li, ri, ok, rtype))
            else:           # min / max via value ranks + range table
                red = _k_minmax_rank(sv, li, ri, ok, rtype, op)
                lanes_out.append(_k_minmax_value(sv, red, li, ri, ok,
                                                 rtype, op))

        # ---- route results back to their left row's owner chip -------
        # dst = global row id // shard size; offset within the shard
        # is the exact output slot, so arrivals place with one pair
        # sort and the output stays row-sharded — zero all_gather
        mslots = xlrow.shape[0]
        me32 = me.astype(jnp.int32)
        dstb_all = jnp.where(lval, xlrow // np.int32(nl),
                             np.int32(n_dev))
        offb = jnp.where(lval, xlrow % np.int32(nl), np.int32(-1))
        # DIAGONAL BYPASS: rows whose owner is this chip skip the
        # exchange and merge locally (they are ~1/n_dev of the slots,
        # so cap_b only needs to cover the off-chip remainder)
        is_local_b = lval & (dstb_all == me32)
        dstb = jnp.where(is_local_b, np.int32(n_dev), dstb_all)
        order_b = jnp.argsort(dstb, stable=True)
        dsb = dstb[order_b]
        live_b = dsb < n_dev
        within_b = jnp.arange(mslots, dtype=jnp.int32) - \
            jnp.searchsorted(dsb, dsb, side="left").astype(jnp.int32)
        ok_b = live_b & (within_b < cap_b)
        ovf_b = jax.lax.psum(
            (live_b & ~ok_b).sum().astype(jnp.int64), axis)
        slot_b = jnp.where(ok_b, dsb * cap_b + within_b,
                           np.int32(n_dev) * cap_b)

        def exch_b(lane, fill):
            ls = lane[order_b]
            buf = jnp.full((n_dev * cap_b,), fill, dtype=ls.dtype)
            buf = buf.at[slot_b].set(ls, mode="drop")
            return jax.lax.all_to_all(
                buf.reshape(n_dev, cap_b), axis, 0, 0,
                tiled=False).reshape(-1)

        xoff = exch_b(offb, np.int32(-1))
        xlanes = [exch_b(v, np.nan if v.dtype == jnp.float64 else 0)
                  for v in lanes_out]
        # merge arrivals with the local (bypassed) rows by output slot
        loffk = jnp.where(is_local_b, offb, np.int32(2**31 - 1))
        offk = jnp.concatenate(
            [jnp.where(xoff >= 0, xoff, np.int32(2**31 - 1)), loffk])
        xlanes = [jnp.concatenate([xv, lv])
                  for xv, lv in zip(xlanes, lanes_out)]
        pad_b = max(nl - int(offk.shape[0]), 0)
        if pad_b:
            offk = jnp.concatenate(
                [offk, jnp.full(pad_b, np.int32(2**31 - 1))])
            xlanes = [jnp.concatenate(
                [v, jnp.zeros(pad_b, v.dtype)]) for v in xlanes]
        placed = jax.lax.sort([offk] + xlanes, num_keys=1,
                              is_stable=False)
        return tuple([jnp.reshape(ovf_l, (1,)),
                      jnp.reshape(ovf_r, (1,)),
                      jnp.reshape(ovf_b, (1,))] +
                     [v[:nl] for v in placed[1:]])

    lane_bytes = 8 * len(aggs_spec)
    _a2a = n_dev * (n_dev - 1) * \
        ((4 + 8 + 8 + 4) * cap_l + (4 + 8 + 8 * n_pay) * cap_r)
    _a2ab = n_dev * (n_dev - 1) * cap_b * (4 + lane_bytes)
    return dist._counted(jax.jit(kernel), lambda *a: _a2a + _a2ab)


def _mesh_window_join(m, lcode, rcode, rt_d, lo_d, hi_d, nl, nr,
                      n_codes, tp, aggs, pays, pay_slot):
    """Mesh glue: shard the prepared code/time/payload lanes, run the
    distributed kernel with capacity retry, wrap replicated result
    lanes as typed columns. Returns {out_sid: Obj} or None."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    axis = m.axis_names[0]
    n_dev = m.shape[axis]
    n_local = -(-n_codes // n_dev)
    if n_local > dev._cfg["dense_max"]:
        return None
    # global row ids ride the exchange as i32 (kernel comment at
    # _mesh_wjoin_kernel); past 2^31 padded rows they would wrap and
    # corrupt dst/offset routing — fall back instead (ADVICE r04).
    if n_dev * ((nl + n_dev - 1) // n_dev) >= 2**31 or \
            n_dev * ((nr + n_dev - 1) // n_dev) >= 2**31:
        return None

    def shardpad(a, fill):
        pad = (-int(a.shape[0])) % n_dev
        if pad:
            a = jnp.concatenate(
                [a, jnp.full(pad, fill, dtype=a.dtype)])
        return jax.device_put(a, NamedSharding(m, P(axis)))

    aggs_spec = []
    for _sid, name, rcol, rtype in aggs:
        lane = pay_slot[id(rcol)] if name != "count" else None
        aggs_spec.append((name, lane, rtype))
    aggs_spec = tuple(aggs_spec)
    pay_dtypes = tuple(str(p.dtype) for p in pays)

    lc = shardpad(lcode, np.int64(-1))
    lo_s = shardpad(lo_d, np.int64(0))
    hi_s = shardpad(hi_d, np.int64(0))
    rc = shardpad(rcode, np.int64(-1))
    rt_s = shardpad(rt_d, np.int64(0))
    pay_s = [shardpad(p, np.nan if p.dtype == jnp.float64 else 0)
             for p in pays]

    rows_l = (nl + n_dev - 1) // n_dev
    rows_r = (nr + n_dev - 1) // n_dev
    caps = [max(2 * rows_l // n_dev, 64),
            max(2 * rows_r // n_dev, 64),
            max(2 * rows_l // n_dev, 64)]
    while True:
        key = (id(m), n_codes, tp, caps[0], caps[1], caps[2], nl,
               aggs_spec, pay_dtypes, rows_l, rows_r)
        f = _mesh_wj_cache.get(key)
        if f is None:
            f = _mesh_wjoin_kernel(m, n_codes, tp, caps[0], caps[1],
                                   caps[2], nl, aggs_spec,
                                   pay_dtypes)
            _mesh_wj_cache[key] = f
        outs = f(lc, lo_s, hi_s, rc, rt_s, *pay_s)
        ovf_l = int(np.asarray(outs[0])[0])
        ovf_r = int(np.asarray(outs[1])[0])
        ovf_b = int(np.asarray(outs[2])[0])
        if ovf_l == 0 and ovf_r == 0 and ovf_b == 0:
            break
        if ovf_l:
            caps[0] *= 2
        if ovf_r:
            caps[1] *= 2
        if ovf_b:
            caps[2] = min(caps[2] * 2, rows_l)

    from ..core.obj import DevPendingSliced
    out = {}
    for (out_sid, name, rcol, rtype), lane in zip(aggs,
                                                  outs[3:]):
        if name == "count":
            ot = T.I64
        elif name in ("avg", "dev"):
            ot = T.F64
        elif name == "sum":
            ot = SUM_TYPE[rtype]
        else:
            ot = rtype
        o = Obj(ot, DevPendingSliced(lane, nl), domain=rcol.domain)
        o.meta = {}
        out[out_sid] = o
    return out


# -- entry --------------------------------------------------------------------

def window_join_device(lkeys, rkeys, lo_np, hi_np, aggs, tp):
    """Window aggregates on device. lkeys/rkeys = leading keys + time
    (last). aggs: [(out_sid, name, right_col_Obj, rtype)]. Returns
    {out_sid: lazy Obj} or None if unsupported."""
    lead_l, time_l = lkeys[:-1], lkeys[-1]
    lead_r, time_r = rkeys[:-1], rkeys[-1]
    for _sid, name, _c, rtype in aggs:
        if name in ("sum", "avg", "dev") and rtype not in SUM_TYPE:
            return None
        if name in ("min", "max") and rtype not in MINMAX_OK:
            return None
        if name not in ("count", "first", "last", "sum", "avg",
                        "min", "max", "dev"):
            return None
    if lead_l:
        metas = _key_ranges(lead_l, lead_r)
        if metas is None:
            return None
        total = 1
        for _lo, rng, _nb in metas:
            total *= rng
        if total > dev._cfg["dense_max"]:
            return None
        lcode = _pack_codes(lead_l, metas).astype(jnp.int64)
        rcode = _pack_codes(lead_r, metas).astype(jnp.int64)
        n_codes = total
    else:
        lcode = jnp.zeros(len(time_l), jnp.int64)
        rcode = jnp.zeros(len(time_r), jnp.int64)
        n_codes = 1

    rt_d = dev.dev_col(time_r).astype(jnp.int64)
    if isinstance(lo_np, jax.Array):
        lo_d = lo_np.astype(jnp.int64)
    else:
        lo_d = jnp.asarray(np.asarray(lo_np, dtype=np.int64))
    if isinstance(hi_np, jax.Array):
        hi_d = hi_np.astype(jnp.int64)
    else:
        hi_d = jnp.asarray(np.asarray(hi_np, dtype=np.int64))
    nl, nr = int(lcode.shape[0]), int(rcode.shape[0])
    if nl == 0 or nr == 0:
        return None

    # aggregate input columns ride the boundary sort as payloads
    pay_cols = []
    pay_slot = {}
    for _sid, name, rcol, _rt in aggs:
        if name != "count" and id(rcol) not in pay_slot:
            pay_slot[id(rcol)] = len(pay_cols)
            pay_cols.append(rcol)
    pays = [dev.dev_col(c) for c in pay_cols]
    m = dev.mesh()
    if m is not None:
        res = _mesh_window_join(m, lcode, rcode, rt_d, lo_d, hi_d,
                                nl, nr, n_codes, tp, aggs, pays,
                                pay_slot)
        if res is not None:
            last_profile["engine"] = "dist-wjoin"
            return res
    last_profile["engine"] = "device-wjoin"
    # static (tmin, tbits) packing for the boundary sorts when
    # (code, biased time, tie) fit one i64 key
    pack = None
    rlo, rhi = dev.column_range(time_r)
    if isinstance(lo_np, jax.Array) or isinstance(hi_np, jax.Array):
        # bounds stats in ONE device round trip (4 scalars)
        b4 = jax.device_get(_k_bounds4(lo_d, hi_d))
        lmin, lmax, hmin, hmax = (int(x) for x in b4)
    else:
        lmin, lmax = int(lo_np.min()), int(lo_np.max())
        hmin, hmax = int(hi_np.min()), int(hi_np.max())
    tmin = int(min(int(rlo), lmin, hmin))
    tmax = int(max(int(rhi), lmax, hmax))
    tbits = max(int(tmax - tmin).bit_length(), 1)
    cbits = max(int(n_codes).bit_length(), 1)
    if cbits + tbits + 2 <= 62 and nr < (1 << 36) and \
            nl < (1 << 25):
        pack = (tmin, tbits)
    f = _boundaries_fn(nl, nr, n_codes, tp, len(pays),
                       tuple(str(p.dtype) for p in pays), pack=pack)
    res = f(lcode, rcode, rt_d, lo_d, hi_d, *pays)
    sr, li, ri, ok = res[0], res[1], res[2], res[3]
    spays = res[4:]

    out = {}
    shared_mm: dict = {}   # per-call memo: rank/value sorts shared by
    #                        min+max over the same null-free column
    for out_sid, name, rcol, rtype in aggs:
        sv = spays[pay_slot[id(rcol)]] if name != "count" else None
        if name == "count":
            out[out_sid] = _lazy(T.I64,
                                 lambda: _k_count(li, ri, ok), nl)
        elif name in ("first", "last"):
            out[out_sid] = _lazy(
                rtype, lambda v=sv, lst=(name == "last"), rt_=rtype:
                _k_first_last(v, li, ri, ok, rt_, lst), nl,
                domain=rcol.domain)
        elif name in ("sum", "avg"):
            ot = T.F64 if name == "avg" else SUM_TYPE[rtype]
            out[out_sid] = _lazy(
                ot, lambda v=sv, w=(name == "avg"), rt_=rtype:
                _k_sum_avg(v, li, ri, ok, rt_, w), nl)
        elif name == "dev":
            out[out_sid] = _lazy(
                T.F64, lambda v=sv, rt_=rtype:
                _k_dev(v, li, ri, ok, rt_), nl)
        else:
            if not dev.column_has_null(rcol):
                # min and max over the same null-free column share
                # the rank sorts and the sorted-value lookup table
                # (each aggregate keeps its own executable, so only one
                # flat sparse table is alive at a time)
                def mm_thunk(v=sv, op=name, rt_=rtype, key=id(rcol)):
                    if ("rank", key) not in shared_mm:
                        rk_, vo_ = _k_rank_vals_nf(v)
                        shared_mm[("rank", key)] = rk_
                        shared_mm[("vals", key)] = vo_
                    rk = shared_mm[("rank", key)]
                    vo = shared_mm[("vals", key)]
                    red = _k_minmax_from_rank(rk, li, ri, op)
                    return _k_value_from_sorted(vo, red, ok, rt_, op)
            else:
                def mm_thunk(v=sv, op=name, rt_=rtype):
                    red = _k_minmax_rank(v, li, ri, ok, rt_, op)
                    return _k_minmax_value(v, red, li, ri, ok, rt_,
                                           op)
            out[out_sid] = _lazy(rtype, mm_thunk, nl)
    return out


def _lazy(t, thunk, n, domain=None):
    o = Obj(t, DevPending(thunk=thunk, shape=(n,)), domain=domain)
    o.meta = {}
    return o
