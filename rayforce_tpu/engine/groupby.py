"""Group-by building blocks for the device engine.

Group aggregation never scatters (reference rayforce scatters into
per-thread hash tables, core/index.c:1777; the analogue of its radix
bucketing, core/index.c:2556, is a one-hot matmul whose output
columns are the buckets). Whether scatter, `segment_sum` or native
segmented scans are faster on the GPU has not been measured yet; the
kernels below are the engine's current choice, not a measured one.

- counts / integer sums: the dense group code is factored as
  code = hi*W + lo and per-chunk one-hot matrices for hi and lo turn a
  segment-sum into ONE matmul per chunk: partial[h,w] = sum_l
  onehot_hi[l,h] * v[l] * onehot_lo[l,w]. Values are decomposed into
  8-bit limbs so every f32 accumulation is exact (2^8 * 65536 = 2^24);
  limb partials are recombined in f64 (and exactly, in Python ints, on
  the host for the 64-bit case).
- small n (<= 512): one chunk scan building a (L, n) equality mask and
  reducing sum/min/max/first directly.
- large n: ONE stable sort [codes, iota, payloads...]; group boundaries
  come from cumsum(counts); min/max via log-doubling segmented scans
  over the sorted payloads; first/last/fidx from the iota payload at
  segment starts/ends; f64 sums via zeroed-null cumsum + boundary
  diffs.

All outputs are packed into three stacked buffers so the host pays ONE
transfer per query.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

# SMALL_N, L_CHUNK and factor_hw's 128..1024 widths fix which kernel
# a query gets and how it is tiled. None of them affects results; their
# values await re-derivation from measurements on the GPU.
L_CHUNK = 65536
LIMB_BITS = 8
LIMB_MASK = (1 << LIMB_BITS) - 1
SMALL_N = 512

I64_MIN = -0x8000000000000000
KEY_MAX = 0x7FFFFFFFFFFFFFFF


def factor_hw(n: int):
    """Factor a dense code space into H*W >= n with W a power of two
    between 128 and 1024 (the matmul's output width)."""
    W = 128
    while W < n and W < 1024:
        W *= 2
    H = -(-n // W)
    return H, W


def pad_chunks(arr, n_rows: int, fill):
    """Pad a row-aligned array up to a multiple of L_CHUNK and reshape
    to (R, L_CHUNK)."""
    R = -(-n_rows // L_CHUNK)
    pad = R * L_CHUNK - n_rows
    if pad:
        arr = jnp.concatenate(
            [arr, jnp.full((pad,), fill, dtype=arr.dtype)])
    return arr.reshape(R, L_CHUNK)


# f64 extrema run in value space (NaN pre-mapped to +/-inf, all-null
# groups detected via nan counts) rather than through 64-bit bitcast
# order keys.


# -- matmul segment sums ------------------------------------------------------

def matmul_tasks_scan(codes, weights: list, n_cells: int, n_rows: int):
    """Exact dense segment sums of each weights[i] (f32 (n_rows,), every
    chunk-partial must fit exactly in f32) by group code.

    Returns a list of (n_cells,) f64 sums. One matmul per chunk: the
    task weights are folded into the hi one-hot, stacking tasks along
    the H axis, so adding tasks does not add matmuls. The product runs
    at HIGHEST precision so that no backend rounds its f32 operands
    (TF32 would keep only 10 mantissa bits of arbitrary weights).
    """
    H, W = factor_hw(n_cells)
    T_ = len(weights)
    cc = pad_chunks(codes, n_rows, jnp.int32(n_cells - 1))
    ws = [pad_chunks(w, n_rows, jnp.float32(0)) for w in weights]

    iot_h = jnp.arange(H, dtype=jnp.int32)
    iot_w = jnp.arange(W, dtype=jnp.int32)

    def step(acc, xs):
        ci = xs[0]
        hi = ci // W
        lo = ci % W
        ohh = (hi[:, None] == iot_h).astype(jnp.float32)    # (L, H)
        ohl = (lo[:, None] == iot_w).astype(jnp.float32)    # (L, W)
        wh = jnp.concatenate(
            [ohh * xs[1 + t][:, None] for t in range(T_)], axis=1)
        p = jnp.einsum("lk,lw->kw", wh, ohl,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)  # (T*H, W)
        return acc + p.astype(jnp.float64), None

    acc0 = jnp.zeros((T_ * H, W), dtype=jnp.float64)
    acc, _ = jax.lax.scan(step, acc0, (cc, *ws))
    acc = acc.reshape(T_, H * W)
    return [acc[t, :n_cells] for t in range(T_)]


def int_limb_weights(arr, null_val, lo: int | None, hi: int | None):
    """Split a (possibly null-carrying) integer array into 8-bit limb
    f32 weights plus a null-mask weight, exact under f32 chunk matmul
    accumulation (limb < 2^8, chunk <= 2^16 rows -> partial < 2^24).

    With cached column stats [lo, hi] the value is biased by lo and
    only ceil(bits(span)/8) limbs are emitted; otherwise the value is
    sign-xor biased to the full unsigned 64-bit range (8 limbs). The
    host recombines exactly in Python ints (recombine_limbs).
    """
    nulls = (arr == null_val) if null_val is not None else \
        jnp.zeros(arr.shape, bool)
    a = jnp.where(nulls, 0, arr).astype(jnp.int64)
    if lo is not None and hi is not None and hi >= lo:
        span = hi - lo
        u = jnp.where(nulls, 0, (a - lo)).astype(jnp.uint64)
        bias = -lo  # sum = limb_total - eff*bias
        width = max(span.bit_length(), 1)
    else:
        u = (a ^ jnp.int64(I64_MIN)).astype(jnp.uint64)
        u = jnp.where(nulls, 0, u)
        bias = 1 << 63
        width = 64
    n_limbs = -(-width // LIMB_BITS)
    limbs = [((u >> (LIMB_BITS * i)) & LIMB_MASK).astype(jnp.float32)
             for i in range(n_limbs)]
    return limbs, nulls.astype(jnp.float32), bias


def recombine_limbs(limb_sums: list[np.ndarray], bias: int,
                    counts: np.ndarray, null_counts: np.ndarray):
    """Host-side exact recombination of per-group limb sums (f64,
    exact integers) into Python-int -> int64 group sums. Nulls were
    zeroed on device and excluded from the bias correction."""
    n = len(limb_sums[0])
    out = np.zeros(n, dtype=object)
    for i, s in enumerate(limb_sums):
        out = out + s.astype(np.int64).astype(object) * (1 << (LIMB_BITS * i))
    eff = (counts - null_counts).astype(object)
    out = out - eff * bias
    return out


# -- small-n broadcast scan ---------------------------------------------------

def bcast_scan(codes, n: int, n_rows: int, sums=(), mins=(), maxs=(),
               want_counts=True, want_fidx=True):
    """One pass over chunks with a (L, n) mask shared by every
    aggregate. sums: f64 arrays (nulls pre-zeroed by caller); mins/
    maxs: i64 order keys OR f64 values (nulls pre-mapped by caller to
    the losing extreme). Returns dict of dense (n,) arrays."""
    cc = pad_chunks(codes, n_rows, jnp.int32(n))  # pad rows -> trash n
    iot_n = jnp.arange(n, dtype=jnp.int32)
    # positions in i32 when they fit (always, given the engines' row
    # caps): the (L, n) position lattice is the scan's widest
    # intermediate
    pos32 = n_rows < (1 << 31)
    pdt = jnp.int32 if pos32 else jnp.int64
    P_MAX = (1 << 31) - 1 if pos32 else KEY_MAX
    iot_l = jnp.arange(L_CHUNK, dtype=pdt)
    s_in = [pad_chunks(s, n_rows, jnp.float64(0)) for s in sums]

    def _lims(arr, is_min):
        if arr.dtype == jnp.float64:
            return (jnp.float64(np.inf), jnp.float64(-np.inf)
                    )[0 if is_min else 1]
        return jnp.int64(KEY_MAX if is_min else I64_MIN)

    mn_in = [pad_chunks(m, n_rows, _lims(m, True)) for m in mins]
    mx_in = [pad_chunks(m, n_rows, _lims(m, False)) for m in maxs]

    def step(carry, xs):
        ci = xs[0]
        rest = xs[1:]
        k = 0
        m = ci[:, None] == iot_n                      # (L, n)
        out = dict(carry)
        if want_counts:
            out["counts"] = carry["counts"] + m.sum(
                0, dtype=jnp.int32)
        if want_fidx:
            pos = jnp.where(m, (carry["base"] + iot_l)[:, None],
                            pdt(P_MAX))
            out["fidx"] = jnp.minimum(carry["fidx"], pos.min(0))
            out["lidx"] = jnp.maximum(
                carry["lidx"],
                jnp.where(m, (carry["base"] + iot_l)[:, None],
                          pdt(-1)).max(0))
            out["base"] = carry["base"] + pdt(L_CHUNK)
        for i in range(len(s_in)):
            v = rest[k]; k += 1
            out[f"sum{i}"] = carry[f"sum{i}"] + jnp.where(
                m, v[:, None], 0.0).sum(0)
        for i, src in enumerate(mn_in):
            v = rest[k]; k += 1
            out[f"min{i}"] = jnp.minimum(
                carry[f"min{i}"],
                jnp.where(m, v[:, None], _lims(src, True)).min(0))
        for i, src in enumerate(mx_in):
            v = rest[k]; k += 1
            out[f"max{i}"] = jnp.maximum(
                carry[f"max{i}"],
                jnp.where(m, v[:, None], _lims(src, False)).max(0))
        return out, None

    carry = {}
    if want_counts:
        carry["counts"] = jnp.zeros(n, jnp.int32)
    if want_fidx:
        carry["fidx"] = jnp.full(n, P_MAX, pdt)
        carry["lidx"] = jnp.full(n, -1, pdt)
        carry["base"] = pdt(0)
    for i in range(len(s_in)):
        carry[f"sum{i}"] = jnp.zeros(n, jnp.float64)
    for i, src in enumerate(mn_in):
        carry[f"min{i}"] = jnp.full(n, _lims(src, True), src.dtype)
    for i, src in enumerate(mx_in):
        carry[f"max{i}"] = jnp.full(n, _lims(src, False), src.dtype)
    carry, _ = jax.lax.scan(step, carry, (cc, *s_in, *mn_in, *mx_in))
    carry.pop("base", None)
    if want_fidx and pos32:
        # callers expect i64 positions with the i64 KEY_MAX sentinel
        carry["fidx"] = jnp.where(carry["fidx"] == P_MAX,
                                  jnp.int64(KEY_MAX),
                                  carry["fidx"].astype(jnp.int64))
        carry["lidx"] = carry["lidx"].astype(jnp.int64)
    return carry


# -- sorted-segment kernels ---------------------------------------------------

_SEG_B = 1024   # intra-block width for the two-level segmented scan


def _identity_for(vals, op):
    if vals.dtype == jnp.float64:
        return {"min": jnp.float64(np.inf),
                "max": jnp.float64(-np.inf),
                "sum": jnp.float64(0.0)}[op]
    if vals.dtype == jnp.int32:
        # i32 lanes halve the scan's memory traffic; callers must
        # prove the values/sums fit (e.g. packed-field group sums
        # < 2^31)
        return {"min": jnp.int32(0x7FFFFFFF),
                "max": jnp.int32(-0x80000000),
                "sum": jnp.int32(0)}[op]
    return {"min": jnp.int64(KEY_MAX), "max": jnp.int64(I64_MIN),
            "sum": jnp.int64(0)}[op]


def _apply(op, a, b):
    if op == "min":
        return jnp.minimum(a, b)
    if op == "max":
        return jnp.maximum(a, b)
    return a + b


def _seg_scan(seg_ids, vals, op):
    """Inclusive segmented scan over runs of equal seg_ids (sorted
    ascending), standing in for a segmented reduce. Two-level
    log-doubling: ~log2(B) full-width shift+op steps inside 1024-wide
    blocks, then a tiny block-summary scan and one combine pass — less
    than half the memory traffic of flat doubling. Whether
    associative_scan or a segment reduction is faster on the GPU has
    not been measured."""
    ident = _identity_for(vals, op)
    n = vals.shape[0]
    R = -(-n // _SEG_B)
    pad = R * _SEG_B - n
    s2 = jnp.concatenate(
        [seg_ids, jnp.full((pad,), -2, seg_ids.dtype)]) \
        .reshape(R, _SEG_B)
    m = jnp.concatenate(
        [vals, jnp.full((pad,), ident, vals.dtype)]).reshape(R, _SEG_B)

    d = 1
    while d < _SEG_B:
        same = s2[:, d:] == s2[:, :-d]
        shifted = jnp.where(same, m[:, :-d], ident)
        m = jnp.concatenate([m[:, :d], _apply(op, m[:, d:], shifted)],
                            axis=1)
        d *= 2

    # block summaries: segmented scan over block tail values, with
    # flags = boundary inside the block OR at its left joint
    first_seg = s2[:, 0]
    carry_seg = s2[:, -1]
    cv = m[:, -1]
    internal = first_seg != carry_seg
    joint = jnp.concatenate(
        [jnp.ones(1, bool), first_seg[1:] != carry_seg[:-1]])
    g = internal | joint
    d = 1
    while d < R:
        ga, gb = g[:-d], g[d:]
        combined = _apply(op, cv[:-d], cv[d:])
        cv = jnp.concatenate(
            [cv[:d], jnp.where(gb, cv[d:], combined)])
        g = jnp.concatenate([g[:d], ga | gb])
        d *= 2
    # exclusive prefix for each block r = inclusive at r-1 when chained
    pfx = jnp.concatenate([jnp.full(1, ident, vals.dtype), cv[:-1]])
    pfx = jnp.where(joint, ident, pfx)
    in_first_run = s2 == first_seg[:, None]
    m = jnp.where(in_first_run, _apply(op, m, pfx[:, None]), m)
    return m.reshape(R * _SEG_B)[:n]


def seg_doubling_min(seg_ids, vals):
    return _seg_scan(seg_ids, vals, "min")


def seg_doubling_max(seg_ids, vals):
    return _seg_scan(seg_ids, vals, "max")


def seg_doubling_sum(seg_ids, vals):
    return _seg_scan(seg_ids, vals, "sum")


# -- output packing -----------------------------------------------------------

class Packer:
    """Accumulates device output lanes into THREE stacked buffers (i64,
    f64, i32; narrow lanes halve the fetched bytes), so a query result
    reaches the host in one batched transfer."""

    DTYPES = (jnp.int64, jnp.float64, jnp.int32)

    def __init__(self):
        self.lanes = ([], [], [])
        self.names = ([], [], [])

    def add(self, name: str, arr):
        if arr.dtype == jnp.float64:
            b = 1
        elif arr.dtype == jnp.int32:
            b = 2
        else:
            b = 0
            if arr.dtype != jnp.int64:
                arr = arr.astype(jnp.int64)
        self.lanes[b].append(arr)
        self.names[b].append(name)

    @staticmethod
    def _stack(lanes, dtype):
        if not lanes:
            return jnp.zeros((0, 0), dtype)
        width = max(int(a.shape[0]) for a in lanes)
        padded = [jnp.concatenate(
            [a, jnp.zeros(width - a.shape[0], dtype)])
            if a.shape[0] < width else a for a in lanes]
        return jnp.stack(padded)

    def pack(self):
        layout = []
        for b in range(3):
            layout += [(nm, b, int(a.shape[0]))
                       for nm, a in zip(self.names[b], self.lanes[b])]
        return tuple(self._stack(self.lanes[b], self.DTYPES[b])
                     for b in range(3)), layout


def unpack(bufs, layout):
    out = {}
    idx = [0, 0, 0]
    for nm, b, ln in layout:
        out[nm] = bufs[b][idx[b], :ln]
        idx[b] += 1
    return out
