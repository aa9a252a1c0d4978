"""Mapping-constrained sparse forward — the production scoring kernel.

Counterpart of the reference's hot loop `forward_with_mapping_score_only`
(ref: src/hmmv2/forward.rs:79-89, used via freq.rs:175-192 for every
candidate X evaluation).  Per read position the table is restricted to the
precomputed active set (the "mapping", A ~ 40 nodes); the per-step cost is
O(B * A^2 * D) **independent of graph size n** — this is what makes k=10k
graphs tractable (dense cost is O(B * n * D) with n ~ 1e5..1e6).

Device design: the sparse "which slot holds node v" lookup is a broadcast
equality match between gathered parent indices [B, A, D] and the previous
active set [B, A'] — a dense [B, A, D, A'] select+max that XLA fuses into
VPU-friendly elementwise work, instead of the reference's SparseVec pointer
chasing (sparsevec crate).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .forward import DeviceModel, NEG, _ladd, _ladd3


def _gather_prev(parent_idx, prev_nodes, prev_vals):
    """For each (b, a, d): value of prev_vals at the slot of prev_nodes that
    holds node parent_idx[b,a,d], or -inf if absent.

    parent_idx: [B, A, D] int32; prev_nodes: [B, A'] int32 (-1 pad);
    prev_vals: [B, A'] -> returns [B, A, D].
    """
    match = parent_idx[:, :, :, None] == prev_nodes[:, None, None, :]  # [B,A,D,A']
    vals = jnp.where(match, prev_vals[:, None, None, :], NEG)
    return jnp.max(vals, axis=-1)


def _gather_self(cur_nodes, prev_nodes, prev_vals):
    """Value of prev_vals at each current node (or -inf): [B, A]."""
    match = cur_nodes[:, :, None] == prev_nodes[:, None, :]  # [B, A, A']
    vals = jnp.where(match, prev_vals[:, None, :], NEG)
    return jnp.max(vals, axis=-1)


class SState(NamedTuple):
    nodes: jnp.ndarray  # [B, A] int32 active nodes (-1 pad)
    m: jnp.ndarray  # [B, A]
    i: jnp.ndarray
    d: jnp.ndarray
    mb: jnp.ndarray  # [B]
    ib: jnp.ndarray  # [B]
    e: jnp.ndarray  # [B]
    off: jnp.ndarray  # [B]
    off_c: jnp.ndarray


def _s_step(dm: DeviceModel, st: SState, cur_nodes: jnp.ndarray, x: jnp.ndarray,
            valid: jnp.ndarray, renorm: bool) -> SState:
    """One mapping-constrained forward step (ref: forward.rs:276-306 with
    ``mapping.nodes(i)`` as the active set and is_adaptive=false)."""
    lt = dm.lt
    B, A = cur_nodes.shape
    slot_ok = cur_nodes >= 0
    safe_nodes = jnp.where(slot_ok, cur_nodes, 0)

    # per-slot static attributes
    par_idx = dm.parent_idx[safe_nodes]  # [B, A, D]
    par_logt = jnp.where(slot_ok[:, :, None], dm.parent_logt[safe_nodes], NEG)
    init_lp = jnp.where(slot_ok, dm.init_logp[safe_nodes], NEG)  # [B, A]
    emis = dm.emission[safe_nodes]  # [B, A]
    p_emit = jnp.where(emis == x[:, None], lt.match, lt.mismatch)

    # fm — combine the three source tables FIRST, then gather once:
    # gather(ladd3(a,b,c)) == ladd3(gather(a),...) since the gather is a
    # pure per-slot selection; cuts the O(A*D*A') equality matches from 3
    # to 1 per frontier (same trick as the Pallas kernel's fused gathers)
    pre_m = _ladd3(lt.MM + st.m, lt.IM + st.i, lt.DM + st.d)
    inner = _gather_prev(par_idx, st.nodes, pre_m)
    from_normal = _lse_last(par_logt + inner)
    from_begin = init_lp + _ladd(lt.MM + st.mb, lt.IM + st.ib)[:, None]
    m_new = p_emit + _ladd(from_normal, from_begin)

    # fi: self transition, prev table value at the same node
    pre_i = _ladd3(lt.MI + st.m, lt.II + st.i, lt.DI + st.d)
    i_new = lt.random + _gather_self(cur_nodes, st.nodes, pre_i)

    mb_new = jnp.full_like(st.mb, NEG)
    ib_new = lt.random + _ladd(lt.MI + st.mb, lt.II + st.ib)

    # fd: deletion closure within the current active set
    pre_d = _ladd(lt.MD + m_new, lt.ID + i_new)
    fd0 = _lse_last(par_logt + _gather_prev(par_idx, cur_nodes, pre_d))
    fd0 = _ladd(fd0, init_lp + _ladd(lt.MD + mb_new, lt.ID + ib_new)[:, None])
    d_new = fd0
    fdt = fd0
    for _ in range(dm.n_max_gaps):
        fdt = _lse_last(par_logt + lt.DD + _gather_prev(par_idx, cur_nodes, fdt))
        d_new = _ladd(d_new, fdt)

    # mask padding slots
    m_new = jnp.where(slot_ok, m_new, NEG)
    i_new = jnp.where(slot_ok, i_new, NEG)
    d_new = jnp.where(slot_ok, d_new, NEG)

    # fe
    e_new = lt.end + _lse_last(_ladd3(m_new, i_new, d_new))

    off, off_c = st.off, st.off_c
    if renorm:
        shift = jnp.max(m_new, axis=-1)
        shift = jnp.where(jnp.isfinite(shift) & valid, shift, 0.0)
        m_new = m_new - shift[:, None]
        i_new = i_new - shift[:, None]
        d_new = d_new - shift[:, None]
        mb_new = mb_new - shift
        ib_new = ib_new - shift
        e_new = e_new - shift
        y = shift - off_c
        t = off + y
        off_c = (t - off) - y
        off = t

    v1 = valid[:, None]
    return SState(
        nodes=jnp.where(v1, cur_nodes, st.nodes),
        m=jnp.where(v1, m_new, st.m),
        i=jnp.where(v1, i_new, st.i),
        d=jnp.where(v1, d_new, st.d),
        mb=jnp.where(valid, mb_new, st.mb),
        ib=jnp.where(valid, ib_new, st.ib),
        e=jnp.where(valid, e_new, st.e),
        off=jnp.where(valid, off, st.off),
        off_c=jnp.where(valid, off_c, st.off_c),
    )


def _lse_last(x):
    m = jnp.max(x, axis=-1)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out = m_safe + jnp.log(jnp.sum(jnp.exp(x - m_safe[..., None]), axis=-1))
    return jnp.where(jnp.isfinite(m), out, NEG)


@functools.partial(jax.jit, static_argnames=("renorm",))
def forward_scores_mapped(
    dm: DeviceModel,
    codes: jnp.ndarray,  # [B, L]
    lens: jnp.ndarray,  # [B]
    map_nodes: jnp.ndarray,  # [B, L, A] int32, -1 pad
    renorm: bool = True,
) -> jnp.ndarray:
    """Log P(read) per read, evaluating only the mapped active sets
    (ref: forward.rs:79-89 forward_with_mapping_score_only)."""
    B, L = codes.shape
    A = map_nodes.shape[2]
    dtype = dm.init_logp.dtype
    z = jnp.zeros((B,), dtype=dtype)
    st0 = SState(
        nodes=jnp.full((B, A), -1, dtype=jnp.int32),
        m=jnp.full((B, A), NEG, dtype=dtype),
        i=jnp.full((B, A), NEG, dtype=dtype),
        d=jnp.full((B, A), NEG, dtype=dtype),
        mb=z,  # log 1
        ib=jnp.full((B,), NEG, dtype=dtype),
        e=jnp.full((B,), NEG, dtype=dtype),
        off=z,
        off_c=z,
    )
    pos = jnp.arange(L, dtype=lens.dtype)

    def body(st, xs):
        x, nodes_t, p = xs
        valid = p < lens
        return _s_step(dm, st, nodes_t, x, valid, renorm), None

    st, _ = jax.lax.scan(
        body, st0, (codes.T, jnp.swapaxes(map_nodes, 0, 1), pos)
    )
    return st.e + st.off


class MappedPositions(NamedTuple):
    """Host-precomputed slot positions for the mapped kernel.

    The active sets are fixed per (read, position) during candidate scoring,
    so "which slot of the previous step holds my parent" is precomputed once
    per k instead of equality-matched on device every step (kills the O(A'^2)
    broadcast):

    * prev_pos [B, L, A, D]: slot in step l-1 holding parent d of slot a
      (-1 if absent; step 0 has no previous -> all -1)
    * cur_pos  [B, L, A, D]: slot in step l   holding parent d of slot a
      (for the in-step deletion closure)
    """

    map_nodes: np.ndarray  # [B, L, A] int32
    prev_pos: np.ndarray  # [B, L, A, D] int16
    cur_pos: np.ndarray  # [B, L, A, D] int16
    self_pos: np.ndarray  # [B, L, A] int16: slot in step l-1 holding this node


@jax.jit
def _positions_chunk(p, cur, prev):
    """p [B,c,A,D], cur/prev [B,c,A] -> (cur_pos, prev_pos, self_pos)."""

    def find(query, ref):
        # query [..., X], ref [..., A'] -> position of query in ref or -1
        eq = query[..., None] == ref[..., None, :]
        has = jnp.any(eq, axis=-1)
        pos = jnp.argmax(eq, axis=-1).astype(jnp.int16)
        return jnp.where(has, pos, -1)

    cur_pos = find(p, cur[:, :, None, :])
    prev_pos = find(p, prev[:, :, None, :])
    self_pos = find(
        jnp.where(cur >= 0, cur, -2), prev
    )
    return cur_pos, prev_pos, self_pos


def precompute_positions_device(
    map_nodes: np.ndarray, parent_idx: np.ndarray, chunk: int = 256
) -> MappedPositions:
    """Device-side variant (slower than numpy in practice on this platform;
    kept for reference)."""
    B, L, A = map_nodes.shape
    D = parent_idx.shape[1]
    prev_pos = np.empty((B, L, A, D), dtype=np.int16)
    cur_pos = np.empty((B, L, A, D), dtype=np.int16)
    self_pos = np.empty((B, L, A), dtype=np.int16)

    safe = np.where(map_nodes >= 0, map_nodes, 0)
    parents = parent_idx[safe]
    parents = np.where(map_nodes[..., None] >= 0, parents, -2)
    prev_all = np.concatenate(
        [np.full((B, 1, A), -3, dtype=map_nodes.dtype), map_nodes[:, :-1]], axis=1
    )

    # fixed chunk shapes for jit-cache stability: pad the tail chunk
    for l0 in range(0, L, chunk):
        l1 = min(l0 + chunk, L)
        c = l1 - l0
        sl = lambda arr: (
            arr[:, l0 : l0 + chunk]
            if c == chunk
            else np.pad(arr[:, l0:l1], [(0, 0), (0, chunk - c)] + [(0, 0)] * (arr.ndim - 2), constant_values=-2)
        )
        cp, pp, sp = _positions_chunk(
            jnp.asarray(sl(parents)), jnp.asarray(sl(map_nodes)),
            jnp.asarray(sl(prev_all)),
        )
        cur_pos[:, l0:l1] = np.asarray(cp)[:, :c]
        prev_pos[:, l0:l1] = np.asarray(pp)[:, :c]
        self_pos[:, l0:l1] = np.asarray(sp)[:, :c]
    return MappedPositions(
        map_nodes=map_nodes.astype(np.int32), prev_pos=prev_pos, cur_pos=cur_pos,
        self_pos=self_pos,
    )


_POS_LIB = None
_POS_TRIED = False


def _load_pos_lib():
    global _POS_LIB, _POS_TRIED
    if _POS_TRIED:
        return _POS_LIB
    _POS_TRIED = True
    import ctypes
    import subprocess
    from pathlib import Path

    cpp = Path(__file__).resolve().parent.parent.parent / "cpp" / "positions.cpp"
    so = Path(__file__).resolve().parent / "_libdbgpos.so"
    try:
        if not so.exists() or so.stat().st_mtime < cpp.stat().st_mtime:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", str(cpp), "-o", str(so)],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(str(so))
        lib.dbg_precompute_positions.restype = ctypes.c_int
        lib.dbg_precompute_positions.argtypes = [
            ctypes.c_int32] * 5 + [
            np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int16), np.ctypeslib.ndpointer(np.int16),
            np.ctypeslib.ndpointer(np.int16),
        ]
        _POS_LIB = lib
    except Exception:
        _POS_LIB = None
    return _POS_LIB


def _precompute_positions_native(
    map_nodes: np.ndarray, parent_idx: np.ndarray
) -> MappedPositions:
    lib = _load_pos_lib()
    if lib is None:
        raise RuntimeError("native positions lib unavailable")
    B, L, A = map_nodes.shape
    n, D = parent_idx.shape
    mn = np.ascontiguousarray(map_nodes, dtype=np.int32)
    pi = np.ascontiguousarray(parent_idx, dtype=np.int32)
    prev_pos = np.empty((B, L, A, D), dtype=np.int16)
    cur_pos = np.empty((B, L, A, D), dtype=np.int16)
    self_pos = np.empty((B, L, A), dtype=np.int16)
    rc = lib.dbg_precompute_positions(B, L, A, D, n, mn, pi, prev_pos, cur_pos, self_pos)
    if rc != 0:
        raise RuntimeError(f"native positions failed rc={rc}")
    return MappedPositions(mn, prev_pos, cur_pos, self_pos)


def precompute_positions(
    map_nodes: np.ndarray, parent_idx: np.ndarray, chunk: int = 64,
    parent_exists: np.ndarray = None,
) -> MappedPositions:
    """Build MappedPositions. Uses the native C++ builder when available,
    else vectorized numpy chunked over L.

    ``parent_exists`` masks structurally-absent adjacency padding slots (they
    hold node id 0 in the model arrays); when given, those parents resolve to
    position -1 instead of possibly matching a real slot holding node 0.  The
    log-space kernels are insensitive (the -inf parent_logt kills phantom
    contributions) but the Pallas compact-table kernel requires the mask."""
    if parent_exists is not None:
        parent_idx = np.where(parent_exists, parent_idx, -9)
    try:
        return _precompute_positions_native(map_nodes, parent_idx)
    except Exception:
        pass
    B, L, A = map_nodes.shape
    D = parent_idx.shape[1]
    prev_pos = np.full((B, L, A, D), -1, dtype=np.int16)
    cur_pos = np.full((B, L, A, D), -1, dtype=np.int16)
    self_pos = np.full((B, L, A), -1, dtype=np.int16)

    safe = np.where(map_nodes >= 0, map_nodes, 0)
    parents = parent_idx[safe]  # [B, L, A, D]
    parents = np.where(map_nodes[..., None] >= 0, parents, -2)

    for l0 in range(0, L, chunk):
        l1 = min(l0 + chunk, L)
        p = parents[:, l0:l1]  # [B, c, A, D]
        cur = map_nodes[:, l0:l1]  # [B, c, A]
        # position of p within cur (same step)
        eq = p[..., None] == cur[:, :, None, None, :]  # [B, c, A, D, A]
        has = eq.any(axis=-1)
        pos = eq.argmax(axis=-1).astype(np.int16)
        cur_pos[:, l0:l1] = np.where(has, pos, -1)
        # position of p within previous step's set
        if l0 == 0:
            prev = np.concatenate(
                [np.full((B, 1, A), -3, dtype=map_nodes.dtype), cur[:, :-1]],
                axis=1,
            )
        else:
            prev = map_nodes[:, l0 - 1 : l1 - 1]
        eq = p[..., None] == prev[:, :, None, None, :]
        has = eq.any(axis=-1)
        pos = eq.argmax(axis=-1).astype(np.int16)
        prev_pos[:, l0:l1] = np.where(has, pos, -1)
        # self positions: node of slot a at step l within step l-1's set
        cur_valid = np.where(cur >= 0, cur, -2)
        eq = cur_valid[..., None] == prev[:, :, None, :]
        has = eq.any(axis=-1)
        pos = eq.argmax(axis=-1).astype(np.int16)
        self_pos[:, l0:l1] = np.where(has, pos, -1)
    return MappedPositions(
        map_nodes=map_nodes.astype(np.int32), prev_pos=prev_pos, cur_pos=cur_pos,
        self_pos=self_pos,
    )


def _gather_pos(vals: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """vals [..., A'], pos [..., A, D] (-1 = absent) -> [..., A, D].

    Flattened take_along_axis — no [A, A'] broadcast materialization."""
    lead = pos.shape[:-2]
    A, D = pos.shape[-2:]
    safe = jnp.where(pos >= 0, pos, 0).astype(jnp.int32).reshape(*lead, A * D)
    out = jnp.take_along_axis(vals, safe, axis=-1).reshape(*lead, A, D)
    return jnp.where(pos >= 0, out, NEG)


def _s_step_pos(dm: DeviceModel, st, cur_nodes, prev_pos, cur_pos, self_pos, x, valid):
    """Mapped forward step using precomputed positions (renormalized)."""
    lt = dm.lt
    slot_ok = cur_nodes >= 0
    safe_nodes = jnp.where(slot_ok, cur_nodes, 0)
    par_logt = jnp.where(slot_ok[:, :, None], dm.parent_logt[safe_nodes], NEG)
    init_lp = jnp.where(slot_ok, dm.init_logp[safe_nodes], NEG)
    emis = dm.emission[safe_nodes]
    p_emit = jnp.where(emis == x[:, None], lt.match, lt.mismatch)

    pm = _gather_pos(st.m, prev_pos)
    pi = _gather_pos(st.i, prev_pos)
    pd = _gather_pos(st.d, prev_pos)
    inner = _ladd3(lt.MM + pm, lt.IM + pi, lt.DM + pd)
    from_normal = _lse_last(par_logt + inner)
    from_begin = init_lp + _ladd(lt.MM + st.mb, lt.IM + st.ib)[:, None]
    m_new = p_emit + _ladd(from_normal, from_begin)

    # fi: self transition via precomputed self positions
    sp = self_pos
    sp_safe = jnp.where(sp >= 0, sp, 0).astype(jnp.int32)
    sv = lambda tab: jnp.where(
        sp >= 0, jnp.take_along_axis(tab, sp_safe, axis=1), NEG
    )
    i_new = lt.random + _ladd3(lt.MI + sv(st.m), lt.II + sv(st.i), lt.DI + sv(st.d))

    mb_new = jnp.full_like(st.mb, NEG)
    ib_new = lt.random + _ladd(lt.MI + st.mb, lt.II + st.ib)

    fm_par = _gather_pos(m_new, cur_pos)
    fi_par = _gather_pos(i_new, cur_pos)
    fd0 = _lse_last(par_logt + _ladd(lt.MD + fm_par, lt.ID + fi_par))
    fd0 = _ladd(fd0, init_lp + _ladd(lt.MD + mb_new, lt.ID + ib_new)[:, None])
    d_new = fd0
    fdt = fd0
    for _ in range(dm.n_max_gaps):
        fdt = _lse_last(par_logt + lt.DD + _gather_pos(fdt, cur_pos))
        d_new = _ladd(d_new, fdt)

    m_new = jnp.where(slot_ok, m_new, NEG)
    i_new = jnp.where(slot_ok, i_new, NEG)
    d_new = jnp.where(slot_ok, d_new, NEG)
    e_new = lt.end + _lse_last(_ladd3(m_new, i_new, d_new))

    shift = jnp.max(m_new, axis=-1)
    shift = jnp.where(jnp.isfinite(shift) & valid, shift, 0.0)
    m_new = m_new - shift[:, None]
    i_new = i_new - shift[:, None]
    d_new = d_new - shift[:, None]
    mb_new = mb_new - shift
    ib_new = ib_new - shift
    e_new = e_new - shift
    y = shift - st.off_c
    t = st.off + y
    off_c = (t - st.off) - y
    off = t

    v1 = valid[:, None]
    return SState(
        nodes=jnp.where(v1, cur_nodes, st.nodes),
        m=jnp.where(v1, m_new, st.m),
        i=jnp.where(v1, i_new, st.i),
        d=jnp.where(v1, d_new, st.d),
        mb=jnp.where(valid, mb_new, st.mb),
        ib=jnp.where(valid, ib_new, st.ib),
        e=jnp.where(valid, e_new, st.e),
        off=jnp.where(valid, off, st.off),
        off_c=jnp.where(valid, off_c, st.off_c),
    )


@jax.jit
def forward_scores_mapped_pos(
    dm: DeviceModel,
    codes: jnp.ndarray,
    lens: jnp.ndarray,
    map_nodes: jnp.ndarray,  # [B, L, A]
    prev_pos: jnp.ndarray,  # [B, L, A, D]
    cur_pos: jnp.ndarray,  # [B, L, A, D]
    self_pos: jnp.ndarray,  # [B, L, A]
) -> jnp.ndarray:
    """Position-precomputed mapped forward (production candidate scorer)."""
    B, L = codes.shape
    A = map_nodes.shape[2]
    dtype = dm.init_logp.dtype
    z = jnp.zeros((B,), dtype=dtype)
    st0 = SState(
        nodes=jnp.full((B, A), -1, dtype=jnp.int32),
        m=jnp.full((B, A), NEG, dtype=dtype),
        i=jnp.full((B, A), NEG, dtype=dtype),
        d=jnp.full((B, A), NEG, dtype=dtype),
        mb=z,
        ib=jnp.full((B,), NEG, dtype=dtype),
        e=jnp.full((B,), NEG, dtype=dtype),
        off=z,
        off_c=z,
    )
    pos = jnp.arange(L, dtype=lens.dtype)

    def body(st, xs):
        x, nodes_t, pp, cp, sp, p = xs
        valid = p < lens
        return _s_step_pos(dm, st, nodes_t, pp, cp, sp, x, valid), None

    st, _ = jax.lax.scan(
        body, st0,
        (
            codes.T,
            jnp.swapaxes(map_nodes, 0, 1),
            jnp.swapaxes(prev_pos, 0, 1),
            jnp.swapaxes(cur_pos, 0, 1),
            jnp.swapaxes(self_pos, 0, 1),
            pos,
        ),
    )
    return st.e + st.off


# -- scaled-linear mapped forward ---------------------------------------------
#
# The log-space step spends its time in logaddexp transcendentals.  Because
# every step renormalizes by the per-read max anyway, the tables can live in
# LINEAR space scaled to max=1: the recursion becomes pure multiply-add (VPU
# fast), with ONE log per read per step for the offset.  States more than
# ~87 log units below the per-step max flush to zero in f32 — a strictly
# tighter cutoff than the active-set itself (score ratio 30,
# ref: params.rs active_node_max_ratio), so accuracy matches the sparse DP.


class LinTrans(NamedTuple):
    """Linear-space transition/emission constants."""

    MM: jnp.ndarray
    IM: jnp.ndarray
    DM: jnp.ndarray
    MI: jnp.ndarray
    II: jnp.ndarray
    DI: jnp.ndarray
    MD: jnp.ndarray
    ID: jnp.ndarray
    DD: jnp.ndarray
    match: jnp.ndarray
    mismatch: jnp.ndarray
    random: jnp.ndarray
    end: jnp.ndarray


def _lin_trans(lt) -> LinTrans:
    return LinTrans(*[jnp.exp(getattr(lt, f)) for f in LinTrans._fields])


class LinState(NamedTuple):
    m: jnp.ndarray  # [B, A] linear, scaled so max ~ 1
    i: jnp.ndarray
    d: jnp.ndarray
    mb: jnp.ndarray  # [B] linear at current scale
    ib: jnp.ndarray
    e: jnp.ndarray
    off: jnp.ndarray  # [B] cumulative log scale
    off_c: jnp.ndarray  # Kahan compensation


def _gather_pos_lin(vals: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Linear-space positional gather: absent -> 0."""
    lead = pos.shape[:-2]
    A, D = pos.shape[-2:]
    safe = jnp.where(pos >= 0, pos, 0).astype(jnp.int32).reshape(*lead, A * D)
    out = jnp.take_along_axis(vals, safe, axis=-1).reshape(*lead, A, D)
    return jnp.where(pos >= 0, out, 0.0)


def _s_step_lin(ltl: LinTrans, emission, init_p, par_t,
                st: LinState, cur_nodes, prev_pos, cur_pos, self_pos,
                x, valid, n_max_gaps: int):
    """One linear-space mapped step.

    * emission [n] int32, init_p [n] linear, par_t [n, D] linear
    * all table math is multiply-add; one log per read for the offset
    """
    slot_ok = cur_nodes >= 0
    safe_nodes = jnp.where(slot_ok, cur_nodes, 0)
    pt = jnp.where(slot_ok[:, :, None], par_t[safe_nodes], 0.0)  # [B, A, D]
    ip = jnp.where(slot_ok, init_p[safe_nodes], 0.0)  # [B, A]
    emis = emission[safe_nodes]
    p_emit = jnp.where(emis == x[:, None], ltl.match, ltl.mismatch)

    pm = _gather_pos_lin(st.m, prev_pos)
    pi = _gather_pos_lin(st.i, prev_pos)
    pd = _gather_pos_lin(st.d, prev_pos)
    inner = ltl.MM * pm + ltl.IM * pi + ltl.DM * pd
    from_normal = jnp.sum(pt * inner, axis=-1)
    from_begin = ip * (ltl.MM * st.mb + ltl.IM * st.ib)[:, None]
    m_new = p_emit * (from_normal + from_begin)

    sp_safe = jnp.where(self_pos >= 0, self_pos, 0).astype(jnp.int32)
    sv = lambda tab: jnp.where(
        self_pos >= 0, jnp.take_along_axis(tab, sp_safe, axis=1), 0.0
    )
    i_new = ltl.random * (ltl.MI * sv(st.m) + ltl.II * sv(st.i) + ltl.DI * sv(st.d))

    mb_new = jnp.zeros_like(st.mb)
    ib_new = ltl.random * (ltl.MI * st.mb + ltl.II * st.ib)

    fm_par = _gather_pos_lin(m_new, cur_pos)
    fi_par = _gather_pos_lin(i_new, cur_pos)
    fd0 = jnp.sum(pt * (ltl.MD * fm_par + ltl.ID * fi_par), axis=-1)
    fd0 = fd0 + ip * (ltl.MD * mb_new + ltl.ID * ib_new)[:, None]
    d_new = fd0
    fdt = fd0
    for _ in range(n_max_gaps):
        fdt = jnp.sum(pt * (ltl.DD * _gather_pos_lin(fdt, cur_pos)), axis=-1)
        d_new = d_new + fdt

    m_new = jnp.where(slot_ok, m_new, 0.0)
    i_new = jnp.where(slot_ok, i_new, 0.0)
    d_new = jnp.where(slot_ok, d_new, 0.0)
    e_new = ltl.end * jnp.sum(m_new + i_new + d_new, axis=-1)

    scale = jnp.max(m_new, axis=-1)
    scale = jnp.where((scale > 0) & valid, scale, 1.0)
    inv = 1.0 / scale
    m_new = m_new * inv[:, None]
    i_new = i_new * inv[:, None]
    d_new = d_new * inv[:, None]
    mb_new = mb_new * inv
    ib_new = ib_new * inv
    e_new = e_new * inv
    shift = jnp.log(scale)
    y = shift - st.off_c
    t = st.off + y
    off_c = (t - st.off) - y
    off = t

    v1 = valid[:, None]
    return LinState(
        m=jnp.where(v1, m_new, st.m),
        i=jnp.where(v1, i_new, st.i),
        d=jnp.where(v1, d_new, st.d),
        mb=jnp.where(valid, mb_new, st.mb),
        ib=jnp.where(valid, ib_new, st.ib),
        e=jnp.where(valid, e_new, st.e),
        off=jnp.where(valid, off, st.off),
        off_c=jnp.where(valid, off_c, st.off_c),
    )


@jax.jit
def forward_scores_mapped_linear(
    dm: DeviceModel,
    codes: jnp.ndarray,
    lens: jnp.ndarray,
    map_nodes: jnp.ndarray,
    prev_pos: jnp.ndarray,
    cur_pos: jnp.ndarray,
    self_pos: jnp.ndarray,
) -> jnp.ndarray:
    """Scaled-linear mapped forward score (production scorer)."""
    B, L = codes.shape
    A = map_nodes.shape[2]
    dtype = dm.init_logp.dtype
    ltl = _lin_trans(dm.lt)
    init_p = jnp.exp(dm.init_logp)
    par_t = jnp.exp(dm.parent_logt)
    z = jnp.zeros((B,), dtype=dtype)
    st0 = LinState(
        m=jnp.zeros((B, A), dtype=dtype),
        i=jnp.zeros((B, A), dtype=dtype),
        d=jnp.zeros((B, A), dtype=dtype),
        mb=jnp.ones((B,), dtype=dtype),
        ib=z,
        e=z,
        off=z,
        off_c=z,
    )
    pos = jnp.arange(L, dtype=lens.dtype)

    def body(st, xs):
        x, nodes_t, pp, cp, sp, p = xs
        valid = p < lens
        st1 = _s_step_lin(
            ltl, dm.emission, init_p, par_t, st, nodes_t, pp, cp, sp, x,
            valid, dm.n_max_gaps,
        )
        return st1, None

    st, _ = jax.lax.scan(
        body, st0,
        (
            codes.T, jnp.swapaxes(map_nodes, 0, 1),
            jnp.swapaxes(prev_pos, 0, 1), jnp.swapaxes(cur_pos, 0, 1),
            jnp.swapaxes(self_pos, 0, 1), pos,
        ),
    )
    e_safe = jnp.where(st.e > 0, st.e, 1e-300)
    return jnp.where(st.e > 0, jnp.log(e_safe) + st.off, NEG)


def pad_mappings(mappings, L: int, n_active: int) -> np.ndarray:
    """Stack per-read mapping node arrays into [B, L, A] with -1 padding."""
    B = mappings.n_reads()
    out = np.full((B, L, n_active), -1, dtype=np.int32)
    for b, nodes in enumerate(mappings.nodes):
        Lb, Ab = nodes.shape
        a = min(Ab, n_active)
        out[b, :Lb, :a] = nodes[:, :a]
    return out
