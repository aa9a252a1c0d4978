"""Sparse-adaptive forward/backward for mapping generation on large graphs.

Counterpart of the reference's ``run_sparse_adaptive`` path
(ref: src/hmmv2/forward.rs:93-154 forward_sparse,
src/hmmv2/backward.rs:101-142 backward_by_forward, freq.rs:42-76): the active
set evolves with the read — the top-K nodes of the previous table plus their
children — so memory and compute are O(B * L * A) with A = K*(D+1) slots,
independent of graph size n.

This replaces the dense ``node_freqs_and_mappings`` when n is large (dense
tables cost O(B * L * n) memory).  The warmup region is NOT computed densely
(unlike the reference's n_warmup=k dense prefix): instead the first steps
simply start from the Begin state whose successors are discovered through the
init-prob top-K — see ``_initial_active``.  Parity with dense is enforced in
tests at the mapping level (same top nodes on small graphs).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .forward import DeviceModel, NEG, _ladd, _ladd3, _ratio_mask
from .sparse import SState, _gather_prev, _gather_self, _lse_last, _s_step


def _pack_model(dm: DeviceModel) -> jnp.ndarray:
    """Pack all per-node model attributes into ONE [n, 2+5D] table so each
    scan step performs a single big-table gather.

    A [B, A]-indexed gather from an [n, *] table costs about the same
    whatever its width, so one packed gather replaces the six the step
    would otherwise issue (parent/child idx+logt, init, emission).  Columns:
    [init_logp, emission, parent_logt*D, parent_idx*D, child_logt*D,
    child_idx*D, child_emission*D]; ids stored as floats (exact below 2^24).
    """
    dtype = dm.init_logp.dtype
    D = dm.parent_idx.shape[1]
    child_emis = dm.emission[dm.child_idx]  # [n, D]
    cols = [
        dm.init_logp[:, None],
        dm.emission[:, None].astype(dtype),
        dm.parent_logt,
        dm.parent_idx.astype(dtype),
        dm.child_logt,
        dm.child_idx.astype(dtype),
        child_emis.astype(dtype),
    ]
    return jnp.concatenate([jnp.asarray(c, dtype=dtype) for c in cols], axis=1)


def _attr_cols(D: int):
    """Column slices of the packed attribute table."""
    return dict(
        init=0, emis=1,
        plogt=slice(2, 2 + D), pidx=slice(2 + D, 2 + 2 * D),
        clogt=slice(2 + 2 * D, 2 + 3 * D), cidx=slice(2 + 3 * D, 2 + 4 * D),
        cemis=slice(2 + 4 * D, 2 + 5 * D),
    )


def _gather_attrs(pk: jnp.ndarray, nodes: jnp.ndarray) -> jnp.ndarray:
    """The per-step big gather: attrs [B, A, 2+5D] for an active set."""
    return pk[jnp.where(nodes >= 0, nodes, 0)]


def _dedup_nodes(nodes: jnp.ndarray) -> jnp.ndarray:
    """Mark duplicate node ids (per row) as -1, PRESERVING slot order.
    nodes: [B, A] int32.

    Slot order is priority order: callers truncate the result with ``[:, :A]``
    (forward_sparse_adaptive), so the score-ranked top nodes in the leading
    slots must stay in the leading slots.  Sort to find duplicates in
    O(A log A), then unsort via the argsort permutation so every surviving id
    sits in its original slot.  argsort is stable, so among duplicates the
    EARLIEST (highest-priority) slot keeps the id."""
    order = jnp.argsort(nodes, axis=-1)
    s = jnp.take_along_axis(nodes, order, axis=-1)
    dup = jnp.concatenate(
        [jnp.zeros_like(s[:, :1], dtype=bool), s[:, 1:] == s[:, :-1]], axis=1
    )
    s = jnp.where(dup | (s < 0), -1, s)
    inv = jnp.argsort(order, axis=-1)
    return jnp.take_along_axis(s, inv, axis=-1)


def _next_active(dm: DeviceModel, st: SState, n_top: int,
                 max_ratio=None) -> jnp.ndarray:
    """top-K of previous table (merged m+i+d) -> children + selves
    (ref: forward.rs:148 to_childs_and_us(top_nodes)).  With ``max_ratio``
    the frontier is score-ratio selected under the top-K cap (ref:
    forward.rs:112-115 top_nodes_by_score_ratio) — nodes more than
    ``max_ratio`` log units below the per-read max are dropped, so junk
    states stop spending slots on their children."""
    merged = _ladd3(st.m, st.i, st.d)  # [B, A]
    merged = jnp.where(st.nodes >= 0, merged, NEG)
    if max_ratio is not None:
        mx = jnp.max(merged, axis=-1, keepdims=True)
        merged = jnp.where(merged >= mx - max_ratio, merged, NEG)
    k = min(n_top, merged.shape[1])
    top_vals, top_slots = jax.lax.top_k(merged, k)  # [B, k]
    top_nodes = jnp.take_along_axis(st.nodes, top_slots, axis=1)
    top_nodes = jnp.where(jnp.isfinite(top_vals), top_nodes, -1)
    safe = jnp.where(top_nodes >= 0, top_nodes, 0)
    childs = dm.child_idx[safe]  # [B, k, D]
    child_ok = (top_nodes[:, :, None] >= 0) & jnp.isfinite(
        dm.child_logt[safe]
    )
    childs = jnp.where(child_ok, childs, -1)
    cand = jnp.concatenate(
        [top_nodes, childs.reshape(childs.shape[0], -1)], axis=1
    )
    return _dedup_nodes(cand)


def _next_active_attrs(dm: DeviceModel, st: SState, attrs: jnp.ndarray,
                       n_top: int, max_ratio=None) -> jnp.ndarray:
    """`_next_active` reading the children of the top nodes from the carried
    attribute block (an exact slot gather) instead of re-gathering the child
    tables from the [n]-row model arrays."""
    D = dm.parent_idx.shape[1]
    c = _attr_cols(D)
    merged = _ladd3(st.m, st.i, st.d)  # [B, A]
    merged = jnp.where(st.nodes >= 0, merged, NEG)
    if max_ratio is not None:
        mx = jnp.max(merged, axis=-1, keepdims=True)
        merged = jnp.where(merged >= mx - max_ratio, merged, NEG)
    k = min(n_top, merged.shape[1])
    top_vals, top_slots = jax.lax.top_k(merged, k)  # [B, k]
    top_nodes = jnp.take_along_axis(st.nodes, top_slots, axis=1)
    top_nodes = jnp.where(jnp.isfinite(top_vals), top_nodes, -1)
    sel = jnp.take_along_axis(attrs, top_slots[:, :, None], axis=1)
    child_logt = sel[..., c["clogt"]]  # [B, k, D]
    childs = sel[..., c["cidx"]].astype(jnp.int32)
    child_ok = (top_nodes[:, :, None] >= 0) & jnp.isfinite(child_logt)
    childs = jnp.where(child_ok, childs, -1)
    cand = jnp.concatenate(
        [top_nodes, childs.reshape(childs.shape[0], -1)], axis=1
    )
    return _dedup_nodes(cand)


def _s_step_attrs(dm: DeviceModel, st: SState, cur_nodes: jnp.ndarray,
                  attrs: jnp.ndarray, x: jnp.ndarray,
                  valid: jnp.ndarray) -> SState:
    """`sparse._s_step` with the per-node model attributes supplied by one
    packed gather (ref: forward.rs:276-306)."""
    lt = dm.lt
    D = dm.parent_idx.shape[1]
    c = _attr_cols(D)
    slot_ok = cur_nodes >= 0
    par_idx = attrs[..., c["pidx"]].astype(jnp.int32)  # [B, A, D]
    par_logt = jnp.where(slot_ok[:, :, None], attrs[..., c["plogt"]], NEG)
    init_lp = jnp.where(slot_ok, attrs[..., c["init"]], NEG)  # [B, A]
    emis = attrs[..., c["emis"]].astype(jnp.int32)
    p_emit = jnp.where(emis == x[:, None], lt.match, lt.mismatch)

    pre_m = _ladd3(lt.MM + st.m, lt.IM + st.i, lt.DM + st.d)
    inner = _gather_prev(par_idx, st.nodes, pre_m)
    from_normal = _lse_last(par_logt + inner)
    from_begin = init_lp + _ladd(lt.MM + st.mb, lt.IM + st.ib)[:, None]
    m_new = p_emit + _ladd(from_normal, from_begin)

    pre_i = _ladd3(lt.MI + st.m, lt.II + st.i, lt.DI + st.d)
    i_new = lt.random + _gather_self(cur_nodes, st.nodes, pre_i)

    mb_new = jnp.full_like(st.mb, NEG)
    ib_new = lt.random + _ladd(lt.MI + st.mb, lt.II + st.ib)

    pre_d = _ladd(lt.MD + m_new, lt.ID + i_new)
    fd0 = _lse_last(par_logt + _gather_prev(par_idx, cur_nodes, pre_d))
    fd0 = _ladd(fd0, init_lp + _ladd(lt.MD + mb_new, lt.ID + ib_new)[:, None])
    d_new = fd0
    fdt = fd0
    for _ in range(dm.n_max_gaps):
        fdt = _lse_last(par_logt + lt.DD + _gather_prev(par_idx, cur_nodes, fdt))
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


def _initial_active(dm: DeviceModel, batch: int, n_top: int) -> jnp.ndarray:
    """Initial active set: nodes with highest init prob (the Begin state can
    reach any node, weighted by init_logp)."""
    k = min(n_top * (dm.child_idx.shape[1] + 1), dm.init_logp.shape[0])
    vals, ids = jax.lax.top_k(dm.init_logp, k)
    ids = jnp.where(jnp.isfinite(vals), ids, -1)
    return jnp.tile(ids[None], (batch, 1)).astype(jnp.int32)


def _dense_to_sparse(fstate, A: int) -> SState:
    """Compact a dense FState [B, n] into the top-A active-set SState."""
    merged = _ladd3(fstate.m, fstate.i, fstate.d)  # [B, n]
    k = min(A, merged.shape[1])
    top_vals, top_ids = jax.lax.top_k(merged, k)
    nodes = jnp.where(jnp.isfinite(top_vals), top_ids, -1).astype(jnp.int32)
    take = lambda tab: jnp.where(
        nodes >= 0, jnp.take_along_axis(tab, top_ids, axis=1), NEG
    )
    B = merged.shape[0]
    if k < A:
        pad_n = jnp.full((B, A - k), -1, dtype=jnp.int32)
        pad_v = jnp.full((B, A - k), NEG, dtype=fstate.m.dtype)
        nodes = jnp.concatenate([nodes, pad_n], axis=1)
        m = jnp.concatenate([take(fstate.m), pad_v], axis=1)
        i = jnp.concatenate([take(fstate.i), pad_v], axis=1)
        d = jnp.concatenate([take(fstate.d), pad_v], axis=1)
    else:
        m, i, d = take(fstate.m), take(fstate.i), take(fstate.d)
    return SState(
        nodes=nodes, m=m, i=i, d=d,
        mb=fstate.mb, ib=fstate.ib, e=fstate.e,
        off=fstate.off, off_c=fstate.off_c,
    )


class AdaptiveTables(NamedTuple):
    nodes: jnp.ndarray  # [L, B, K]
    m: jnp.ndarray  # [L, B, K] (possibly a reduced storage dtype)
    i: jnp.ndarray
    d: jnp.ndarray
    off: jnp.ndarray  # [L, B]
    e: jnp.ndarray  # [B] final score (with offset applied)


@functools.partial(
    jax.jit,
    static_argnames=("n_top", "n_warmup", "max_ratio", "stored_k",
                     "store_bf16"),
)
def forward_sparse_adaptive(
    dm: DeviceModel,
    codes: jnp.ndarray,
    lens: jnp.ndarray,
    n_top: int = 40,
    n_warmup: int = 16,
    max_ratio: float = None,
    stored_k: int = None,
    store_bf16: bool = False,
) -> AdaptiveTables:
    """Sparse-adaptive forward storing per-step active tables.

    The first ``n_warmup`` positions run DENSE (exact) before compacting the
    table to the top active set and continuing sparsely — the analog of the
    reference's dense warmup region with adaptive early-switch
    (ref: forward.rs:119-138; params.rs n_warmup).  Stored per-step tables
    are the compacted top-A view.

    **Compact storage** (the decode's memory = batch-size lever): the scan
    CARRY always keeps the full A = n_top*(D+1) active set (recursion
    exactness unchanged), but the *stored* per-step tables can be trimmed
    to the ``stored_k`` top cells by forward mass and cast to bf16
    (``store_bf16``).  Stored tables only feed the backward-by-forward
    S-table decode (active-set selection); the read log-likelihood comes
    from the carry and is unaffected.  [L,B,A]x16B -> [L,B,K]x10B lets the
    read batch B grow ~2-5x against the same device memory, amortizing the
    fixed cost of each scan step over more reads.
    """
    from .forward import _f_init, _f_step

    B, L = codes.shape
    n = dm.init_logp.shape[0]
    A = min(n_top * (dm.child_idx.shape[1] + 1), n)
    dtype = dm.init_logp.dtype
    W = min(n_warmup, L)
    pos = jnp.arange(L, dtype=lens.dtype)
    K = A if stored_k is None else min(stored_k, A)
    sdt = jnp.bfloat16 if store_bf16 else dtype

    def emit(nodes, m, i, d, off):
        if K < nodes.shape[1]:
            key = jnp.where(nodes >= 0, jnp.maximum(jnp.maximum(m, i), d),
                            NEG)
            _, slots = jax.lax.top_k(key, K)
            g = lambda a: jnp.take_along_axis(a, slots, axis=1)
            nodes, m, i, d = g(nodes), g(m), g(i), g(d)
        return (nodes, m.astype(sdt), i.astype(sdt), d.astype(sdt), off)

    # phase 1: dense warmup, storing compacted top-A tables
    d0 = _f_init(B, n, dtype)

    def dense_body(st, xs):
        x, p = xs
        valid = p < lens
        st1 = _f_step(dm, st, x, valid, renorm=True)
        comp = _dense_to_sparse(st1, A)
        return st1, emit(comp.nodes, comp.m, comp.i, comp.d, comp.off)

    dfinal, dense_ys = jax.lax.scan(
        dense_body, d0, (codes[:, :W].T, pos[:W])
    )
    st_sparse = _dense_to_sparse(dfinal, A)

    # phase 2: sparse-adaptive continuation.  One packed attribute gather
    # per step (see _pack_model); children of the frontier come from the
    # carried attribute block.
    pk = _pack_model(dm)
    attrs0 = _gather_attrs(pk, st_sparse.nodes)

    def body(carry, xs):
        st, attrs = carry
        x, p = xs
        valid = p < lens
        cur = _next_active_attrs(dm, st, attrs, n_top, max_ratio)[:, :A]
        attrs1 = _gather_attrs(pk, cur)
        st1 = _s_step_attrs(dm, st, cur, attrs1, x, valid)
        attrs1 = jnp.where(valid[:, None, None], attrs1, attrs)
        return (st1, attrs1), emit(st1.nodes, st1.m, st1.i, st1.d, st1.off)

    (st, _attrs), sparse_ys = jax.lax.scan(
        body, (st_sparse, attrs0), (codes[:, W:].T, pos[W:])
    )
    ns, ms, is_, ds, offs = [
        jnp.concatenate([a, b], axis=0) for a, b in zip(dense_ys, sparse_ys)
    ]
    return AdaptiveTables(nodes=ns, m=ms, i=is_, d=ds, off=offs, e=st.e + st.off)


class BCarry(NamedTuple):
    nodes: jnp.ndarray  # [B, A]
    m: jnp.ndarray
    i: jnp.ndarray
    d: jnp.ndarray
    ib: jnp.ndarray  # [B]
    off: jnp.ndarray
    off_c: jnp.ndarray


def _b_step_sparse(dm: DeviceModel, st: BCarry, cur_nodes: jnp.ndarray,
                   attrs: jnp.ndarray, x: jnp.ndarray,
                   valid: jnp.ndarray) -> BCarry:
    """Backward step restricted to forward's active cells
    (ref: backward.rs:216-261 with active nodes from forward).  Child
    adjacency/emission come from one packed attribute gather."""
    lt = dm.lt
    D = dm.parent_idx.shape[1]
    c = _attr_cols(D)
    slot_ok = cur_nodes >= 0
    child_idx = attrs[..., c["cidx"]].astype(jnp.int32)  # [B, A, D]
    child_logt = jnp.where(slot_ok[:, :, None], attrs[..., c["clogt"]], NEG)
    emis_child = attrs[..., c["cemis"]].astype(jnp.int32)
    p_emit_child = jnp.where(emis_child == x[:, None, None], lt.match, lt.mismatch)

    bm_next = _gather_prev(child_idx, st.nodes, st.m)  # [B, A, D]
    bi_self = _gather_self(cur_nodes, st.nodes, st.i)  # [B, A]

    # bd closure
    bd0 = _lse_last(child_logt + lt.DM + p_emit_child + bm_next)
    bd0 = _ladd(bd0, lt.DI + lt.random + bi_self)
    d_new = bd0
    bdt = bd0
    for _ in range(dm.n_max_gaps):
        bdt = _lse_last(child_logt + lt.DD + _gather_prev(child_idx, cur_nodes, bdt))
        d_new = _ladd(d_new, bdt)

    bd_child = _gather_prev(child_idx, cur_nodes, d_new)  # [B, A, D]

    m_new = _lse_last(
        child_logt + _ladd(lt.MM + p_emit_child + bm_next, lt.MD + bd_child)
    )
    m_new = _ladd(m_new, lt.MI + lt.random + bi_self)
    i_new = _lse_last(
        child_logt + _ladd(lt.IM + p_emit_child + bm_next, lt.ID + bd_child)
    )
    i_new = _ladd(i_new, lt.II + lt.random + bi_self)

    ib_new = jnp.full_like(st.ib, NEG)  # not tracked sparsely (only needed
    # for begin-state full prob, which the mapping does not use)

    m_new = jnp.where(slot_ok, m_new, NEG)
    i_new = jnp.where(slot_ok, i_new, NEG)
    d_new = jnp.where(slot_ok, d_new, NEG)

    shift = jnp.max(m_new, axis=-1)
    shift = jnp.where(jnp.isfinite(shift) & valid, shift, 0.0)
    m_new = m_new - shift[:, None]
    i_new = i_new - shift[:, None]
    d_new = d_new - shift[:, None]
    off, off_c = st.off, st.off_c
    y = shift - off_c
    t = off + y
    off_c = (t - off) - y
    off = t

    v1 = valid[:, None]
    return BCarry(
        nodes=jnp.where(v1, cur_nodes, st.nodes),
        m=jnp.where(v1, m_new, st.m),
        i=jnp.where(v1, i_new, st.i),
        d=jnp.where(v1, d_new, st.d),
        ib=jnp.where(valid, ib_new, st.ib),
        off=jnp.where(valid, off, st.off),
        off_c=jnp.where(valid, off_c, st.off_c),
    )


def _decode_mappings_from_forward(
    dm: DeviceModel,
    codes: jnp.ndarray,
    lens: jnp.ndarray,
    f: AdaptiveTables,
    n_active: int,
    max_ratio,
):
    """Backward-by-forward + per-position top-k decode over stored forward
    tables (ref: backward.rs:101-142 backward_by_forward, table.rs:500-517).

    The S table at merged index i pairs F[i] (stored forward tables) with
    B[i] computed on the fly over F[i]'s active cells.
    """
    B, L = codes.shape
    dtype = dm.init_logp.dtype
    logp = f.e

    xs_rev_idx = lens[:, None] - 1 - jnp.arange(L)[None, :]
    idx_safe = jnp.clip(xs_rev_idx, 0, L - 1)
    xs_rev = jnp.where(
        xs_rev_idx >= 0,
        jnp.take_along_axis(codes, idx_safe, axis=1),
        -1,
    )

    z = jnp.zeros((B,), dtype=dtype)
    # B[n] init: m=i=d=p_end on all nodes -> represent on the final forward
    # active set (the only cells S[n] needs)
    final_nodes = jnp.take_along_axis(
        f.nodes, jnp.clip(lens - 1, 0, L - 1)[None, :, None], axis=0
    )[0]
    pe = jnp.where(final_nodes >= 0, dm.lt.end, NEG).astype(dtype)
    b0 = BCarry(
        nodes=final_nodes, m=pe, i=pe, d=pe,
        ib=jnp.full((B,), NEG, dtype=dtype), off=z, off_c=z,
    )

    pos = jnp.arange(L, dtype=lens.dtype)
    pk = _pack_model(dm)

    def body(carry, xs):
        bst, _ = carry
        x, t = xs
        valid = t < lens
        i_merge = lens - 1 - t  # merged index of the B table being produced
        # B[i] lives on F[i]'s active cells = forward tables at scan index
        # i-1 (tables[j] = F[j+1]); for i=0 use F[1]'s set (S[0] is
        # begin-state only, contributes no node mapping)
        i_f = jnp.clip(i_merge - 1, 0, L - 1)
        cur_nodes = jnp.take_along_axis(
            f.nodes, i_f[None, :, None], axis=0
        )[0]
        bst1 = _b_step_sparse(
            dm, bst, cur_nodes, _gather_attrs(pk, cur_nodes), x, valid
        )
        # S[i] = F[i] * B[i] / P on these cells
        fm = jnp.take_along_axis(f.m, i_f[None, :, None], axis=0)[0]
        fi = jnp.take_along_axis(f.i, i_f[None, :, None], axis=0)[0]
        fd = jnp.take_along_axis(f.d, i_f[None, :, None], axis=0)[0]
        foff = jnp.take_along_axis(f.off, i_f[None, :], axis=0)[0]
        is_init = i_merge <= 0
        scale = jnp.where(is_init, NEG, foff + bst1.off - logp)[:, None]
        s_lin = (
            jnp.exp(fm + bst1.m + scale)
            + jnp.exp(fi + bst1.i + scale)
            + jnp.exp(fd + bst1.d + scale)
        )
        s_log = jnp.where(s_lin > 0, jnp.log(jnp.maximum(s_lin, 1e-300)), NEG)
        k = min(n_active, s_log.shape[1])
        top_logp, top_slot = jax.lax.top_k(s_log, k)
        top_nodes = jnp.take_along_axis(cur_nodes, top_slot, axis=1)
        top_nodes = jnp.where(jnp.isfinite(top_logp), top_nodes, -1)
        top_logp, top_nodes = _ratio_mask(top_logp, top_nodes, max_ratio)
        return (bst1, None), (top_logp, top_nodes, i_merge, valid)

    (bf, _), (tops_logp, tops_nodes, i_merges, valids) = jax.lax.scan(
        body, (b0, None), (xs_rev.T, pos)
    )

    # scatter mapping into read-position order: S index i -> read pos i-1
    k = tops_logp.shape[2]
    j_pos = i_merges - 1
    ok = (j_pos >= 0) & valids
    j_write = jnp.where(ok, j_pos, L)
    map_logp = jnp.full((B, L, k), NEG, dtype=dtype)
    map_nodes = jnp.full((B, L, k), -1, dtype=jnp.int32)
    batch_ix = jnp.arange(B)[None, :].repeat(L, axis=0)
    map_logp = map_logp.at[batch_ix, j_write].set(tops_logp, mode="drop")
    map_nodes = map_nodes.at[batch_ix, j_write].set(tops_nodes, mode="drop")

    # read position len-1: S[len] = F[len] * B_init(p_end)
    fm_l = jnp.take_along_axis(f.m, jnp.clip(lens - 1, 0, L - 1)[None, :, None], axis=0)[0]
    fi_l = jnp.take_along_axis(f.i, jnp.clip(lens - 1, 0, L - 1)[None, :, None], axis=0)[0]
    fd_l = jnp.take_along_axis(f.d, jnp.clip(lens - 1, 0, L - 1)[None, :, None], axis=0)[0]
    foff_l = jnp.take_along_axis(f.off, jnp.clip(lens - 1, 0, L - 1)[None, :], axis=0)[0]
    scale_l = (foff_l + dm.lt.end - logp)[:, None]
    s_last = (
        jnp.exp(fm_l + scale_l) + jnp.exp(fi_l + scale_l) + jnp.exp(fd_l + scale_l)
    )
    s_last = jnp.where(final_nodes >= 0, s_last, 0.0)
    s_last_log = jnp.where(s_last > 0, jnp.log(jnp.maximum(s_last, 1e-300)), NEG)
    last_logp, last_slot = jax.lax.top_k(s_last_log, k)
    last_nodes = jnp.take_along_axis(final_nodes, last_slot, axis=1)
    last_nodes = jnp.where(jnp.isfinite(last_logp), last_nodes, -1)
    last_logp, last_nodes = _ratio_mask(last_logp, last_nodes, max_ratio)
    b_ar = jnp.arange(B)
    j_last = jnp.where(lens > 0, lens - 1, L)
    map_logp = map_logp.at[b_ar, j_last].set(last_logp, mode="drop")
    map_nodes = map_nodes.at[b_ar, j_last].set(last_nodes, mode="drop")

    return logp, map_nodes, map_logp


@functools.partial(
    jax.jit,
    static_argnames=("n_top", "n_active", "max_ratio", "n_warmup",
                     "stored_k", "store_bf16"),
)
def mappings_sparse_adaptive(
    dm: DeviceModel,
    codes: jnp.ndarray,
    lens: jnp.ndarray,
    n_top: int = 40,
    n_active: int = 40,
    max_ratio: float = None,
    n_warmup: int = 16,
    stored_k: int = None,
    store_bf16: bool = False,
):
    """Sparse-adaptive forward + backward-by-forward decode.

    Returns (logp [B], map_nodes [B, L, n_active], map_logp [B, L, n_active]).
    (ref: freq.rs:60 run_sparse_adaptive + hint.rs:124-142)
    """
    f = forward_sparse_adaptive(
        dm, codes, lens, n_top=n_top, max_ratio=max_ratio, n_warmup=n_warmup,
        stored_k=stored_k, store_bf16=store_bf16,
    )
    return _decode_mappings_from_forward(dm, codes, lens, f, n_active, max_ratio)


def forward_mapped_tables(
    dm: DeviceModel,
    codes: jnp.ndarray,
    lens: jnp.ndarray,
    map_nodes: jnp.ndarray,  # [B, L, A] int32, -1 pad
) -> AdaptiveTables:
    """Mapping-constrained forward storing per-step active tables — the
    table-keeping variant of ``forward_scores_mapped``
    (ref: forward.rs:51-77 forward_with_mapping)."""
    from .sparse import SState

    B, L = codes.shape
    A = map_nodes.shape[2]
    dtype = dm.init_logp.dtype
    z = jnp.zeros((B,), dtype=dtype)
    st0 = SState(
        nodes=jnp.full((B, A), -1, dtype=jnp.int32),
        m=jnp.full((B, A), NEG, dtype=dtype),
        i=jnp.full((B, A), NEG, dtype=dtype),
        d=jnp.full((B, A), NEG, dtype=dtype),
        mb=z, ib=jnp.full((B,), NEG, dtype=dtype),
        e=jnp.full((B,), NEG, dtype=dtype), off=z, off_c=z,
    )
    pos = jnp.arange(L, dtype=lens.dtype)
    pk = _pack_model(dm)

    def body(st, xs):
        x, nodes_t, p = xs
        valid = p < lens
        st1 = _s_step_attrs(dm, st, nodes_t, _gather_attrs(pk, nodes_t), x, valid)
        return st1, (st1.nodes, st1.m, st1.i, st1.d, st1.off)

    st, (ns, ms, is_, ds, offs) = jax.lax.scan(
        body, st0, (codes.T, jnp.swapaxes(map_nodes, 0, 1), pos)
    )
    return AdaptiveTables(nodes=ns, m=ms, i=is_, d=ds, off=offs, e=st.e + st.off)


@functools.partial(jax.jit, static_argnames=("n_active", "max_ratio"))
def mappings_refine(
    dm: DeviceModel,
    codes: jnp.ndarray,
    lens: jnp.ndarray,
    hint_nodes: jnp.ndarray,  # [B, L, Ah] int32, -1 pad
    n_active: int = 40,
    max_ratio: float = None,
):
    """Hint-seeded mapping regeneration: forward/backward restricted to the
    hint's per-base active sets, then score-ratio re-selection — the analog
    of the reference's ``run_with_mapping`` branch of generate_mappings
    (ref: hint.rs:206-216; posterior/test.rs:184-187 refine-after-extend).

    Returns (logp [B], map_nodes [B, L, n_active], map_logp).  ``logp`` is
    the mapping-constrained likelihood — callers can gate acceptance on it
    (reads whose hint collapsed score -inf / far below the previous k)."""
    f = forward_mapped_tables(dm, codes, lens, hint_nodes)
    return _decode_mappings_from_forward(dm, codes, lens, f, n_active, max_ratio)
