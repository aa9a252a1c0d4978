"""Dense batched PHMM forward/backward on device.

Implements the recursions of the reference's forward/backward algorithms
(ref: src/hmmv2/forward.rs:24-558, src/hmmv2/backward.rs:24-560) as batched
log-space ``lax.scan`` kernels over a padded-adjacency graph
(:class:`~dbgphmm_tpu.phmm.model.PHMMModel`).

State layout per read: ``m, i, d`` tables ``[B, n]`` plus scalars
``mb, ib, e`` — identical to the reference's PHMMTable (table.rs:42-73).
The deletion closure is the unrolled ``1 + n_max_gaps`` rounds of D-state
propagation within one emission step (forward.rs:423-524).

Renormalization: when ``renorm=True`` every step subtracts the per-read max
of the M table and accumulates the offset with Kahan compensation, keeping
f32 tables in range for arbitrarily long reads.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..phmm.model import PHMMModel, encode_bases

NEG = -jnp.inf


class LogTrans(NamedTuple):
    """Scalar log transition/emission probs (traced, so changing the error
    rate does not trigger recompilation)."""

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


import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """PHMM arrays on device.  ``n_max_gaps`` is static metadata (it unrolls
    the deletion closure), everything else is traced."""

    emission: jnp.ndarray  # int32 [n] (4 = silent)
    init_logp: jnp.ndarray  # [n]
    parent_idx: jnp.ndarray  # int32 [n, D]
    parent_logt: jnp.ndarray  # [n, D]
    child_idx: jnp.ndarray  # int32 [n, D]
    child_logt: jnp.ndarray  # [n, D]
    lt: LogTrans
    n_max_gaps: int  # static


jax.tree_util.register_dataclass(
    DeviceModel,
    data_fields=[
        "emission", "init_logp", "parent_idx", "parent_logt",
        "child_idx", "child_logt", "lt",
    ],
    meta_fields=["n_max_gaps"],
)


def default_dtype():
    """f64 on CPU (exact; matches the reference's strict logaddexp numerics,
    prob.rs:181-203), f32 on accelerator backends: every kernel here
    renormalizes per step so f32 holds arbitrarily long reads, and f32
    halves the bytes each step moves.  The system's first accelerator had
    no native f64; the GPU does, and what f64 would cost there has not
    been measured."""
    import jax

    return jnp.float64 if jax.default_backend() == "cpu" else jnp.float32


def bucketize(n: int, ratio: float = 1.2, align: int = 128) -> int:
    """Round n up to a geometric bucket (multiples of ``align``), so jitted
    kernels keep stable shapes as the graph grows across k (the
    recompilation-discipline hard part, SURVEY.md section 7).  The 128
    alignment comes from the first accelerator's lane width and is kept so
    shapes, and so compiled programs, are unchanged."""
    b = align
    while b < n:
        b = max(b + align, int(-(-b * ratio // align) * align))
    return b


def pad_model(model: PHMMModel, n_bucket: Optional[int] = None,
              d_bucket: Optional[int] = None) -> PHMMModel:
    """Pad node count / degree to buckets with inert entries (silent
    emission, -inf probs, self-parents at node 0)."""
    import dataclasses

    n, D = model.parent_idx.shape
    nb = n_bucket if n_bucket is not None else bucketize(n)
    db = d_bucket if d_bucket is not None else (2 if D <= 2 else (5 if D <= 5 else bucketize(D, align=1)))
    if nb == n and db == D:
        return model

    def pad_nodes(arr, fill):
        out = np.full((nb,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[:n] = arr
        return out

    def pad_adj(idx, logt):
        idx2 = np.zeros((nb, db), dtype=idx.dtype)
        logt2 = np.full((nb, db), -np.inf, dtype=logt.dtype)
        idx2[:n, :D] = idx
        logt2[:n, :D] = logt
        return idx2, logt2

    pi, pl = pad_adj(model.parent_idx, model.parent_logt)
    ci, cl = pad_adj(model.child_idx, model.child_logt)
    return dataclasses.replace(
        model,
        emission=pad_nodes(model.emission, 4),
        init_logp=pad_nodes(model.init_logp, -np.inf),
        parent_idx=pi, parent_logt=pl, child_idx=ci, child_logt=cl,
    )


def to_device(model: PHMMModel, dtype=jnp.float32, pad: bool = True) -> DeviceModel:
    if pad:
        model = pad_model(model)
    logs = model.params.log_transitions()
    as_d = lambda v: jnp.asarray(v, dtype=dtype)
    lt = LogTrans(
        MM=as_d(logs["p_MM"]), IM=as_d(logs["p_IM"]), DM=as_d(logs["p_DM"]),
        MI=as_d(logs["p_MI"]), II=as_d(logs["p_II"]), DI=as_d(logs["p_DI"]),
        MD=as_d(logs["p_MD"]), ID=as_d(logs["p_ID"]), DD=as_d(logs["p_DD"]),
        match=as_d(logs["p_match"]), mismatch=as_d(logs["p_mismatch"]),
        random=as_d(logs["p_random"]), end=as_d(logs["p_end"]),
    )
    return DeviceModel(
        emission=jnp.asarray(model.emission, dtype=jnp.int32),
        init_logp=as_d(model.init_logp),
        parent_idx=jnp.asarray(model.parent_idx, dtype=jnp.int32),
        parent_logt=as_d(model.parent_logt),
        child_idx=jnp.asarray(model.child_idx, dtype=jnp.int32),
        child_logt=as_d(model.child_logt),
        lt=lt,
        n_max_gaps=model.params.n_max_gaps,
    )


def pad_reads(reads: Sequence[bytes], pad_to: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Encode + right-pad reads: returns (codes [B, L] int32 with -1 padding,
    lens [B] int32)."""
    lens = np.array([len(r) for r in reads], dtype=np.int32)
    L = int(pad_to if pad_to is not None else (lens.max() if len(lens) else 0))
    codes = np.full((len(reads), L), -1, dtype=np.int32)
    for b, r in enumerate(reads):
        codes[b, : len(r)] = encode_bases(r)
    return codes, lens


# -- log-space primitives ------------------------------------------------------


def _ladd(x, y):
    return jnp.logaddexp(x, y)


def _ladd3(x, y, z):
    return jnp.logaddexp(jnp.logaddexp(x, y), z)


def _lse_deg(x):
    """logsumexp over the trailing degree axis, -inf-safe."""
    m = jnp.max(x, axis=-1)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out = m_safe + jnp.log(jnp.sum(jnp.exp(x - m_safe[..., None]), axis=-1))
    return jnp.where(jnp.isfinite(m), out, NEG)


def _lse_nodes(x):
    """logsumexp over the node axis (last)."""
    return _lse_deg(x)


# -- forward ------------------------------------------------------------------


class FState(NamedTuple):
    m: jnp.ndarray  # [B, n]
    i: jnp.ndarray  # [B, n]
    d: jnp.ndarray  # [B, n]
    mb: jnp.ndarray  # [B]
    ib: jnp.ndarray  # [B]
    e: jnp.ndarray  # [B]
    off: jnp.ndarray  # [B] cumulative renorm offset
    off_c: jnp.ndarray  # [B] Kahan compensation


def _f_init(batch: int, n: int, dtype) -> FState:
    z = jnp.zeros((batch,), dtype=dtype)
    neg = jnp.full((batch, n), NEG, dtype=dtype)
    return FState(m=neg, i=neg, d=neg, mb=z, ib=jnp.full((batch,), NEG, dtype=dtype),
                  e=jnp.full((batch,), NEG, dtype=dtype), off=z, off_c=z)


def _p_match_emit(dm: DeviceModel, x: jnp.ndarray) -> jnp.ndarray:
    """[B, n] log emission prob of observing x from Match of each node
    (ref: common.rs:168-174)."""
    return jnp.where(dm.emission[None, :] == x[:, None], dm.lt.match, dm.lt.mismatch)


def _f_step(dm: DeviceModel, st: FState, x: jnp.ndarray, valid: jnp.ndarray,
            renorm: bool) -> FState:
    """One forward emission step (ref: forward.rs:276-306 f_step)."""
    lt = dm.lt
    # fm (forward.rs:337-359)
    pm = st.m[:, dm.parent_idx]  # [B, n, D]
    pi = st.i[:, dm.parent_idx]
    pd = st.d[:, dm.parent_idx]
    inner = _ladd3(lt.MM + pm, lt.IM + pi, lt.DM + pd)
    from_normal = _lse_deg(dm.parent_logt[None] + inner)  # [B, n]
    from_begin = dm.init_logp[None] + _ladd(lt.MM + st.mb, lt.IM + st.ib)[:, None]
    m_new = _p_match_emit(dm, x) + _ladd(from_normal, from_begin)

    # fi (forward.rs:378-388): self transition from prev table
    i_new = lt.random + _ladd3(lt.MI + st.m, lt.II + st.i, lt.DI + st.d)

    # fmb/fib (forward.rs:531-545)
    mb_new = jnp.full_like(st.mb, NEG)
    ib_new = lt.random + _ladd(lt.MI + st.mb, lt.II + st.ib)

    # fd: deletion closure, 1 + n_max_gaps rounds (forward.rs:423-524)
    fm_par = m_new[:, dm.parent_idx]
    fi_par = i_new[:, dm.parent_idx]
    fd0 = _lse_deg(dm.parent_logt[None] + _ladd(lt.MD + fm_par, lt.ID + fi_par))
    fd0 = _ladd(fd0, dm.init_logp[None] + _ladd(lt.MD + mb_new, lt.ID + ib_new)[:, None])
    d_new = fd0
    fdt = fd0
    for _ in range(dm.n_max_gaps):
        fdt = _lse_deg(dm.parent_logt[None] + lt.DD + fdt[:, dm.parent_idx])
        d_new = _ladd(d_new, fdt)

    # fe (forward.rs:554-558)
    e_new = lt.end + _lse_nodes(_ladd3(m_new, i_new, d_new))

    off, off_c = st.off, st.off_c
    if renorm:
        shift = jnp.max(m_new, axis=-1)  # [B]
        shift = jnp.where(jnp.isfinite(shift) & valid, shift, 0.0)
        m_new = m_new - shift[:, None]
        i_new = i_new - shift[:, None]
        d_new = d_new - shift[:, None]
        mb_new = mb_new - shift
        ib_new = ib_new - shift
        e_new = e_new - shift
        # Kahan accumulate total offset
        y = shift - off_c
        t = off + y
        off_c = (t - off) - y
        off = t

    v1 = valid[:, None]
    return FState(
        m=jnp.where(v1, m_new, st.m),
        i=jnp.where(v1, i_new, st.i),
        d=jnp.where(v1, d_new, st.d),
        mb=jnp.where(valid, mb_new, st.mb),
        ib=jnp.where(valid, ib_new, st.ib),
        e=jnp.where(valid, e_new, st.e),
        off=jnp.where(valid, off, st.off),
        off_c=jnp.where(valid, off_c, st.off_c),
    )


@functools.partial(jax.jit, static_argnames=("renorm",))
def forward_scores(dm: DeviceModel, codes: jnp.ndarray, lens: jnp.ndarray,
                   renorm: bool = True) -> jnp.ndarray:
    """Log P(read) for each read — score-only forward
    (ref: forward.rs:158-206 forward_sparse_score_only, dense mode).

    ``codes``: int32 [B, L] with -1 padding; ``lens``: [B].
    """
    B, L = codes.shape
    n = dm.emission.shape[0]
    dtype = dm.init_logp.dtype
    st0 = _f_init(B, n, dtype)
    pos = jnp.arange(L, dtype=lens.dtype)

    def body(st, xs):
        x, p = xs
        valid = p < lens
        return _f_step(dm, st, x, valid, renorm), None

    st, _ = jax.lax.scan(body, st0, (codes.T, pos))
    return st.e + st.off


@functools.partial(jax.jit, static_argnames=("renorm",))
def forward_tables(dm: DeviceModel, codes: jnp.ndarray, lens: jnp.ndarray,
                   renorm: bool = True):
    """Full forward pass storing per-position tables.

    Returns ``(final_state, tables)`` where ``tables`` is an FState with a
    leading position axis [L, ...]; tables[t] = F[t+1] (merged index t+1).
    """
    B, L = codes.shape
    n = dm.emission.shape[0]
    st0 = _f_init(B, n, dm.init_logp.dtype)
    pos = jnp.arange(L, dtype=lens.dtype)

    def body(st, xs):
        x, p = xs
        valid = p < lens
        st1 = _f_step(dm, st, x, valid, renorm)
        return st1, st1

    final, tables = jax.lax.scan(body, st0, (codes.T, pos))
    return final, tables


# -- backward -----------------------------------------------------------------


class BState(NamedTuple):
    m: jnp.ndarray  # [B, n]
    i: jnp.ndarray
    d: jnp.ndarray
    mb: jnp.ndarray  # [B]
    ib: jnp.ndarray  # [B]
    off: jnp.ndarray
    off_c: jnp.ndarray


def _b_init(dm: DeviceModel, batch: int, n: int, dtype) -> BState:
    """ref: backward.rs:197-211 — m=i=d=p_end, mb=ib=0."""
    pe = jnp.full((batch, n), dm.lt.end, dtype=dtype)
    neg = jnp.full((batch,), NEG, dtype=dtype)
    z = jnp.zeros((batch,), dtype=dtype)
    return BState(m=pe, i=pe, d=pe, mb=neg, ib=neg, off=z, off_c=z)


def _b_step(dm: DeviceModel, st: BState, x: jnp.ndarray, valid: jnp.ndarray,
            renorm: bool) -> BState:
    """One backward step for emission x (ref: backward.rs:216-261 b_step).

    ``st`` is B[i+1]; the result is B[i].
    """
    lt = dm.lt
    p_emit = _p_match_emit(dm, x)  # [B, n]
    p_emit_child = p_emit[:, dm.child_idx]  # [B, n, D] emission prob at child
    bm_next_child = st.m[:, dm.child_idx]  # [B, n, D]

    # bd first (backward.rs:299-404)
    bd0 = _lse_deg(dm.child_logt[None] + lt.DM + p_emit_child + bm_next_child)
    bd0 = _ladd(bd0, lt.DI + lt.random + st.i)
    d_new = bd0
    bdt = bd0
    for _ in range(dm.n_max_gaps):
        bdt = _lse_deg(dm.child_logt[None] + lt.DD + bdt[:, dm.child_idx])
        d_new = _ladd(d_new, bdt)

    bd_child = d_new[:, dm.child_idx]  # [B, n, D]

    # bm (backward.rs:423-444)
    m_new = _lse_deg(
        dm.child_logt[None]
        + _ladd(lt.MM + p_emit_child + bm_next_child, lt.MD + bd_child)
    )
    m_new = _ladd(m_new, lt.MI + lt.random + st.i)

    # bi (backward.rs:462-483)
    i_new = _lse_deg(
        dm.child_logt[None]
        + _ladd(lt.IM + p_emit_child + bm_next_child, lt.ID + bd_child)
    )
    i_new = _ladd(i_new, lt.II + lt.random + st.i)

    # bmb / bib (backward.rs:499-555): begin states over all nodes
    mb_new = _lse_nodes(
        dm.init_logp[None] + _ladd(lt.MM + p_emit + st.m, lt.MD + d_new)
    )
    mb_new = _ladd(mb_new, lt.MI + lt.random + st.ib)
    ib_new = _lse_nodes(
        dm.init_logp[None] + _ladd(lt.IM + p_emit + st.m, lt.ID + d_new)
    )
    ib_new = _ladd(ib_new, lt.II + lt.random + st.ib)

    off, off_c = st.off, st.off_c
    if renorm:
        shift = jnp.max(m_new, axis=-1)
        shift = jnp.where(jnp.isfinite(shift) & valid, shift, 0.0)
        m_new = m_new - shift[:, None]
        i_new = i_new - shift[:, None]
        d_new = d_new - shift[:, None]
        mb_new = mb_new - shift
        ib_new = ib_new - shift
        y = shift - off_c
        t = off + y
        off_c = (t - off) - y
        off = t

    v1 = valid[:, None]
    return BState(
        m=jnp.where(v1, m_new, st.m),
        i=jnp.where(v1, i_new, st.i),
        d=jnp.where(v1, d_new, st.d),
        mb=jnp.where(valid, mb_new, st.mb),
        ib=jnp.where(valid, ib_new, st.ib),
        off=jnp.where(valid, off, st.off),
        off_c=jnp.where(valid, off_c, st.off_c),
    )


def _reverse_codes(codes: jnp.ndarray, lens: jnp.ndarray) -> jnp.ndarray:
    """Per-read reversal within its own length; padding stays at the tail."""
    B, L = codes.shape
    idx = lens[:, None] - 1 - jnp.arange(L)[None, :]
    idx_safe = jnp.clip(idx, 0, L - 1)
    rev = jnp.take_along_axis(codes, idx_safe, axis=1)
    return jnp.where(idx >= 0, rev, -1)


@functools.partial(jax.jit, static_argnames=("renorm",))
def backward_tables(dm: DeviceModel, codes: jnp.ndarray, lens: jnp.ndarray,
                    renorm: bool = True):
    """Full backward pass.

    Returns ``(final_state, tables)``; ``tables`` has leading axis [L] in
    *reversed scan order*: tables[t] = B[len_b - 1 - t] for read b (valid for
    t < len_b).  ``final_state`` is B[0].
    """
    B, L = codes.shape
    n = dm.emission.shape[0]
    st0 = _b_init(dm, B, n, dm.init_logp.dtype)
    xs_rev = _reverse_codes(codes, lens)
    pos = jnp.arange(L, dtype=lens.dtype)

    def body(st, xs):
        x, p = xs
        valid = p < lens
        st1 = _b_step(dm, st, x, valid, renorm)
        return st1, st1

    final, tables = jax.lax.scan(body, st0, (xs_rev.T, pos))
    return final, tables


@functools.partial(jax.jit, static_argnames=("renorm",))
def full_prob_backward(dm: DeviceModel, codes: jnp.ndarray, lens: jnp.ndarray,
                       renorm: bool = True) -> jnp.ndarray:
    """Log P(read) from the backward pass (= B[0].mb, ref: table.rs:395-401)."""
    final, _ = backward_tables(dm, codes, lens, renorm=renorm)
    return final.mb + final.off


# -- state probabilities / node freqs / mappings -------------------------------


def _ratio_mask(top_logp, top_idx, max_ratio):
    """Score-ratio selection (ref: hint.rs:135-142 to_mapping_by_score_ratio,
    table.rs:134-149 top_nodes_by_score_ratio): keep only slots within
    ``max_ratio`` log units of the per-position max; the top-k width is the
    fixed-shape CAP (the analog of MAX_ACTIVE_NODES=400, table.rs:22), the
    ratio sets the variable effective width."""
    if max_ratio is None:
        return top_logp, top_idx
    thr = top_logp[..., :1] - max_ratio
    keep = jnp.isfinite(top_logp) & (top_logp >= thr)
    return jnp.where(keep, top_logp, NEG), jnp.where(keep, top_idx, -1)


@functools.partial(jax.jit, static_argnames=("renorm", "n_active", "max_ratio"))
def node_freqs_and_mappings(
    dm: DeviceModel,
    codes: jnp.ndarray,
    lens: jnp.ndarray,
    renorm: bool = True,
    n_active: int = 40,
    max_ratio: Optional[float] = None,
):
    """Posterior state decoding: expected node usages + per-position top-k
    mapping (ref: freq.rs:245 to_node_freqs, hint.rs:124-131 to_mapping;
    with ``max_ratio`` the reference's score-ratio variant hint.rs:135-142).

    Returns (logp [B], node_freqs [B, n] linear, map_nodes [B, L, A] int32,
    map_logp [B, L, A]).  map entries for position i of read b hold the top-k
    nodes of the emit-prob table S[i+1] = F[i+1] * B[i+1] / P; padded with
    node -1 / -inf beyond read length.
    """
    B, L = codes.shape
    n = dm.emission.shape[0]
    n_active = min(n_active, n)
    dtype = dm.init_logp.dtype

    f_final, f_tabs = forward_tables(dm, codes, lens, renorm=renorm)
    logp = f_final.e + f_final.off

    # backward scan; combine with stored forward tables on the fly
    st0 = _b_init(dm, B, n, dtype)
    xs_rev = _reverse_codes(codes, lens)
    pos = jnp.arange(L, dtype=lens.dtype)

    # S[n] term: F[len] * B_init / P  (merged index n)
    b0 = st0
    fm, fi, fd = f_final.m, f_final.i, f_final.d
    f_off = f_final.off
    s_last = (
        jnp.exp(fm + b0.m + (f_off - logp)[:, None])
        + jnp.exp(fi + b0.i + (f_off - logp)[:, None])
        + jnp.exp(fd + b0.d + (f_off - logp)[:, None])
    )
    freq0 = s_last  # [B, n]

    def body(carry, xs):
        bst, freq = carry
        x, t = xs
        valid = t < lens
        bst1 = _b_step(dm, bst, x, valid, renorm)
        # bst1 is B[i] with i = len_b - 1 - t  (per read)
        i_merge = lens - 1 - t  # merged index of B table (= S index i)
        # F[i] = init (i==0) or f_tabs[i-1]
        i_f = jnp.clip(i_merge - 1, 0, L - 1)
        fm_i = jnp.take_along_axis(
            f_tabs.m, i_f[None, :, None], axis=0
        )[0]  # [B, n]
        fi_i = jnp.take_along_axis(f_tabs.i, i_f[None, :, None], axis=0)[0]
        fd_i = jnp.take_along_axis(f_tabs.d, i_f[None, :, None], axis=0)[0]
        foff_i = jnp.take_along_axis(f_tabs.off, i_f[None, :], axis=0)[0]
        is_init = i_merge == 0
        fm_i = jnp.where(is_init[:, None], NEG, fm_i)
        fi_i = jnp.where(is_init[:, None], NEG, fi_i)
        fd_i = jnp.where(is_init[:, None], NEG, fd_i)
        foff_i = jnp.where(is_init, 0.0, foff_i)

        scale = (foff_i + bst1.off - logp)[:, None]
        s_log_m = fm_i + bst1.m + scale
        s_log_i = fi_i + bst1.i + scale
        s_log_d = fd_i + bst1.d + scale
        s_lin = jnp.exp(s_log_m) + jnp.exp(s_log_i) + jnp.exp(s_log_d)
        # begin-state contribution to freqs is not per-node; node freqs only.
        freq = freq + jnp.where(valid[:, None], s_lin, 0.0)

        # mapping at S index i (merged) corresponds to read position i-1;
        # emit for map built from node-merged m+i+d
        s_node_log = jnp.log(jnp.maximum(s_lin, 1e-300))
        s_node_log = jnp.where(s_lin > 0, s_node_log, NEG)
        top_logp, top_idx = jax.lax.top_k(s_node_log, n_active)
        top_idx = jnp.where(jnp.isfinite(top_logp), top_idx, -1)
        top_logp, top_idx = _ratio_mask(top_logp, top_idx, max_ratio)
        return (bst1, freq), (top_logp, top_idx, i_merge, valid)

    (b_final, freqs), (tops_logp, tops_idx, i_merges, valids) = jax.lax.scan(
        body, (st0, freq0), (xs_rev.T, pos)
    )
    # S[0] (init x init) contributes only begin states -> no node freqs.

    # re-order mapping from scan order to read-position order:
    # scan step t for read b holds S index i = len_b-1-t, i.e. read position
    # i-1 = len_b-2-t?? -- NO: mapping.nodes(j) (read position j, 0-based)
    # uses merged index j+1; scan step t has merged i = len_b-1-t, so read
    # position j = i-1 = len_b-2-t... but t ranges to len_b-1 giving j=-1 (S[0],
    # skipped).  Scatter by j.
    j_pos = i_merges - 1  # [L, B]
    ok = (j_pos >= 0) & valids
    # out-of-range index for not-ok entries -> dropped by scatter mode="drop"
    j_write = jnp.where(ok, j_pos, L)
    map_logp = jnp.full((B, L, n_active), NEG, dtype=dtype)
    map_nodes = jnp.full((B, L, n_active), -1, dtype=jnp.int32)
    batch_ix = jnp.arange(B)[None, :].repeat(L, axis=0)  # [L, B]
    map_logp = map_logp.at[batch_ix, j_write].set(tops_logp, mode="drop")
    map_nodes = map_nodes.at[batch_ix, j_write].set(tops_idx, mode="drop")

    # read position len-1 maps to merged index len: S[len] = F[len] * B_init
    s_last_log = jnp.where(s_last > 0, jnp.log(jnp.maximum(s_last, 1e-300)), NEG)
    last_logp, last_idx = jax.lax.top_k(s_last_log, n_active)
    last_idx = jnp.where(jnp.isfinite(last_logp), last_idx, -1)
    last_logp, last_idx = _ratio_mask(last_logp, last_idx, max_ratio)
    b_ar = jnp.arange(B)
    j_last = jnp.where(lens > 0, lens - 1, L)
    map_logp = map_logp.at[b_ar, j_last].set(last_logp, mode="drop")
    map_nodes = map_nodes.at[b_ar, j_last].set(last_idx, mode="drop")
    return logp, freqs, map_nodes, map_logp
