"""Full-scan mapped scoring kernel for the GPU (Pallas, Triton route).

One program scores one (candidate, read) pair over the WHOLE read: the
position loop runs inside the program (``lax.fori_loop`` up to the read's own
length), so the [A] M/I/D tables stay in registers for all L steps instead of
round-tripping through device memory once per step as the XLA scan does
(:class:`dbgphmm_tpu.ops.batch.XlaMappedScorer`, the plain reference).  The
grid is (candidates, reads); programs are independent.

The key enabler is the **compact-table trick**: all candidate dependence of
the PHMM compresses to the copy-number vector over compact edges
(``eff [C, NC]``, NC ~ 100s-1000s, a few KB per candidate — it stays in L1).
Per-slot transition/init probabilities are derived in-kernel from eff
lookups:

    t_val[a]  = eff[num_ce[a]] / sum_d eff[den_ce[a, d]]
    init_p[a] = eff[num_ce[a]] * inv_total[c]

so the [n, D] model arrays never enter the kernel.

Math is the strict log-space recursion of ``ops.sparse._s_step_pos``
(ref: forward.rs:276-306) in f32, with per-step max renormalization and
Kahan-compensated sums for the offset and the Begin-insert chain.  Slot-to-slot lookups ("which slot of the
previous step holds my parent") are exact selections done in registers: an
[A, A] compare of the index vector against the slot iota, a select and a max
over the source axis.  The Triton route has no in-register gather; the
select-max costs A^2 per lookup but needs no shared-memory round trip or
barrier.

Stream layouts (host-built by :func:`build_streams`), position-major with
the D axis split out so each step reads contiguous [A] rows:

    codes   [L, B]          int8
    emis    [L, B, A]       int8   (emission code per slot; 9 = empty)
    numce   [L, B, A]       int16  (compact edge id; NC-1 = sentinel, eff 0)
    selfp   [L, B, A]       int8   (slot in previous step holding this node)
    prevp   [L, D, B, A]    int8   (slot of parent d in previous step)
    curp    [L, D, B, A]    int8   (slot of parent d in current step)
    dence   [L, D, B, A]    int16  (compact ids of src-node child edges)
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEGF = -1e30  # finite stand-in for log 0 inside the kernel (no inf - inf)

CAND_SUB = 64  # candidates per launch at most; fewer pad to a power of two


class MappedStreams(NamedTuple):
    codes: np.ndarray  # [L, B] int8
    emis: np.ndarray  # [L, B, A]
    numce: np.ndarray  # [L, B, A]
    selfp: np.ndarray  # [L, B, A]
    prevp: np.ndarray  # [L, D, B, A]
    curp: np.ndarray  # [L, D, B, A]
    dence: np.ndarray  # [L, D, B, A]
    lens: np.ndarray  # [B] int32
    nc_pad: int  # padded compact-edge table width (sentinel = nc_pad-1)
    emittable_len_full: np.ndarray  # [nc] f32: #emittable kmers per compact edge
    # NC-trim: when set, numce/dence hold LOCAL ids into ce_ids (the compact
    # edges this read chunk actually references) instead of global compact
    # ids, and eff tables are built as eff[cn][ce_ids].  The normalizing
    # total still comes from the FULL assignment via emittable_len_full.
    ce_ids: np.ndarray = None  # [n_used] int32 global compact ids, or None


def build_streams(
    template,
    positions,
    codes: np.ndarray,
    lens: np.ndarray,
    b_pad: int = 1,
    a_pad: int = 16,
) -> MappedStreams:
    """Host-side stream construction from a PHMMTemplate + MappedPositions.

    The slot width is bucketed to the next power of two >= max(a_pad, A0):
    Triton tensors have power-of-two sizes, and few buckets mean few compile
    variants per run.  Reads are padded to a multiple of ``b_pad`` (the mesh's
    read-shard count) with empty reads."""
    mn = positions.map_nodes  # [B, L, A0]
    B, L, A0 = mn.shape
    D = template.parent_idx.shape[1]
    A = max(a_pad, 1 << max(0, (A0 - 1)).bit_length())
    Bp = -(-B // b_pad) * b_pad

    f2c = template.full_to_compact.astype(np.int32)
    nc = int(f2c.max()) + 1 if f2c.size else 1
    nc_pad = max(128, 1 << (nc + 1).bit_length())
    SENT = nc_pad - 1

    # per full-edge tables
    emit_ok = template.emittable
    num_tab = np.where(emit_ok, f2c, SENT).astype(np.int32)
    # child edges of the SOURCE node of each edge = sibling out-edges
    # (vectorized: stable-sort emittable edges by source node, then place
    # each edge at its within-group rank)
    src_out = np.full((template.n_nodes_graph, D), SENT, dtype=np.int32)
    ee = np.nonzero(emit_ok)[0]
    order = np.argsort(template.src_node[ee], kind="stable")
    ee = ee[order]
    srcs = template.src_node[ee]
    # rank within equal-src runs
    first = np.ones(len(ee), dtype=bool)
    first[1:] = srcs[1:] != srcs[:-1]
    run_start = np.maximum.accumulate(np.where(first, np.arange(len(ee)), 0))
    rank = np.arange(len(ee)) - run_start
    keep = rank < D
    src_out[srcs[keep], rank[keep]] = f2c[ee[keep]]
    den_tab = src_out[template.src_node]  # [n, D]

    emit_code = np.where(emit_ok, template.emission.astype(np.int32), 9)

    # narrow stream dtypes: slot indices fit int8 (A <= 128 -> max 127),
    # compact-edge ids fit int16 up to nc_pad=32768; the kernel widens them
    # as it loads.  Narrow streams cut the host->device upload and the bytes
    # each kernel step reads.
    slot_dt = np.int8 if A <= 128 else np.int16
    ce_dt = np.int16 if nc_pad <= 32768 else np.int32

    def pad_BA(arr, fill, dt=slot_dt):
        out = np.full((L, Bp, A), fill, dtype=dt)
        out[:, :B, :A0] = arr
        return out

    mnT = np.swapaxes(mn, 0, 1)  # [L, B, A0]
    ok = mnT >= 0
    safe = np.where(ok, mnT, 0)

    emis = pad_BA(np.where(ok, emit_code[safe], 9), 9)
    numce = pad_BA(np.where(ok, num_tab[safe], SENT), SENT, dt=ce_dt)
    selfp = pad_BA(np.swapaxes(positions.self_pos, 0, 1), -1)

    prevp = np.full((L, D, Bp, A), -1, dtype=slot_dt)
    curp = np.full((L, D, Bp, A), -1, dtype=slot_dt)
    dence = np.full((L, D, Bp, A), SENT, dtype=ce_dt)
    ppT = np.swapaxes(positions.prev_pos, 0, 1)  # [L, B, A0, D]
    cpT = np.swapaxes(positions.cur_pos, 0, 1)
    den_g = np.where(ok[..., None], den_tab[safe], SENT)  # [L, B, A0, D]
    for d in range(D):
        prevp[:, d, :B, :A0] = ppT[:, :, :, d]
        curp[:, d, :B, :A0] = cpT[:, :, :, d]
        dence[:, d, :B, :A0] = den_g[:, :, :, d]

    # drop structurally-empty trailing degree columns (the template pads
    # degree to the {2,5} bucket; real DBG parent degree is <= 4 and often
    # 2-3 — each dropped column removes lookups from every kernel step and
    # a [L, B, A] stream from device memory)
    d_used = 1
    for d in range(D - 1, 0, -1):
        if (prevp[:, d] >= 0).any() or (curp[:, d] >= 0).any() or (
            dence[:, d] != SENT
        ).any():
            d_used = d + 1
            break
    if d_used < D:
        prevp = np.ascontiguousarray(prevp[:, :d_used])
        curp = np.ascontiguousarray(curp[:, :d_used])
        dence = np.ascontiguousarray(dence[:, :d_used])

    codes_T = np.full((L, Bp), -1, dtype=np.int8)
    codes_T[:, :B] = np.swapaxes(codes, 0, 1)
    lens_p = np.zeros(Bp, dtype=np.int32)
    lens_p[:B] = lens

    # emittable kmer count per compact edge (for the normalizing total)
    el = np.zeros(nc, dtype=np.float32)
    np.add.at(el, f2c[emit_ok], 1.0)

    return MappedStreams(
        codes=codes_T, emis=emis, numce=numce, selfp=selfp,
        prevp=prevp, curp=curp, dence=dence, lens=lens_p,
        nc_pad=nc_pad, emittable_len_full=el,
    )


def eff_tables(streams: MappedStreams, cands) -> Tuple[np.ndarray, np.ndarray]:
    """(eff [C, nc_pad] f32 in the stream's id space, linv [C] f32).

    ``linv`` is log(1 / total emittable length) of each candidate (NEGF for
    an empty assignment).  With NC-trim active (streams.ce_ids), eff columns
    are the referenced subset eff[cn][ce_ids]; the normalizing total is
    ALWAYS over the full assignment (genome length does not shrink with the
    read chunk)."""
    C = len(cands)
    el_full = streams.emittable_len_full
    cn_mat = np.zeros((C, el_full.shape[0]), dtype=np.float32)
    for c, cn in enumerate(cands):
        cn_mat[c, : len(cn)] = np.asarray(cn, dtype=np.float32)
    total = cn_mat.astype(np.float64) @ el_full
    eff = np.zeros((C, streams.nc_pad), dtype=np.float32)
    if streams.ce_ids is not None:
        eff[:, : len(streams.ce_ids)] = cn_mat[:, streams.ce_ids]
    else:
        w = min(streams.nc_pad - 1, cn_mat.shape[1])
        eff[:, :w] = cn_mat[:, :w]
    eff[:, streams.nc_pad - 1] = 0.0  # sentinel
    linv = np.where(total > 0, -np.log(np.maximum(total, 1e-30)), NEGF)
    return eff, linv.astype(np.float32)


def _make_kernel(D: int, n_max_gaps: int, A: int):
    """Kernel body for one (candidate, read) program; see module docstring."""
    from jax.experimental import pallas as pl

    def kernel(lt_ref, eff_ref, linv_ref, lens_ref, codes_ref, emis_ref,
               numce_ref, selfp_ref, prevp_ref, curp_ref, dence_ref, out_ref):
        c = pl.program_id(0)
        b = pl.program_id(1)
        (lMM, lIM, lDM, lMI, lII, lDI, lMD, lID, lDD,
         l_match, l_mismatch, l_random, l_end) = [lt_ref[i] for i in range(13)]
        l_inv = linv_ref[c]
        src_slot = jax.lax.broadcasted_iota(jnp.int32, (A, A), 1)

        def ladd(x, y):
            mx = jnp.maximum(x, y)
            mn = jnp.minimum(x, y)
            return mx + jnp.log1p(jnp.exp(jnp.maximum(mn - mx, NEGF)))

        def ladd3(x, y, z):
            return ladd(ladd(x, y), z)

        def select(tab, idx):
            # tab[idx] per slot, NEGF where idx == -1 (exact: a max over a
            # one-hot row picks the single matching entry)
            hit = idx[:, None] == src_slot
            return jnp.max(jnp.where(hit, tab[None, :], NEGF), axis=1)

        def select_deg(tab, idxs):
            out = select(tab, idxs[0])
            for idx in idxs[1:]:
                out = ladd(out, select(tab, idx))
            return out

        def load(ref, *ix):
            return ref[ix].astype(jnp.int32)

        def kahan(acc, comp, inc):
            # acc + inc with the rounding carried in comp; the offset and
            # the Begin-insert chain both sum ~1e4 increments of a few nats
            y = inc - comp
            t = acc + y
            return t, (t - acc) - y

        def step(l, carry):
            m, i, d, ib, ib_c, off, off_c = carry
            first = l == 0  # the Begin match state only exists before x_0
            x = load(codes_ref, l, b)
            emis = load(emis_ref, l, b, slice(None))
            numce = load(numce_ref, l, b, slice(None))
            selfp = load(selfp_ref, l, b, slice(None))
            prevp = [load(prevp_ref, l, dd, b, slice(None)) for dd in range(D)]
            curp = [load(curp_ref, l, dd, b, slice(None)) for dd in range(D)]
            num = eff_ref[c, numce]
            den = eff_ref[c, load(dence_ref, l, 0, b, slice(None))]
            for dd in range(1, D):
                den = den + eff_ref[c, load(dence_ref, l, dd, b, slice(None))]

            # log transition prob into each slot's edge; 0-copy -> NEGF
            l_num = jnp.log(jnp.maximum(num, 1e-38))
            l_tval = jnp.where((num > 0) & (den > 0),
                               l_num - jnp.log(jnp.maximum(den, 1e-38)), NEGF)
            l_init = jnp.where(num > 0, l_num + l_inv, NEGF)
            l_emit = jnp.where(emis == x, l_match, l_mismatch)
            l_emit = jnp.where(emis < 4, l_emit, NEGF)

            # select(ladd(a, b)) == ladd(select(a), select(b)): combine the
            # three source tables once, then one lookup per parent column
            pre_m = ladd3(lMM + m, lIM + i, lDM + d)
            from_begin = l_init + jnp.where(first, lMM, lIM + ib)
            m_new = l_emit + ladd(l_tval + select_deg(pre_m, prevp),
                                  from_begin)

            pre_i = ladd3(lMI + m, lII + i, lDI + d)
            i_new = l_random + select(pre_i, selfp)

            # Begin-insert: entered from Begin at x_0, then only self-loops
            ib_step = jnp.where(first, l_random + lMI, l_random + lII)
            ib_new = jnp.where(first, ib_step, ib + ib_step)

            pre_d = ladd(lMD + m_new, lID + i_new)
            fd0 = ladd(l_tval + select_deg(pre_d, curp),
                       l_init + lID + ib_new)
            d_new = fd0
            fdt = fd0
            for _ in range(n_max_gaps):
                fdt = l_tval + lDD + select_deg(fdt, curp)
                d_new = ladd(d_new, fdt)

            # renormalize by the best live state of any kind; the rest of
            # each state is kept relative to it.  ib falls ~10 nats a step
            # behind a matching read, so over a read it reaches ~1e5 below
            # the max, and it alone survives when the mapping loses the
            # read's path: its steps are summed with compensation.
            shift = jnp.maximum(
                jnp.max(jnp.maximum(jnp.maximum(m_new, i_new), d_new)), ib_new
            )
            shift = jnp.where(shift > NEGF / 2, shift, 0.0)
            ib_k, ib_c_k = kahan(ib, ib_c, ib_step - shift)
            ib_next = jnp.where(first, ib_step - shift, ib_k)
            ib_c_next = jnp.where(first, 0.0, ib_c_k)
            off_next, off_c_next = kahan(off, off_c, shift)
            return (
                jnp.maximum(m_new - shift, NEGF),
                jnp.maximum(i_new - shift, NEGF),
                jnp.maximum(d_new - shift, NEGF),
                jnp.maximum(ib_next, NEGF),
                ib_c_next,
                off_next,
                off_c_next,
            )

        neg = jnp.full((A,), NEGF, jnp.float32)
        zero = jnp.float32(0.0)
        m, i, d, _ib, _ib_c, off, _ = jax.lax.fori_loop(
            0, lens_ref[b], step,
            (neg, neg, neg, jnp.float32(NEGF), zero, zero, zero),
        )
        # end state from the final tables: log P = l_end + lse(M+I+D) + off
        mid = ladd3(m, i, d)
        mx = jnp.max(mid)
        lse = mx + jnp.log(jnp.sum(jnp.exp(jnp.maximum(mid - mx, NEGF))))
        out_ref[c, b] = jnp.where(lse > NEGF / 2, l_end + lse + off, -jnp.inf)

    return kernel


def _num_warps(A: int) -> int:
    # an [A, A] select per lookup: keep ~32-64 elements per thread
    return max(1, min(8, A * A // 1024))


@functools.partial(jax.jit, static_argnames=("n_max_gaps", "interpret"))
def pallas_mapped_scores(
    eff: jnp.ndarray,  # [C, NC] f32
    linv: jnp.ndarray,  # [C] f32
    lens: jnp.ndarray,  # [B] int32
    codes: jnp.ndarray,  # [L, B]
    emis: jnp.ndarray,  # [L, B, A]
    numce: jnp.ndarray,
    selfp: jnp.ndarray,
    prevp: jnp.ndarray,  # [L, D, B, A]
    curp: jnp.ndarray,
    dence: jnp.ndarray,
    lt_log: jnp.ndarray,  # [13] log params, see log_params
    n_max_gaps: int = 4,
    interpret: bool = False,
) -> jnp.ndarray:
    """[C, B] per-read log likelihoods (f32; -inf where a read has no path
    under a candidate).  ``interpret=True`` runs the kernel through the
    Pallas interpreter (CPU tests); otherwise it is compiled by Triton for
    the GPU."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltr

    C, _NC = eff.shape
    _L, D, B, A = prevp.shape
    return pl.pallas_call(
        _make_kernel(D, n_max_gaps, A),
        grid=(C, B),
        out_shape=jax.ShapeDtypeStruct((C, B), jnp.float32),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=_num_warps(A)),
        interpret=interpret,
        name="mapped_scores",
    )(lt_log, eff, linv, lens, codes, emis, numce, selfp, prevp, curp, dence)


def log_params(params) -> jnp.ndarray:
    """The kernel's 13 log transition/emission constants (MM, IM, DM, MI,
    II, DI, MD, ID, DD, match, mismatch, random, end) from PHMMParams,
    taken in f64 and clamped to NEGF for zero probabilities."""
    lg = params.log_transitions()
    order = ["p_MM", "p_IM", "p_DM", "p_MI", "p_II", "p_DI", "p_MD", "p_ID",
             "p_DD", "p_match", "p_mismatch", "p_random", "p_end"]
    return jnp.asarray([max(lg[k], NEGF) for k in order], dtype=jnp.float32)


def pallas_mapped_scores_sharded(
    mesh, eff, linv, lens, codes, emis, numce, selfp, prevp, curp,
    dence, lt_log, n_max_gaps: int, interpret: bool,
):
    """shard_map wrapper: candidates sharded along the mesh's "cand" axis,
    reads along "reads"; each device runs the kernel on its local
    (C_loc, B_loc) block.  No collective is needed for the [C, B] per-read
    scores themselves — the cross-read sum happens in the caller.

    Replaces the reference's rayon fan-outs (freq.rs:175-192 reads,
    posterior.rs:504-515 candidates) with the two mesh axes."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    fn = functools.partial(
        pallas_mapped_scores, n_max_gaps=n_max_gaps, interpret=interpret,
    )
    in_specs = (
        P("cand", None),                  # eff [C, NC]
        P("cand"),                        # linv [C]
        P("reads"),                       # lens [B]
        P(None, "reads"),                 # codes [L, B]
        P(None, "reads", None),           # emis [L, B, A]
        P(None, "reads", None),           # numce
        P(None, "reads", None),           # selfp
        P(None, None, "reads", None),     # prevp [L, D, B, A]
        P(None, None, "reads", None),     # curp
        P(None, None, "reads", None),     # dence
        P(),                              # lt_log
    )
    # check_vma=False: pallas_call's out_shape carries no varying-mesh-axes
    # metadata, and the kernel output is trivially per-shard
    sm = shard_map(fn, mesh=mesh, in_specs=in_specs,
                   out_specs=P("cand", "reads"), check_vma=False)
    return sm(eff, linv, lens, codes, emis, numce, selfp, prevp, curp,
              dence, lt_log)


def _stream_budget_bytes():
    """Device bytes the resident read streams may take: a quarter of what
    the device lets JAX allocate (the rest is left to the mapping decode and
    XLA's own buffers), or None where the device reports no limit (CPU)."""
    stats = jax.devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return stats["bytes_limit"] // 4


class PallasMappedScorer:
    """Candidate scorer on the full-scan GPU kernel.

    Built once per (k, mapping); ``scores(candidates)`` evaluates a batch of
    compact-edge copy-number assignments and returns the per-candidate total
    log likelihood over reads (ref hot loop: freq.rs:175-192
    to_full_prob_reads over forward_with_mapping_score_only).  All candidate
    dependence enters as the eff table, so there is no per-candidate model
    construction at all.

    With ``mesh``, the evaluation is shard_mapped over the ("cand", "reads")
    mesh: read streams are laid out once, sharded along the read axis, and
    candidate eff tables along the candidate axis.  ``interpret=True`` runs
    the kernel in the Pallas interpreter (tests on the CPU).
    """

    def __init__(self, template, positions, codes: np.ndarray,
                 lens: np.ndarray, params, mesh=None, interpret: bool = False,
                 read_chunk: int = None, nc_trim: bool = True,
                 sort_reads: bool = True):
        self.mesh = mesh
        self.interpret = interpret
        B, L = codes.shape

        # genome-locality read sort: order reads by the median compact id of
        # their mapped nodes so each read CHUNK references a small,
        # overlapping id set — the enabler for per-chunk NC trimming below.
        # Scores are per-read sums, so read order is free to choose.
        if sort_reads and B > 1:
            f2c = template.full_to_compact.astype(np.int64)
            keys = np.zeros(B)
            mn0 = positions.map_nodes
            # width bucket (pow2 of the read's max per-position active-set
            # size) rides as the PRIMARY sort key so read chunks stay
            # width-homogeneous: a few error-dense 64-wide reads must not
            # force A=64 on every chunk
            wbuck = np.zeros(B)
            for b in range(B):
                v = mn0[b][mn0[b] >= 0]
                keys[b] = np.median(f2c[v]) if v.size else 0
                w = int((mn0[b] >= 0).sum(axis=1).max(initial=1))
                wbuck[b] = 1 << max(4, (w - 1).bit_length())
            order = np.lexsort((keys, wbuck))
            codes = np.ascontiguousarray(codes[order])
            lens = np.asarray(lens)[order]
            positions = MappedPositionsLike(
                map_nodes=positions.map_nodes[order],
                prev_pos=positions.prev_pos[order],
                cur_pos=positions.cur_pos[order],
                self_pos=positions.self_pos[order],
            )
        b_pad = 1 if mesh is None else mesh.shape["reads"]

        # read-chunk the stream build so the device stream footprint stays
        # inside its share of device memory at large read counts
        A0 = positions.map_nodes.shape[2]
        A_est = max(16, 1 << max(0, (A0 - 1)).bit_length())
        D_est = template.parent_idx.shape[1]
        per_read = L * A_est * (3 + 3 * D_est) * 2  # bytes, narrow dtypes
        budget = _stream_budget_bytes()
        rc = read_chunk or (B if budget is None else int(budget // per_read))
        rc = max(b_pad, -(-rc // b_pad) * b_pad)
        chunks = []
        for c0 in range(0, B, rc):
            c1 = min(B, c0 + rc)
            pos_c = MappedPositionsLike(
                map_nodes=positions.map_nodes[c0:c1],
                prev_pos=positions.prev_pos[c0:c1],
                cur_pos=positions.cur_pos[c0:c1],
                self_pos=positions.self_pos[c0:c1],
            )
            chunks.append(build_streams(
                template, pos_c, codes[c0:c1], lens[c0:c1], b_pad=b_pad
            ))
        # unify the DEGREE trim across chunks (one compile shape per A
        # bucket): pad the shallower chunks' degree columns back up with
        # empty columns.  A is NOT unified across chunks: with width-
        # homogeneous read chunks each chunk compiles at its own pow2 A, so
        # only the chunks that contain wide (error-dense) reads pay the
        # wide kernel.
        d_star = max(s.prevp.shape[1] for s in chunks)
        for ci, s in enumerate(chunks):
            d_c = s.prevp.shape[1]
            if d_c == d_star:
                continue
            SENT = s.nc_pad - 1
            pad_d = lambda a, fill: np.concatenate(
                [a, np.full((a.shape[0], d_star - d_c) + a.shape[2:], fill,
                            a.dtype)], axis=1
            )
            chunks[ci] = s._replace(
                prevp=pad_d(s.prevp, -1), curp=pad_d(s.curp, -1),
                dence=pad_d(s.dence, SENT),
            )

        # per-chunk NC trim: each read chunk only references the compact
        # edges its (sorted, genome-local) reads touch, so remap numce/dence
        # to that subset and build eff tables as eff[cn][ce_ids] — a smaller
        # per-candidate table stays in L1.  One compile shape: every chunk
        # pads to the widest chunk's id count.
        if nc_trim:
            useds = []
            for s in chunks:
                SENT = s.nc_pad - 1
                u = np.union1d(np.unique(s.numce), np.unique(s.dence))
                u = u[(u >= 0) & (u != SENT)].astype(np.int64)
                useds.append(u)
            n_used = max((len(u) for u in useds), default=0)
            nc_star = max(128, 1 << int(np.ceil(np.log2(n_used + 2))))
            if nc_star < chunks[0].nc_pad:
                ce_dt = np.int16 if nc_star <= 32768 else np.int32
                for ci, s in enumerate(chunks):
                    u = useds[ci]
                    remap = np.full(s.nc_pad, nc_star - 1, dtype=np.int32)
                    remap[u] = np.arange(len(u), dtype=np.int32)
                    chunks[ci] = s._replace(
                        numce=remap[s.numce].astype(ce_dt),
                        dence=remap[s.dence].astype(ce_dt),
                        nc_pad=nc_star,
                        ce_ids=u.astype(np.int32),
                    )
        self.chunks = chunks
        self.lt_log = log_params(params)
        self.n_max_gaps = params.n_max_gaps
        self.n_reads = B
        self._dev = {}

    def _device_args(self, ci: int):
        if ci not in self._dev:
            s = self.chunks[ci]
            arrs = (s.lens, s.codes, s.emis, s.numce, s.selfp,
                    s.prevp, s.curp, s.dence)
            if self.mesh is None:
                self._dev[ci] = tuple(jnp.asarray(a) for a in arrs)
            else:
                from ..parallel.sharding import put_read_sharded

                read_axes = (0, 1, 1, 1, 1, 2, 2, 2)
                self._dev[ci] = tuple(
                    put_read_sharded(self.mesh, a, ax, flat=False)
                    for a, ax in zip(arrs, read_axes)
                )
            if len(self._dev) > 2:
                # drop older chunks' device buffers (keep device memory
                # bounded); the host-side numpy streams stay cached
                for k in list(self._dev):
                    if k != ci and len(self._dev) > 2:
                        del self._dev[k]
        return self._dev[ci]

    def _launch_size(self, n: int) -> int:
        size = min(CAND_SUB, 1 << max(0, n - 1).bit_length())
        if self.mesh is not None:
            n_cs = self.mesh.shape["cand"]
            size = -(-size // n_cs) * n_cs
        return size

    def scores(self, candidates) -> np.ndarray:
        """Total log P(R|X_c) [C] f64 for each candidate.  Candidates run in
        launches of at most CAND_SUB, padded to a power of two (few compiled
        grid sizes; a single-candidate score does not pay for 64)."""
        C = len(candidates)
        totals = np.empty(C, dtype=np.float64)
        for c0 in range(0, C, CAND_SUB):
            part = list(candidates[c0 : c0 + CAND_SUB])
            n = len(part)
            part += [part[0]] * (self._launch_size(n) - n)
            per_read = np.concatenate(
                [self._scores_chunk(part, ci) for ci in range(len(self.chunks))],
                axis=1,
            )
            totals[c0 : c0 + n] = per_read[:n].astype(np.float64).sum(axis=1)
        return totals

    def _scores_chunk(self, cands, ci: int) -> np.ndarray:
        """[len(cands), B_real] per-read log likelihoods for one read chunk.
        Empty reads (the mesh's padding) are dropped, as the XLA scorer
        masks them."""
        args = self._device_args(ci)
        streams = self.chunks[ci]
        eff, linv = eff_tables(streams, cands)
        if self.mesh is None:
            out = np.asarray(
                pallas_mapped_scores(
                    jnp.asarray(eff), jnp.asarray(linv), *args, self.lt_log,
                    n_max_gaps=self.n_max_gaps, interpret=self.interpret,
                )
            )
        else:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel.sharding import _put_sharded, gather_to_host

            cand_sh = NamedSharding(self.mesh, P("cand"))
            out = gather_to_host(
                pallas_mapped_scores_sharded(
                    self.mesh,
                    _put_sharded(cand_sh, jnp.asarray(eff)),
                    _put_sharded(cand_sh, jnp.asarray(linv)),
                    *args, self.lt_log, n_max_gaps=self.n_max_gaps,
                    interpret=self.interpret,
                )
            )
        return out[:, streams.lens > 0]


class MappedPositionsLike(NamedTuple):
    map_nodes: np.ndarray
    prev_pos: np.ndarray
    cur_pos: np.ndarray
    self_pos: np.ndarray
