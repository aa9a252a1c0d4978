"""Candidate-batched likelihood evaluation.

The posterior hill-climb scores many neighbor copy-number assignments X
against the same reads.  All candidates share the graph topology (only
transition/init probabilities change), so the per-candidate arrays are
stacked on a leading axis and vmapped — "batch of X's x batch of reads"
(ref: SURVEY.md section 2.11 candidate parallelism; replaces the reference's
rayon fan-out over neighbors, posterior.rs:504-515).

Candidate counts vary between hill-climb iterations; we pad to power-of-two
buckets to avoid XLA recompilation churn.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..phmm.model import PHMMModel
from .forward import DeviceModel, forward_scores, to_device


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


@jax.jit
def _scores_vmapped(dm: DeviceModel, init_b, plogt_b, clogt_b, codes, lens):
    def one(init_logp, parent_logt, child_logt):
        dmc = dataclasses.replace(
            dm, init_logp=init_logp, parent_logt=parent_logt, child_logt=child_logt
        )
        return forward_scores(dmc, codes, lens, renorm=True)

    return jax.vmap(one)(init_b, plogt_b, clogt_b)  # [C, B]


@jax.jit
def _scores_vmapped_mapped(dm: DeviceModel, init_b, plogt_b, clogt_b, codes,
                           lens, map_nodes):
    from .sparse import forward_scores_mapped

    def one(init_logp, parent_logt, child_logt):
        dmc = dataclasses.replace(
            dm, init_logp=init_logp, parent_logt=parent_logt, child_logt=child_logt
        )
        return forward_scores_mapped(dmc, codes, lens, map_nodes, renorm=True)

    return jax.vmap(one)(init_b, plogt_b, clogt_b)  # [C, B]


@jax.jit
def _scores_vmapped_mapped_pos(dm: DeviceModel, init_b, plogt_b, clogt_b,
                               codes, lens, mn, pp, cp, sp):
    from .sparse import forward_scores_mapped_pos

    def one(init_logp, parent_logt, child_logt):
        dmc = dataclasses.replace(
            dm, init_logp=init_logp, parent_logt=parent_logt, child_logt=child_logt
        )
        return forward_scores_mapped_pos(dmc, codes, lens, mn, pp, cp, sp)

    return jax.vmap(one)(init_b, plogt_b, clogt_b)  # [C, B]


@jax.jit
def _totals_vmapped(dm, init_b, plogt_b, clogt_b, codes, lens):
    per_read = _scores_vmapped(dm, init_b, plogt_b, clogt_b, codes, lens)
    return jnp.sum(jnp.where(lens[None, :] > 0, per_read, 0.0), axis=1)


@jax.jit
def _totals_vmapped_mapped(dm, init_b, plogt_b, clogt_b, codes, lens, mn):
    per_read = _scores_vmapped_mapped(
        dm, init_b, plogt_b, clogt_b, codes, lens, mn
    )
    return jnp.sum(jnp.where(lens[None, :] > 0, per_read, 0.0), axis=1)


@jax.jit
def _totals_vmapped_mapped_pos(dm, init_b, plogt_b, clogt_b, codes, lens,
                               mn, pp, cp, sp):
    per_read = _scores_vmapped_mapped_pos(
        dm, init_b, plogt_b, clogt_b, codes, lens, mn, pp, cp, sp
    )
    return jnp.sum(jnp.where(lens[None, :] > 0, per_read, 0.0), axis=1)


@jax.jit
def _scores_vmapped_pos_linear_slim(dm: DeviceModel, init_b, plogt_b,
                                    codes, lens, mn, pp, cp, sp):
    """Candidate-vmapped scaled-linear mapped forward.  Slim: only the
    candidate-dependent arrays (init, parent trans) are batched; the mapped
    kernels never read child arrays, so they ride along from the base model
    unbatched."""
    from .sparse import forward_scores_mapped_linear

    def one(init_logp, parent_logt):
        dmc = dataclasses.replace(dm, init_logp=init_logp, parent_logt=parent_logt)
        return forward_scores_mapped_linear(dmc, codes, lens, mn, pp, cp, sp)

    return jax.vmap(one)(init_b, plogt_b)  # [C, B]


@jax.jit
def _scores_vmapped_pos_log_slim(dm: DeviceModel, init_b, plogt_b,
                                 codes, lens, mn, pp, cp, sp):
    from .sparse import forward_scores_mapped_pos

    def one(init_logp, parent_logt):
        dmc = dataclasses.replace(dm, init_logp=init_logp, parent_logt=parent_logt)
        return forward_scores_mapped_pos(dmc, codes, lens, mn, pp, cp, sp)

    return jax.vmap(one)(init_b, plogt_b)  # [C, B]


class XlaMappedScorer:
    """Device-resident XLA candidate scorer over precomputed positions — the
    plain reference for the GPU kernel and the scorer on every other
    platform.

    Two fixes over calling :func:`candidate_log_likelihoods` per chunk:

    * the read/mapping/position streams (~GB at production widths) are
      uploaded ONCE at construction instead of re-uploaded per launch;
    * chunks score with the scaled-linear kernel
      (:func:`dbgphmm_tpu.ops.sparse.forward_scores_mapped_linear` — pure
      multiply-add per step, one log per read for the renorm offset) and
      only candidates with an underflowed read (forced across a copy-0 cut)
      rescore with the log-space kernel.
    """

    def __init__(self, template, positions, codes, lens, dtype=None,
                 sub: int = 32, bucket: bool = True):
        from .forward import default_dtype

        self.template = template
        self.dtype = default_dtype() if dtype is None else dtype
        self.sub = sub
        self._base = None  # built on first score (needs a copy-num vector)
        self._nb = self._db = None
        self.lens_np = np.asarray(lens)
        self.n_reads = len(self.lens_np)
        codes = np.asarray(codes)
        mn = np.asarray(positions.map_nodes)
        pp = np.asarray(positions.prev_pos)
        cp = np.asarray(positions.cur_pos)
        sp = np.asarray(positions.self_pos)

        # read-width bucketing: mapping widths are bursty (n4 k=40: per-read
        # max width median 5, but 21/97 repeat-crossing reads hit the 128
        # cap) and the dense [B, L, A] kernel pays max width for every read.
        # Valid slots are a logp-sorted prefix and every position index
        # points at a valid slot, so slicing A down to a read's own max
        # width is exact.  Each bucket also trims L to its longest read.
        A_full = mn.shape[2]
        widths = (mn >= 0).sum(axis=2).max(axis=1)  # [B] per-read max width
        bounds = [w for w in (16, 32, 64) if w < A_full] + [A_full]
        if not bucket:
            bounds = [A_full]
        self.buckets = []
        for bi, Ab in enumerate(bounds):
            lo = 0 if bi == 0 else bounds[bi - 1]
            rb = np.flatnonzero((widths > lo if bi else widths >= 0)
                                & (widths <= Ab))
            if rb.size == 0:
                continue
            Lb = int(self.lens_np[rb].max())
            self.buckets.append({
                "idx": rb,
                "lens_np": self.lens_np[rb],
                "codes": jnp.asarray(codes[rb, :Lb]),
                "lens": jnp.asarray(self.lens_np[rb]),
                "mn": jnp.asarray(mn[rb, :Lb, :Ab]),
                "pp": jnp.asarray(pp[rb, :Lb, :Ab]),
                "cp": jnp.asarray(cp[rb, :Lb, :Ab]),
                "sp": jnp.asarray(sp[rb, :Lb, :Ab]),
            })

    def _ensure_base(self, cn0):
        if self._base is not None:
            return
        from .forward import pad_model, to_device

        m = pad_model(self.template.model_for(cn0))
        self._nb, self._db = m.parent_idx.shape
        self._n = self.template.emission.shape[0]
        self._base = to_device(m, dtype=self.dtype, pad=False)

    def _stack(self, chunk):
        """Stack per-candidate (init, parent_logt) padded to [sub, nb(, db)]."""
        n, db = self._n, self._db
        init = np.full((self.sub, self._nb), -np.inf, dtype=np.float64)
        plogt = np.full((self.sub, self._nb, db), -np.inf, dtype=np.float64)
        for j, cn in enumerate(chunk):
            mdl = self.template.model_for(cn)
            init[j, :n] = mdl.init_logp
            plogt[j, :n, : mdl.parent_logt.shape[1]] = mdl.parent_logt
        for j in range(len(chunk), self.sub):  # pad slots repeat candidate 0
            init[j] = init[0]
            plogt[j] = plogt[0]
        return (jnp.asarray(init, dtype=self.dtype),
                jnp.asarray(plogt, dtype=self.dtype))

    def _run(self, fn, init_d, plogt_d, n_out: int) -> np.ndarray:
        """Run a vmapped kernel over every bucket -> per-read [n_out, B]."""
        per_read = np.empty((n_out, self.n_reads), dtype=np.float64)
        for b in self.buckets:
            out = np.asarray(
                fn(self._base, init_d, plogt_d, b["codes"], b["lens"],
                   b["mn"], b["pp"], b["cp"], b["sp"]),
                dtype=np.float64,
            )[:n_out]
            per_read[:, b["idx"]] = out
        return per_read

    def _totals(self, per_read: np.ndarray) -> np.ndarray:
        valid = self.lens_np > 0
        return np.where(valid[None, :], per_read, 0.0).sum(axis=1)

    def score_chunk(self, chunk) -> np.ndarray:
        """Total log P(R|X) for up to ``sub`` candidates."""
        self._ensure_base(chunk[0])
        init_d, plogt_d = self._stack(chunk)
        per_read = self._run(
            _scores_vmapped_pos_linear_slim, init_d, plogt_d, len(chunk)
        )
        totals = self._totals(per_read)
        bad = ~np.isfinite(totals)
        if bad.any():
            # reads forced across copy-0 cuts underflow the linear kernel;
            # their exact very-low scores drive the early hill climb, so
            # rescore those candidates with the log-space kernel
            idx = np.flatnonzero(bad)
            sub_chunk = [chunk[int(i)] for i in idx]
            init_d, plogt_d = self._stack(sub_chunk)
            per_read = self._run(
                _scores_vmapped_pos_log_slim, init_d, plogt_d, len(sub_chunk)
            )
            totals[idx] = self._totals(per_read)
        return totals

    def scores(self, candidates) -> np.ndarray:
        """Total log P(R|X_c) [C] f64, in fixed launches of ``sub``
        candidates (one compiled shape; at most sub-1 padding slots)."""
        return np.concatenate([
            self.score_chunk(list(candidates[c0 : c0 + self.sub]))
            for c0 in range(0, len(candidates), self.sub)
        ])


def make_candidate_scorer(template, positions, codes, lens, params,
                          mesh=None, dtype=None):
    """The candidate scorer for the platform JAX runs on.

    * ``gpu``: :class:`~dbgphmm_tpu.ops.pallas_mapped.PallasMappedScorer`,
      the full-scan Triton kernel (sharded over ``mesh`` when given);
    * otherwise :class:`XlaMappedScorer`, the plain reference.  It has no
      mesh form: with a mesh it returns None and the caller shards the
      vmapped kernel itself (:func:`candidate_log_likelihoods`).

    A failure to build or to launch propagates: there is no fallback."""
    if jax.default_backend() == "gpu":
        from .pallas_mapped import PallasMappedScorer

        return PallasMappedScorer(template, positions, codes, lens, params,
                                  mesh=mesh)
    if mesh is not None:
        return None
    return XlaMappedScorer(template, positions, codes, lens, dtype=dtype)


def _pad_reads_axis(arr: np.ndarray, m: int, fill):
    """Pad axis 0 (reads) to a multiple of m."""
    pad = (-arr.shape[0]) % m
    if pad == 0:
        return arr
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths, constant_values=fill)


def candidate_log_likelihoods(
    models: Sequence[PHMMModel],
    codes: np.ndarray,
    lens: np.ndarray,
    dtype=jnp.float64,
    map_nodes: np.ndarray = None,
    positions=None,
    mesh=None,
) -> np.ndarray:
    """Total log P(R|X_c) = sum over reads of log P(read|X_c), for each
    candidate model (same topology, different probabilities).

    When ``map_nodes`` [B, L, A] is given, uses the mapping-constrained
    sparse kernel (ref: freq.rs:175-192 scoring with mappings) — the
    production path for large graphs.

    When ``mesh`` is given (a ("cand", "reads") mesh from
    :func:`dbgphmm_tpu.parallel.make_mesh`), candidates are sharded along
    "cand" and reads along "reads"; the per-read log-likelihood sum lowers to
    a psum over the reads axis (the reference's rayon fan-outs
    posterior.rs:504-515 + freq.rs:175-192 become the two mesh axes).

    Returns [n_candidates] float64.
    """
    from .forward import pad_model

    C = len(models)
    pad = _bucket(C)
    if mesh is not None:
        n_cand_shard = mesh.shape["cand"]
        pad = -(-pad // n_cand_shard) * n_cand_shard
    models = [pad_model(m) for m in models]  # shared bucket (same topology)
    base = to_device(models[0], dtype=dtype, pad=False)
    as_d = lambda arrs: jnp.asarray(np.stack(arrs), dtype=dtype)
    init = [m.init_logp for m in models] + [models[0].init_logp] * (pad - C)
    plogt = [m.parent_logt for m in models] + [models[0].parent_logt] * (pad - C)
    clogt = [m.child_logt for m in models] + [models[0].child_logt] * (pad - C)

    codes = np.asarray(codes)
    lens = np.asarray(lens)
    if mesh is not None:
        from ..parallel.sharding import put_read_sharded, put_replicated
        from jax.sharding import NamedSharding, PartitionSpec as P

        n_read_shard = mesh.shape["reads"]
        codes = _pad_reads_axis(codes, n_read_shard, -1)
        lens = _pad_reads_axis(lens, n_read_shard, 0)
        from ..parallel.sharding import _put_sharded, gather_to_host

        cand_sh = NamedSharding(mesh, P("cand"))
        put_c = lambda arrs: _put_sharded(cand_sh, as_d(arrs))
        put_r = lambda a, ax=0: put_read_sharded(mesh, a, ax, flat=False)
        base_d = put_replicated(mesh, base)
        codes_d, lens_d = put_r(codes), put_r(lens)
        if positions is not None:
            pad_r = lambda a: _pad_reads_axis(np.asarray(a), n_read_shard, -1)
            per_cand = _totals_vmapped_mapped_pos(
                base_d, put_c(init), put_c(plogt), put_c(clogt),
                codes_d, lens_d,
                put_r(pad_r(positions.map_nodes)), put_r(pad_r(positions.prev_pos)),
                put_r(pad_r(positions.cur_pos)), put_r(pad_r(positions.self_pos)),
            )
        elif map_nodes is not None:
            per_cand = _totals_vmapped_mapped(
                base_d, put_c(init), put_c(plogt), put_c(clogt),
                codes_d, lens_d, put_r(_pad_reads_axis(map_nodes, n_read_shard, -1)),
            )
        else:
            per_cand = _totals_vmapped(
                base_d, put_c(init), put_c(plogt), put_c(clogt),
                codes_d, lens_d,
            )
        return gather_to_host(per_cand).astype(np.float64)[:C]

    if positions is not None:
        per_read = _scores_vmapped_mapped_pos(
            base, as_d(init), as_d(plogt), as_d(clogt),
            jnp.asarray(codes), jnp.asarray(lens),
            jnp.asarray(positions.map_nodes), jnp.asarray(positions.prev_pos),
            jnp.asarray(positions.cur_pos), jnp.asarray(positions.self_pos),
        )
    elif map_nodes is not None:
        per_read = _scores_vmapped_mapped(
            base, as_d(init), as_d(plogt), as_d(clogt),
            jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(map_nodes),
        )
    else:
        per_read = _scores_vmapped(
            base, as_d(init), as_d(plogt), as_d(clogt),
            jnp.asarray(codes), jnp.asarray(lens),
        )  # [pad, B]
    out = np.asarray(per_read, dtype=np.float64)[:C].sum(axis=1)
    return out
