"""Bayesian posterior sampling over copy-number assignments
(ref: src/multi_dbg/posterior.rs).

Score of an assignment X:
``P(X|R) ∝ P(R|X) · P(G) · #EulerCircuits(X)``
(ref: posterior.rs:199-206) where

* P(R|X): read likelihoods from the device PHMM kernel, candidate-batched
* P(G): Normal prior on genome size
* #EC: BEST-theorem count on the compact multigraph

Inference (``infer_posterior_by_extension``, ref: posterior.rs:698-826):
per k, greedy hill-climb over neighbor assignments (rescue cycles during
extension; full neighbor sets at the final k), purge high-P(X=0) edges,
extend to k+1, regenerate mappings, re-approximate copy numbers from mapping
frequencies.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.batch import candidate_log_likelihoods
from ..ops.forward import node_freqs_and_mappings, pad_reads, to_device
from ..phmm.params import PHMMParams
from ..hist import DiscreteDistribution
from ..prob import NEG_INF, ladd, normal_bin_logp
from . import MultiDbg
from .draft import min_squared_error_copy_nums_from_freqs
from .neighbors import (
    NeighborConfig,
    UpdateInfo,
    apply_update_cycle,
    is_independent_update,
    to_neighbor_copy_nums_and_infos,
    to_rescue_neighbors,
)


# -- mappings -----------------------------------------------------------------


@dataclass
class Mappings:
    """Per-read, per-base candidate PHMM nodes (= full-DBG edges) with log
    probs (ref: src/hmmv2/hint.rs Mapping/Mappings).

    ``nodes[r]`` is int32 [L_r, A] (-1 padding); ``logps[r]`` matches.
    ``read_logps`` (optional) records each read's full log-likelihood from
    the decode that produced the mapping — used to gate hint-seeded
    regeneration across k (see ``generate_mappings(hint=...)``).
    ``anchor_logps`` records each read's likelihood at its last
    FROM-SCRATCH decode; it is carried unchanged across hint-seeded stages
    so the gate has an absolute re-anchor (comparing only against the
    previous stage's constrained value lets sub-gate degradation ratchet
    silently across many k stages).
    """

    nodes: List[np.ndarray]
    logps: List[np.ndarray]
    read_logps: Optional[np.ndarray] = None
    anchor_logps: Optional[np.ndarray] = None
    stages_since_anchor: int = 0
    # fraction of reads the hint gate regenerated from scratch in the
    # decode that produced this mapping; the infer loop skips the next
    # stage's doomed hint-constrained decode when ~all reads gated
    gate_rate: float = 0.0
    # a single read genuinely visits one node at most a handful of times
    # (repeat copies x passes); thousands of units of per-node mass are the
    # signature of posterior absorption into low-complexity self-loop
    # regions, which the evolving-frontier decode cannot fully rule out at
    # n > DENSE_COMPUTE_MAX_NODES (the reference's adaptive dense fallback,
    # forward.rs:119-138, is not used above that bound).  The cap bounds
    # the damage to node freqs (a freq of 35k against the ~n_reads bound
    # was seen at n4b k=40, stalling the MSE flow re-init downstream).
    MAX_NODE_MASS_PER_READ = 50.0

    def n_reads(self) -> int:
        return len(self.nodes)

    @classmethod
    def _mass_cap(cls, read_len: int) -> float:
        """Per-(read, node) freqs mass cap, scaled with read length
        (a long read legitimately traversing a collapsed short-tandem node
        can accrue hundreds of visits; a flat cap of 50 systematically
        undercounts there)."""
        return max(cls.MAX_NODE_MASS_PER_READ, 0.02 * read_len)

    def mass_cap_total(self) -> float:
        """Upper bound of any node's total freqs under the per-read caps —
        the blow-up guard threshold in the infer loop."""
        return sum(self._mass_cap(n.shape[0]) for n in self.nodes)

    def to_node_freqs(self, n_nodes: int) -> np.ndarray:
        """Expected usage per node, linear space (ref: hint.rs:161-171),
        with each read's per-node contribution capped (see ``_mass_cap``)."""
        freqs = np.zeros(n_nodes)
        for nodes, logps in zip(self.nodes, self.logps):
            valid = nodes >= 0
            mass = np.bincount(
                nodes[valid], weights=np.exp(logps[valid]), minlength=n_nodes
            )[:n_nodes]
            freqs += np.minimum(mass, self._mass_cap(nodes.shape[0]))
        return freqs

    def as_lists(self):
        out = []
        for nodes, logps in zip(self.nodes, self.logps):
            read = []
            for j in range(nodes.shape[0]):
                valid = nodes[j] >= 0
                read.append(list(zip(nodes[j][valid].tolist(),
                                     np.exp(logps[j][valid]).tolist())))
            out.append(read)
        return out


DENSE_MAPPING_MAX_NODES = 4000

DENSE_COMPUTE_MAX_NODES = 32768  # up to here the mapping forward pass runs
# DENSE per step (exact — no frontier that can permanently drop the true
# path) while storing only the top-A compacted cells for the backward pass.
# At small k the repeat-shared k-mer ambiguity is huge (a top-64 evolving
# frontier loses true cells and the resulting mapping poisons candidate
# scoring by ~1e5 log units — seen on u500(8) at k=41); dense compute
# re-ranks from the full table every step so weak true cells recover.
# Beyond this node count (large k) the graph is nearly linear and the
# evolving-frontier kernel is accurate and much cheaper.  The bound was set
# on the system's first accelerator, where larger dense decodes faulted;
# it is kept so mapping behaviour is unchanged, and has not been
# re-derived on the GPU.  Above it, mappings come from exact-match seeding
# (multi_dbg.seed); the frontier decode is validated against a CPU-f64
# dense oracle at n=74k (scripts/validate_large_n_mapping.py;
# docs/evidence/validate_74k_cpu.log) and low-complexity posterior
# absorption is contained by the per-(read, node) mass cap in
# Mappings.to_node_freqs.


MAPPING_WIDTH_CAP = 128  # fixed-shape cap on mapping slots — the analog of
# the reference's MAX_ACTIVE_NODES=400 (table.rs:22).  The *effective* width
# is score-ratio selected (params.active_node_max_ratio=30, hint.rs:135-142):
# a fixed top-40/64 can drop the true path in repeat-ambiguous stretches and
# catastrophically mis-score it (observed on u500(8) at k=63: one read -44k
# log units), while in unambiguous stretches a handful of slots suffice — the
# arrays are trimmed to the observed max width after the ratio mask.

ADAPTIVE_FRONTIER_TOP = 64  # top-K frontier cap of the sparse-adaptive
# forward used for mapping generation (ref n_active_nodes=40, params.rs:116)


def _trim_mapping_width(mn: np.ndarray, ml: np.ndarray, align: int = 16):
    """Slice the fixed-cap mapping arrays [B, L, CAP] down to the observed
    effective width (max valid slots per position), aligned up for shape
    stability.  Slots are sorted by logp (top-k output), so valid entries are
    a prefix of each row."""
    valid = mn >= 0  # [B, L, CAP]
    width = int(valid.sum(axis=2).max(initial=1))
    width = max(width, 1)
    width = min(-(-width // align) * align, mn.shape[2])
    return mn[:, :, :width], ml[:, :, :width]


def _pad_hint_nodes(hint: Mappings, L: int, cap: int) -> np.ndarray:
    """Stack per-read hint node lists into one [B, L, A] int32 array."""
    B = hint.n_reads()
    A = max(1, min(cap, max((m.shape[1] for m in hint.nodes), default=1)))
    out = np.full((B, L, A), -1, dtype=np.int32)
    for r, m in enumerate(hint.nodes):
        w = min(A, m.shape[1])
        out[r, : m.shape[0], :w] = m[:, :w]
    return out


MAPPING_READ_CHUNK = 160  # decode stores O(L * B * A) per-step tables on
# device; chunk the read batch so the footprint stays bounded at large read
# counts (KIR class: 500+ reads x 10kb would need ~17GB unchunked)
FRONTIER_READ_CHUNK = 384  # the >32k frontier decode compact-stores
# [L, B, K<=128] tables in bf16 (~10B/cell), so its chunk can be ~2.4x
# bigger; a larger batch amortizes the fixed cost of each scan step.  Both
# sizes were chosen on the first accelerator and are kept as they are.


def seeded_mapping_enabled() -> bool:
    """Exact-match seeded mapping generation for the frontier regime
    (n > DENSE_COMPUTE_MAX_NODES) — see multi_dbg.seed.  Default ON; env
    DBGPHMM_SEED_MAPPING=0 restores the (diagnosed-unreliable) frontier
    decode."""
    import os

    return os.environ.get("DBGPHMM_SEED_MAPPING", "1") != "0"


def generate_mappings(
    dbg: MultiDbg,
    params: PHMMParams,
    reads,
    n_active: int = MAPPING_WIDTH_CAP,
    dtype=None,
    max_ratio: Optional[float] = "default",
    mesh=None,
    hint: Optional[Mappings] = None,
    hint_gate: float = 100.0,
    verbose: bool = False,
    read_chunk: int = MAPPING_READ_CHUNK,
    pad_to: Optional[int] = None,
    hint_regen: bool = True,
) -> Mappings:
    """Posterior state decode on the non-zero PHMM -> per-base active nodes
    by score ratio under a top-k cap (ref: posterior.rs:609-637
    generate_mappings with use_max_ratio=true; hint.rs:193-220).

    Uses the dense forward/backward for small graphs (exact) and the
    sparse-adaptive kernel beyond DENSE_MAPPING_MAX_NODES (the reference's
    run_sparse_adaptive path, freq.rs:60).

    With ``hint`` (a mapping upconverted across purge/k+1 extension), the
    decode is restricted to the hint's per-base active sets — the
    reference's ``run_with_mapping`` branch (hint.rs:206-216) — which costs
    O(B*L*A^2) independent of graph size.  Acceptance gate: any read whose
    hint-constrained likelihood is non-finite or more than ``hint_gate``
    nats below its previous-k likelihood (``hint.read_logps``) falls back
    to the full from-scratch decode for that read.

    With ``mesh``, the read batch is sharded over ALL mesh devices (mapping
    generation has no candidate axis — the reference parallelizes it over
    reads, hint.rs:199-220) and the graph arrays are replicated; outputs are
    gathered to host."""
    import jax.numpy as jnp

    from ..ops.forward import default_dtype

    if dtype is None:
        dtype = default_dtype()
    if max_ratio == "default":
        max_ratio = params.active_node_max_ratio

    if (hint is None and dbg.n_edges_full() > DENSE_COMPUTE_MAX_NODES
            and seeded_mapping_enabled()):
        # frontier regime: the from-scratch giant-DP decode is unreliable
        # here (round-5 diagnosis: absorbed junk mappings at n4 production
        # scale from k=40 on) — replace candidate generation with
        # graph-exact k-mer suffix seeding + the constrained refine
        # (multi_dbg.seed); hint_regen=False because re-decoding a
        # floor-failing read from scratch would re-enter this same path
        from .seed import seed_mappings_arrays

        arrs = seed_mappings_arrays(dbg, reads, verbose=True)
        seeds = Mappings(arrs, [np.zeros(a.shape) for a in arrs],
                         None, None, -1)
        return generate_mappings(
            dbg, params, reads, n_active=n_active, dtype=dtype,
            max_ratio=max_ratio, mesh=mesh, hint=seeds,
            hint_gate=hint_gate, verbose=verbose, read_chunk=read_chunk,
            pad_to=pad_to, hint_regen=False,
        )

    # chunk large read batches: the decode stores per-step tables on device;
    # a shared pad_to keeps chunk shapes identical (one compile, not one
    # per chunk)
    if (read_chunk == MAPPING_READ_CHUNK and hint is None
            and dbg.n_edges_full() > DENSE_COMPUTE_MAX_NODES):
        read_chunk = FRONTIER_READ_CHUNK  # compact-stored path (see above)
    if read_chunk and len(reads) > read_chunk:
        reads_l = list(reads)
        L_max = max(len(r) for r in reads_l)
        parts = []
        for c0 in range(0, len(reads_l), read_chunk):
            sub = reads_l[c0 : c0 + read_chunk]
            sub_hint = None
            if hint is not None:
                sub_hint = Mappings(
                    hint.nodes[c0 : c0 + read_chunk],
                    hint.logps[c0 : c0 + read_chunk],
                    None if hint.read_logps is None
                    else hint.read_logps[c0 : c0 + read_chunk],
                    None if hint.anchor_logps is None
                    else hint.anchor_logps[c0 : c0 + read_chunk],
                    hint.stages_since_anchor,
                )
            parts.append(generate_mappings(
                dbg, params, sub, n_active=n_active, dtype=dtype,
                max_ratio=max_ratio, mesh=mesh, hint=sub_hint,
                hint_gate=hint_gate, verbose=verbose, read_chunk=0,
                pad_to=L_max, hint_regen=hint_regen,
            ))
        return Mappings(
            [a for p in parts for a in p.nodes],
            [a for p in parts for a in p.logps],
            np.concatenate([p.read_logps for p in parts]),
            np.concatenate([p.anchor_logps for p in parts]),
            max(p.stages_since_anchor for p in parts),
        )

    model = dbg.to_phmm(params, mode="non_zero")
    dm = to_device(model, dtype=dtype)
    codes, lens = pad_reads(list(reads), pad_to=pad_to)
    n_reads = codes.shape[0]
    codes_d, lens_d = jnp.asarray(codes), jnp.asarray(lens)
    hint_arr = None
    if hint is not None:
        hint_arr = _pad_hint_nodes(hint, codes.shape[1], 2 * n_active)
    hint_d = jnp.asarray(hint_arr) if hint_arr is not None else None
    if mesh is not None:
        from ..ops.batch import _pad_reads_axis
        from ..parallel.sharding import (
            mesh_read_axis_size, put_read_sharded, put_replicated,
        )

        n_shard = mesh_read_axis_size(mesh, flat=True)
        codes_d = put_read_sharded(mesh, _pad_reads_axis(codes, n_shard, -1), 0)
        lens_d = put_read_sharded(mesh, _pad_reads_axis(lens, n_shard, 0), 0)
        dm = put_replicated(mesh, dm)
        if hint_arr is not None:
            hint_d = put_read_sharded(
                mesh, _pad_reads_axis(hint_arr, n_shard, -1), 0
            )
    if hint is not None:
        from ..ops.adaptive import mappings_refine

        logp, map_nodes, map_logp = mappings_refine(
            dm, codes_d, lens_d, hint_d,
            n_active=n_active, max_ratio=max_ratio,
        )
    elif dbg.n_edges_full() <= DENSE_MAPPING_MAX_NODES:
        logp, _freqs, map_nodes, map_logp = node_freqs_and_mappings(
            dm, codes_d, lens_d, renorm=True,
            n_active=n_active, max_ratio=max_ratio,
        )
    else:
        from ..ops.adaptive import mappings_sparse_adaptive

        n = dbg.n_edges_full()
        stored_k, store_bf16 = None, False
        if n <= DENSE_COMPUTE_MAX_NODES:
            # dense-compute / compact-store: exact forward, ~256-cell storage
            # (the kernel's table width is n_top * (D + 1))
            D = int(dm.parent_idx.shape[1])
            n_top, n_warmup = max(40, 256 // (D + 1)), int(codes.shape[1])
        else:
            n_top, n_warmup = max(ADAPTIVE_FRONTIER_TOP, -(-n_active // 2)), 16
            # frontier regime: trim stored tables to the decode width and
            # cast to bf16 — the memory lever that lets a larger read batch
            # amortize the fixed cost of each scan step
            stored_k = max(n_active, ADAPTIVE_FRONTIER_TOP)
            import jax.numpy as _jnp

            store_bf16 = dtype == _jnp.float32
        logp, map_nodes, map_logp = mappings_sparse_adaptive(
            dm, codes_d, lens_d,
            n_top=n_top, n_active=n_active, max_ratio=max_ratio,
            n_warmup=n_warmup, stored_k=stored_k, store_bf16=store_bf16,
        )
    if mesh is not None:
        from ..parallel.sharding import gather_to_host

        logp, map_nodes, map_logp = (
            gather_to_host(logp), gather_to_host(map_nodes),
            gather_to_host(map_logp),
        )
    read_logps = np.asarray(logp)[:n_reads].astype(np.float64)
    mn = np.asarray(map_nodes)[:n_reads]
    ml = np.asarray(map_logp)[:n_reads]
    mn, ml = _trim_mapping_width(mn, ml)
    nodes, logps = [], []
    for i, L in enumerate(lens):
        nodes.append(mn[i, :L].copy())
        logps.append(ml[i, :L].copy())

    if hint is None:
        # from-scratch decode: this IS the anchor for later hint stages
        return Mappings(nodes, logps, read_logps, read_logps.copy(), 0)

    # acceptance gate (ref intent: posterior/test.rs:145-237 compares
    # extended vs fresh mapping likelihoods).  Two checks: per-stage drop
    # vs the previous constrained value, and TOTAL drop vs the last
    # from-scratch decode (anchor) — without the anchor, sub-gate
    # degradation ratchets silently across many k stages.
    anchor = hint.anchor_logps
    if anchor is None:
        anchor = hint.read_logps
    bad = ~np.isfinite(read_logps)
    # absolute floor: a real alignment never scores below ~ -2 nats/base
    # (p_mismatch ~ -8 applies to a small fraction of bases); a constrained
    # decode whose hint lost the read's path lands near the begin-re-entry
    # chain at ~ -9.3/base.  This fires even when BOTH relative references
    # are missing (e.g. a checkpoint restart loads maps with
    # read_logps=None) or themselves degraded (round-4 k=43 stall).
    lens_np = np.asarray([n.shape[0] for n in nodes], dtype=np.float64)
    with np.errstate(invalid="ignore"):
        bad |= read_logps < -5.0 * np.maximum(lens_np, 1.0)
    for ref_lp in (hint.read_logps, anchor):
        if ref_lp is not None:
            ref_lp = np.asarray(ref_lp, dtype=np.float64)
            if ref_lp.shape == read_logps.shape:
                with np.errstate(invalid="ignore"):
                    bad |= read_logps < (ref_lp - hint_gate)
    anchor_out = (np.asarray(anchor, dtype=np.float64).copy()
                  if anchor is not None and
                  np.shape(anchor) == read_logps.shape
                  else read_logps.copy())
    gate_rate = float(bad.mean())
    if bad.any() and not hint_regen:
        # seeded mappings: a floor-failing read is genuinely unexplainable
        # by the graph (broken truth, foreign read) — re-decoding it from
        # scratch would re-enter the seeding path; keep the constrained
        # result and let the score carry the penalty
        print(f"[mappings] {int(bad.sum())}/{n_reads} reads below the "
              "likelihood floor under seeded sets (kept)")
    if bad.any() and hint_regen:
        idx = np.flatnonzero(bad)
        # always announce: a firing gate marks hint degradation (a purge
        # broke read paths) and explains the from-scratch decode cost
        print(f"[mappings] hint gate: regenerating {len(idx)}/"
              f"{n_reads} reads from scratch")
        fresh = generate_mappings(
            dbg, params, [reads[int(i)] for i in idx],
            n_active=n_active, dtype=dtype, max_ratio=max_ratio,
            pad_to=codes.shape[1],
        )
        for j, i in enumerate(idx):
            nodes[int(i)] = fresh.nodes[j]
            logps[int(i)] = fresh.logps[j]
            read_logps[int(i)] = fresh.read_logps[j]
            anchor_out[int(i)] = fresh.read_logps[j]  # re-anchored

    return Mappings(nodes, logps, read_logps, anchor_out,
                    hint.stages_since_anchor + 1, gate_rate)


# -- score --------------------------------------------------------------------


@dataclass
class Score:
    """(ref: posterior.rs:170-206). All probabilities in log space."""

    likelihood: float
    prior: float
    genome_size: int
    n_euler_circuits: float
    time_likelihood: float = 0.0
    time_euler: float = 0.0

    def p(self) -> float:
        return self.likelihood + self.prior + self.n_euler_circuits

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @staticmethod
    def from_json(s: str) -> "Score":
        return Score(**json.loads(s))


@dataclass
class PosteriorSample:
    copy_nums: List[int]
    score: Score
    infos: List[UpdateInfo] = field(default_factory=list)

    def to_infos_string(self) -> str:
        return "[" + ",".join(str(i) for i in self.infos) + "]"


class Posterior:
    """(ref: posterior.rs:31-161)"""

    def __init__(self):
        self.samples: List[PosteriorSample] = []
        self.p: float = NEG_INF
        self._seen = {}

    def add(self, sample: PosteriorSample) -> None:
        key = tuple(sample.copy_nums)
        if key not in self._seen:
            self._seen[key] = sample
            self.p = ladd(self.p, sample.score.p())
            self.samples.append(sample)

    def contains(self, copy_nums: Sequence[int]) -> bool:
        return tuple(copy_nums) in self._seen

    def find(self, copy_nums: Sequence[int]) -> Optional[PosteriorSample]:
        return self._seen.get(tuple(copy_nums))

    def max_sample(self) -> PosteriorSample:
        return max(self.samples, key=lambda s: s.score.p())

    def max_copy_nums(self) -> List[int]:
        return self.max_sample().copy_nums

    def p_edge(self, edge: int) -> DiscreteDistribution:
        """Posterior distribution of the copy number of a compact edge
        (ref: posterior.rs:154-161 p_edge -> hist.rs:113-176
        DiscreteDistribution)."""
        return DiscreteDistribution.from_occurs(
            (s.copy_nums[edge], s.score.p() - self.p) for s in self.samples
        )

    def p_edge_x(self, edge: int, x: int) -> float:
        """Log P(X(e)=x | R)."""
        return self.p_edge(edge).logp.get(x, NEG_INF)


# -- scoring ------------------------------------------------------------------


def to_prior(dbg: MultiDbg, genome_size_expected: int, genome_size_sigma: int) -> float:
    """(ref: posterior.rs:230-241)"""
    return normal_bin_logp(
        dbg.genome_size(), float(genome_size_expected), float(genome_size_sigma)
    )


def _phmm_models_for_candidates(
    dbg: MultiDbg, params: PHMMParams, candidates: List[List[int]],
    template=None,
):
    """Vectorized per-candidate PHMM arrays via a topology template
    (replaces per-candidate graph iteration; see phmm.template)."""
    from ..phmm.template import make_template

    tpl = template if template is not None else make_template(dbg, params)
    return [tpl.model_for(cn) for cn in candidates]


def score_candidates(
    dbg: MultiDbg,
    params: PHMMParams,
    reads,
    candidates: List[List[int]],
    genome_size_expected: int,
    genome_size_sigma: int,
    codes=None,
    lens=None,
    dtype=None,
    map_nodes=None,
    positions=None,
    template=None,
    scorer=None,
    mesh=None,
) -> List[Score]:
    """Evaluate Score for a batch of copy-number candidates: likelihoods on
    device, prior + Euler count on host.  ``scorer`` (from
    :func:`dbgphmm_tpu.ops.batch.make_candidate_scorer`) holds the read
    streams on device and carries its own mesh; without one, candidates run
    through the vmapped kernel (mapping-constrained when ``map_nodes`` or
    ``positions`` is given), sharded over ``mesh`` when given."""
    from ..ops.forward import default_dtype

    if dtype is None:
        dtype = default_dtype()
    if codes is None:
        codes, lens = pad_reads(list(reads))

    t0 = time.time()
    if scorer is not None:
        lls = scorer.scores(candidates)
    else:
        # fixed-size sub-batches: one compiled shape, at most SUB-1 padding
        # slots instead of a power-of-two-padded launch over the batch
        SUB = 32
        lls = np.empty(len(candidates), dtype=np.float64)
        for c0 in range(0, len(candidates), SUB):
            chunk = list(candidates[c0 : c0 + SUB])
            models = _phmm_models_for_candidates(dbg, params, chunk, template)
            lls[c0 : c0 + len(chunk)] = candidate_log_likelihoods(
                models, codes, lens, dtype=dtype, map_nodes=map_nodes,
                positions=positions, mesh=mesh,
            )
    t_like = time.time() - t0

    scores = []
    work = dbg.copy()
    # incremental Euler counts: candidates are +-1-cycle neighbors of the
    # batch's base assignment, so the O(n^3) log-det factors once and each
    # candidate costs a rank-r update (graph/euler.EulerCache; the full
    # slogdet is ~4s per candidate at KIR-class compact sizes)
    from ..graph.euler import EulerCache

    ecache = EulerCache(dbg.compact, dbg.get_copy_nums())
    for cn, ll in zip(candidates, lls):
        t1 = time.time()
        work.set_copy_nums(cn)
        n_ec = ecache.count(cn)
        t_euler = time.time() - t1
        scores.append(
            Score(
                likelihood=float(ll),
                prior=to_prior(work, genome_size_expected, genome_size_sigma),
                genome_size=work.genome_size(),
                n_euler_circuits=n_ec,
                time_likelihood=t_like / len(candidates),
                time_euler=t_euler,
            )
        )
    return scores


# -- greedy posterior sampling (ref: posterior.rs:314-600) --------------------


def sample_posterior(
    dbg: MultiDbg,
    params: PHMMParams,
    reads,
    mappings: Optional[Mappings],
    genome_size_expected: int,
    genome_size_sigma: int,
    neighbor_config: Optional[NeighborConfig] = None,
    max_iter: int = 100,
    rescue_only: bool = True,
    dtype=None,
    verbose: bool = False,
    mesh=None,
) -> Posterior:
    if neighbor_config is None:
        neighbor_config = NeighborConfig()
    log = (lambda *a: print("[posterior]", *a)) if verbose else (lambda *a: None)

    post = Posterior()
    copy_nums = dbg.get_copy_nums()
    infos: List[UpdateInfo] = []
    work = dbg.copy()
    codes, lens = pad_reads(list(reads))
    from ..phmm.template import make_template

    template = make_template(dbg, params)
    map_nodes = None
    positions = None
    scorer = None
    if mappings is not None:
        freqs = mappings.to_node_freqs(dbg.n_edges_full())
        from ..ops.sparse import pad_mappings, precompute_positions

        width = max((n.shape[1] for n in mappings.nodes if n.size), default=8)
        t0 = time.time()
        map_nodes = pad_mappings(mappings, codes.shape[1], width)
        # a read whose mapping is entirely empty (unexplainable by the
        # graph — e.g. its constrained decode hit -inf) scores -inf for
        # EVERY candidate, which collapses all posterior weights to nan;
        # it carries zero discriminative signal, so drop it from scoring
        alive = (map_nodes >= 0).any(axis=(1, 2))
        if not alive.all():
            dead = np.flatnonzero(~alive)
            print(f"[posterior] excluding {len(dead)} read(s) with empty "
                  f"mappings from scoring: {dead.tolist()}")
            keep = np.flatnonzero(alive)
            codes, lens = codes[keep], lens[keep]
            map_nodes = map_nodes[keep]
            reads = [reads[int(i)] for i in keep]
        positions = precompute_positions(
            map_nodes, template.parent_idx, parent_exists=template.parent_exists
        )
        t_pos = time.time() - t0
        t0 = time.time()
        from ..ops.batch import make_candidate_scorer

        scorer = make_candidate_scorer(
            template, positions, codes, lens, template.params, mesh=mesh,
            dtype=dtype,
        )
        log(f"setup: positions {t_pos:.1f}s, scorer streams "
            f"{time.time()-t0:.1f}s (width={width})")
    else:
        freqs = np.ones(dbg.n_edges_full())
    coverage = sum(len(r) for r in reads) / genome_size_expected

    def evaluate_batch(cands_infos, infos_init):
        new = [
            (cn, info)
            for cn, info in cands_infos
            if not post.contains(cn)
        ]
        # dedup within batch
        seen = set()
        uniq = []
        for cn, info in new:
            key = tuple(cn)
            if key not in seen:
                seen.add(key)
                uniq.append((cn, info))
        if not uniq:
            return
        t0 = time.time()
        scores = score_candidates(
            work, params, reads, [cn for cn, _i in uniq],
            genome_size_expected, genome_size_sigma, codes, lens, dtype,
            positions=positions, template=template, scorer=scorer, mesh=mesh,
        )
        log(f"  scored {len(uniq)} candidates in {time.time()-t0:.1f}s")
        for (cn, info), sc in zip(uniq, scores):
            post.add(PosteriorSample(cn, sc, infos_init + [info]))

    # initial score
    init_scores = score_candidates(
        work, params, reads, [copy_nums], genome_size_expected,
        genome_size_sigma, codes, lens, dtype,
        positions=positions, template=template, scorer=scorer, mesh=mesh,
    )
    post.add(PosteriorSample(copy_nums, init_scores[0], []))

    n_iter = 0
    while n_iter < max_iter:
        work.set_copy_nums(copy_nums)
        t0 = time.time()
        nc = neighbor_config
        rescue = to_rescue_neighbors(
            work, freqs, coverage,
            nc.rescue_k_non_zero, nc.rescue_k_zero,
            nc.rescue_weighted_by_copy_num, nc.rescue_k_total,
            nc.rescue_sort_by_freq,
        )
        log(f"iter {n_iter}: {len(rescue)} rescue neighbors ({time.time()-t0:.1f}s)")
        if rescue_only:
            sets = [rescue]
        else:
            partial = to_neighbor_copy_nums_and_infos(
                work,
                NeighborConfig(
                    max_cycle_size=5, max_flip=2, use_long_cycles=True,
                    ignore_cycles_passing_terminal=True, use_reducers=False,
                ),
            )
            full = to_neighbor_copy_nums_and_infos(work, neighbor_config)
            sets = [rescue, partial, full]

        moved = False
        for i, cands in enumerate(sets):
            if not cands:
                continue
            evaluate_batch(cands, infos)
            # multi-move in rescue_only mode (ref: posterior.rs:532-590)
            if rescue_only and cands:
                current_score = post.find(copy_nums).score
                ranked = sorted(
                    (c for c in cands if post.contains(c[0])),
                    key=lambda c: post.find(c[0]).score.p(),
                    reverse=True,
                )
                cur = list(copy_nums)
                accepted = []
                for cn, info in ranked:
                    sc = post.find(cn).score
                    if sc.p() <= current_score.p():
                        break
                    cyc = info.cycle()
                    if is_independent_update(accepted, cyc):
                        apply_update_cycle(cur, cyc)
                        accepted.append(cyc)
                if accepted and not post.contains(cur):
                    mm_info = UpdateInfo(accepted, "multi_move")
                    scores = score_candidates(
                        work, params, reads, [cur], genome_size_expected,
                        genome_size_sigma, codes, lens, dtype,
                        positions=positions, template=template,
                        scorer=scorer, mesh=mesh,
                    )
                    post.add(PosteriorSample(cur, scores[0], infos + [mm_info]))

            best = post.max_sample()
            if best.copy_nums != copy_nums:
                copy_nums = best.copy_nums
                infos = best.infos
                n_iter += 1
                moved = True
                log(f"moved to p={best.score.p():.3f} via {best.to_infos_string()}")
                break
        if not moved:
            log(f"iter {n_iter}: local optimum")
            break
    return post


def purge_and_extend_with_posterior(
    dbg: MultiDbg,
    posterior: Posterior,
    k_max: int,
    p0: float,
    paths=None,
    mappings: Optional[Mappings] = None,
):
    """(ref: posterior.rs:644-695). ``p0`` is linear probability."""
    work = dbg.copy()
    work.set_copy_nums(posterior.max_copy_nums())
    edges_purge = []
    lp0 = np.log(p0) if p0 > 0 else NEG_INF
    for e in range(work.n_edges_compact()):
        if (
            work.copy_num_of_edge_in_compact(e) == 0
            and posterior.p_edge_x(e, 0) > lp0
        ):
            edges_purge.append(e)
    if paths is not None and edges_purge:
        # per-edge forensics BEFORE the purge maps are gone (the final
        # grade must be traceable to the stage and edge where truth left
        # the graph)
        true_full = set()
        for p in paths:
            if p is not None:
                true_full.update(int(x) for x in p)
        for e in edges_purge:
            full = [int(x) for x in work.edges_in_full(e)]
            n_true = sum(1 for x in full if x in true_full)
            if n_true:
                print(f"[infer] TRUTH-PURGE k={work.k}: compact e{e} "
                      f"({len(full)} full edges, {n_true} on a true path) "
                      f"p(0)={np.exp(posterior.p_edge_x(e, 0)):.4f} "
                      f"copy_max={work.copy_num_of_edge_in_compact(e)}")
    dbg2, paths2, maps2 = work.purge_and_extend(
        edges_purge, k_max, True, paths,
        list(mappings.nodes) if mappings is not None else None,
    )
    return dbg2, paths2, maps2


# -- top-level loop (ref: posterior.rs:698-826) --------------------------------


def infer_posterior_by_extension(
    k_max: int,
    dbg_init: MultiDbg,
    param_infer: PHMMParams,
    param_error: PHMMParams,
    reads,
    genome_size_expected: int,
    genome_size_sigma: int,
    neighbor_config: Optional[NeighborConfig] = None,
    max_iter: int = 100,
    p0: float = 0.8,
    on_iter: Optional[Callable] = None,
    paths=None,
    mappings: Optional[Mappings] = None,
    n_haplotypes: Optional[int] = None,
    dtype=None,
    verbose: bool = False,
    mesh=None,
    use_hint_mappings: bool = True,
):
    log = (lambda *a: print("[infer]", *a)) if verbose else (lambda *a: None)
    dbg = dbg_init.copy()
    if mappings is None:
        mappings = generate_mappings(dbg, param_error, reads, dtype=dtype, mesh=mesh)
    coverage = sum(len(r) for r in reads) / genome_size_expected

    while True:
        t0 = time.time()
        posterior = sample_posterior(
            dbg, param_infer, reads, mappings, genome_size_expected,
            genome_size_sigma, neighbor_config, max_iter, rescue_only=True,
            dtype=dtype, verbose=verbose, mesh=mesh,
        )
        dbg.set_copy_nums(posterior.max_copy_nums())
        log(f"k={dbg.k} posterior sampled in {time.time()-t0:.1f}s "
            f"({len(posterior.samples)} samples)")

        if on_iter is not None:
            on_iter(dbg, posterior, paths, mappings)

        if dbg.k >= k_max:
            break

        t0 = time.time()
        n_true_before = (
            sum(1 for p in paths if p is not None) if paths is not None else 0
        )
        dbg, paths, maps2 = purge_and_extend_with_posterior(
            dbg, posterior, k_max, p0, paths,
            mappings if use_hint_mappings else None,
        )
        if paths is not None:
            n_true_after = sum(1 for p in paths if p is not None)
            if n_true_after < n_true_before:
                # make truth loss observable AT the stage it happens (a
                # later restart otherwise blames the draft and the INSPECT
                # truth columns silently vanish)
                print(f"[infer] TRUTH LOST: purge at k={dbg.k} removed "
                      f"edges of {n_true_before - n_true_after} true "
                      f"haplotype path(s) ({n_true_after} still tracked)")
        log(f"extended to k={dbg.k} in {time.time()-t0:.1f}s")
        t0 = time.time()
        hint_m = None
        if (dbg.n_edges_full() > DENSE_COMPUTE_MAX_NODES
                and seeded_mapping_enabled()):
            # frontier regime regenerates by exact-match seeding each stage
            # (O(B*L) host work) — strictly better than upconverting the
            # previous stage's sets, so the hint machinery is bypassed
            maps2 = None
        elif getattr(mappings, "gate_rate", 0.0) >= 0.99:
            # the previous stage's hint decode was junk for every read —
            # the upconverted sets are not going to fare better after
            # another purge+extension; go straight to the from-scratch
            # decode and save the doomed constrained pass (~2 min/stage
            # at n4 widths)
            maps2 = None
        if use_hint_mappings and maps2 is not None:
            # upconverted active sets seed the next k's decode instead of a
            # full from-scratch regeneration (the reference's designed-but-
            # unwired hint path, multi_dbg.rs:1325-1334 / hint.rs:66-88);
            # maps2 comes back as padded per-read arrays
            hint_m = Mappings(
                maps2,
                [np.zeros(a.shape) for a in maps2],
                mappings.read_logps,
                mappings.anchor_logps,
                mappings.stages_since_anchor,
            )
        mappings = generate_mappings(
            dbg, param_error, reads, dtype=dtype, mesh=mesh, hint=hint_m,
            verbose=verbose,
        )
        log(f"mappings {'refined' if hint_m is not None else 'regenerated'} "
            f"in {time.time()-t0:.1f}s")
        t0 = time.time()
        freqs = mappings.to_node_freqs(dbg.n_edges_full())
        # sanity guard: each read-base contributes <= ~1 of probability
        # mass, so node freqs are bounded by ~n_reads.  A blown-up freq
        # means the refined mapping is junk (degraded hint the gate missed)
        # — and it poisons the MSE flow instance below into hours of
        # unit-granularity cycle canceling (round-4 k=43 stall).  Fall back
        # to a from-scratch decode instead.
        # threshold above the per-(read,node) cap ceiling: with the cap in
        # to_node_freqs this guard is a dormant safety net that only fires
        # if capping is somehow bypassed, not on legitimate capped values
        limit = max(mappings.mass_cap_total(), 1.0)
        if freqs.max(initial=0.0) > limit:
            print(f"[infer] mapping freqs blown up (max {freqs.max():.0f} "
                  f"> {limit:.0f}); regenerating mappings from scratch")
            mappings = generate_mappings(
                dbg, param_error, reads, dtype=dtype, mesh=mesh,
                verbose=verbose,
            )
            freqs = mappings.to_node_freqs(dbg.n_edges_full())
        # reference hardcodes Some(2) haplotypes here (posterior.rs:798);
        # we only fix the count when a terminal node exists
        nh = n_haplotypes if n_haplotypes is not None else 2
        if dbg.terminal_node_compact() is None:
            nh = None
        cn = min_squared_error_copy_nums_from_freqs(
            dbg, freqs, coverage, nh, fallback_copy_nums=dbg.get_copy_nums()
        )
        dbg.set_copy_nums(cn)
        log(f"copy nums re-initialized from freqs in {time.time()-t0:.1f}s")

    # final full-neighborhood sampling with the error params
    mappings = generate_mappings(dbg, param_error, reads, dtype=dtype, mesh=mesh)
    posterior = sample_posterior(
        dbg, param_error, reads, mappings, genome_size_expected,
        genome_size_sigma, neighbor_config, max_iter, rescue_only=False,
        dtype=dtype, verbose=verbose, mesh=mesh,
    )
    dbg.set_copy_nums(posterior.max_copy_nums())
    return dbg, posterior, paths, mappings
