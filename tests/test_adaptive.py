"""Sparse-adaptive forward/backward vs dense oracle
(ref: tests/hmm.rs sparse==dense oracle; forward.rs:621-638)."""

import jax.numpy as jnp
import numpy as np
import pytest

from dbgphmm_tpu.multi_dbg import MultiDbg
from dbgphmm_tpu.ops import forward_scores, node_freqs_and_mappings, pad_reads, to_device
from dbgphmm_tpu.ops.adaptive import forward_sparse_adaptive, mappings_sparse_adaptive
from dbgphmm_tpu.phmm import PHMMParams
from dbgphmm_tpu.phmm.model import linear_random_phmm
from dbgphmm_tpu.seq.collection import StyledSequence
from dbgphmm_tpu.seq.random_seq import generate


def test_adaptive_forward_score_matches_dense():
    m = linear_random_phmm(300, 0, PHMMParams.default())
    dm = to_device(m, dtype=jnp.float64)
    seq = generate(300, 0)
    reads = [seq[20:220], seq[100:290]]
    codes, lens = pad_reads(reads)
    dense = forward_scores(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=False)
    f = forward_sparse_adaptive(dm, jnp.asarray(codes), jnp.asarray(lens), n_top=40)
    diff = np.abs(np.asarray(f.e) - np.asarray(dense))
    # sparse drops negligible mass (ref oracle: < 1e-9 per cell at these sizes)
    assert np.all(diff < 1e-6), diff


def test_adaptive_truncation_keeps_top_nodes():
    """Regression: when the candidate width n_top*(D+1) exceeds the slot
    count A (small graphs, n < n_top*(D+1)), the [:, :A] truncation after
    dedup must keep the score-ranked top nodes, not -1 padding / low ids.
    Repro from round-1 advisor: n=128 linear PHMM, n_top=60, read from the
    high-id end — a sorted dedup returns -1-first rows and the sparse score
    collapses to -inf."""
    m = linear_random_phmm(100, 0, PHMMParams.default())
    dm = to_device(m, dtype=jnp.float64)
    seq = generate(100, 0)
    reads = [seq[60:95]]  # high-id end of the graph
    codes, lens = pad_reads(reads)
    dense = forward_scores(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=False)
    f = forward_sparse_adaptive(
        dm, jnp.asarray(codes), jnp.asarray(lens), n_top=60, n_warmup=4
    )
    assert np.all(np.isfinite(np.asarray(f.e)))
    diff = np.abs(np.asarray(f.e) - np.asarray(dense))
    assert np.all(diff < 1e-6), diff


def test_adaptive_mappings_match_dense_mappings():
    m = linear_random_phmm(200, 1, PHMMParams.default())
    dm = to_device(m, dtype=jnp.float64)
    seq = generate(200, 1)
    reads = [seq[10:150]]
    codes, lens = pad_reads(reads)
    _lp, _f, mn_dense, _ml = node_freqs_and_mappings(
        dm, jnp.asarray(codes), jnp.asarray(lens), renorm=False, n_active=5
    )
    lp, mn_sparse, ml_sparse = mappings_sparse_adaptive(
        dm, jnp.asarray(codes), jnp.asarray(lens), n_top=40, n_active=5
    )
    a = np.asarray(mn_dense)[0]
    b = np.asarray(mn_sparse)[0]
    L = int(lens[0])
    # top-1 node agrees at (almost) every position; top-5 sets mostly agree
    top1_agree = np.mean(a[:L, 0] == b[:L, 0])
    assert top1_agree > 0.98, top1_agree
    set_overlap = np.mean(
        [len(set(a[j]) & set(b[j])) / 5.0 for j in range(L)]
    )
    assert set_overlap > 0.9, set_overlap


def test_adaptive_on_dbg():
    """Mapping generation on a repeat DBG feeds the scoring kernel."""
    from dbgphmm_tpu.ops.sparse import forward_scores_mapped

    seq = b"TTAGGCTTCGATCGAATGCCTTAGGCTT"
    dbg = MultiDbg.from_styled_seqs(8, [StyledSequence.linear(seq)])
    model = dbg.to_phmm(PHMMParams.uniform(0.001), mode="non_zero")
    dm = to_device(model, dtype=jnp.float64)
    reads = [seq[2:26], seq[0:20]]
    codes, lens = pad_reads(reads)
    lp, mn, ml = mappings_sparse_adaptive(
        dm, jnp.asarray(codes), jnp.asarray(lens), n_top=10, n_active=8
    )
    assert np.all(np.isfinite(np.asarray(lp)))
    # use the mapping to score with the normal model
    model_n = dbg.to_phmm(PHMMParams.uniform(0.001))
    dmn = to_device(model_n, dtype=jnp.float64)
    s_mapped = forward_scores_mapped(
        dmn, jnp.asarray(codes), jnp.asarray(lens), mn, renorm=True
    )
    s_dense = forward_scores(dmn, jnp.asarray(codes), jnp.asarray(lens), renorm=False)
    assert np.all(np.abs(np.asarray(s_mapped) - np.asarray(s_dense)) < 0.1)


def test_dense_compute_regime_matches_dense_store(monkeypatch):
    """The dense-compute/compact-store mapping regime (n_warmup=L) must give
    the same mapping as the exact dense-store decode on the same graph."""
    import dbgphmm_tpu.multi_dbg.posterior as P
    from dbgphmm_tpu.multi_dbg import MultiDbg
    from dbgphmm_tpu.phmm.params import PHMMParams
    from dbgphmm_tpu.seq.collection import ReadCollection, StyledSequence

    h1 = b"TTAGGCTTCGATCGAATGCCAGGTTACGGA"
    h2 = b"TTAGGCTTGGATCGAATGCCAGGTTACGGA"
    dbg = MultiDbg.from_styled_seqs(8, [StyledSequence.linear(h1), StyledSequence.linear(h2)])
    reads = ReadCollection([h1[1:25], h2[3:27], h1[:20]])
    params = PHMMParams.uniform(0.001)

    exact = P.generate_mappings(dbg, params, reads)

    monkeypatch.setattr(P, "DENSE_MAPPING_MAX_NODES", 0)
    dense_compute = P.generate_mappings(dbg, params, reads)

    for me, mc in zip(exact.nodes, dense_compute.nodes):
        for j in range(me.shape[0]):
            se = set(me[j][me[j] >= 0].tolist())
            sc = set(mc[j][mc[j] >= 0].tolist())
            assert se == sc, (j, se, sc)


def test_mappings_refine_with_full_hint_matches_dense():
    """Refine with an all-nodes hint reproduces the dense decode exactly
    (forward/backward restricted to everything == dense)."""
    from dbgphmm_tpu.ops.adaptive import mappings_refine

    m = linear_random_phmm(60, 3, PHMMParams.default())
    dm = to_device(m, dtype=jnp.float64)
    seq = generate(60, 3)
    reads = [seq[5:50], seq[0:40]]
    codes, lens = pad_reads(reads)
    B, L = codes.shape
    n = m.n_nodes
    hint = np.tile(np.arange(n, dtype=np.int32), (B, L, 1))
    lp_d, _f, mn_d, ml_d = node_freqs_and_mappings(
        dm, jnp.asarray(codes), jnp.asarray(lens), renorm=True, n_active=5
    )
    lp_r, mn_r, ml_r = mappings_refine(
        dm, jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(hint),
        n_active=5,
    )
    np.testing.assert_allclose(np.asarray(lp_r), np.asarray(lp_d), atol=1e-9)
    for b in range(B):
        Lb = int(lens[b])
        assert np.array_equal(
            np.asarray(mn_r)[b, :Lb, 0], np.asarray(mn_d)[b, :Lb, 0]
        )
        np.testing.assert_allclose(
            np.asarray(ml_r)[b, :Lb], np.asarray(ml_d)[b, :Lb], atol=1e-6
        )


def test_mappings_refine_with_own_mapping_hint():
    """Refining with the fresh mapping as hint keeps the same top nodes and
    a likelihood close to the unconstrained one."""
    from dbgphmm_tpu.ops.adaptive import mappings_refine

    m = linear_random_phmm(150, 4, PHMMParams.default())
    dm = to_device(m, dtype=jnp.float64)
    seq = generate(150, 4)
    reads = [seq[10:120]]
    codes, lens = pad_reads(reads)
    lp_d, _f, mn_d, _ml = node_freqs_and_mappings(
        dm, jnp.asarray(codes), jnp.asarray(lens), renorm=True, n_active=12
    )
    lp_r, mn_r, _mlr = mappings_refine(
        dm, jnp.asarray(codes), jnp.asarray(lens), mn_d, n_active=12
    )
    assert abs(float(lp_r[0]) - float(lp_d[0])) < 0.1
    L = int(lens[0])
    top1_agree = np.mean(np.asarray(mn_r)[0, :L, 0] == np.asarray(mn_d)[0, :L, 0])
    assert top1_agree > 0.98, top1_agree


def test_generate_mappings_hint_gate_falls_back():
    """A garbage hint (wrong nodes) trips the acceptance gate and regenerates
    the read from scratch, matching the fresh mapping."""
    from dbgphmm_tpu.multi_dbg.posterior import Mappings, generate_mappings

    seq = b"TTAGGCTTCGATCGAATGCCTTAGGCTTACGTAGGAT"
    dbg = MultiDbg.from_styled_seqs(8, [StyledSequence.linear(seq)])
    params = PHMMParams.uniform(0.001)
    reads = [seq[2:30], seq[5:35]]
    fresh = generate_mappings(dbg, params, reads, n_active=8)
    assert fresh.read_logps is not None and np.all(np.isfinite(fresh.read_logps))
    # garbage hint: node 0 everywhere
    hnodes = [np.zeros((len(r), 2), dtype=np.int32) for r in reads]
    hint = Mappings(
        hnodes, [np.zeros(a.shape) for a in hnodes], fresh.read_logps
    )
    refined = generate_mappings(dbg, params, reads, n_active=8, hint=hint)
    assert np.all(np.isfinite(refined.read_logps))
    np.testing.assert_allclose(refined.read_logps, fresh.read_logps, atol=1e-6)
    for a, b in zip(refined.nodes, fresh.nodes):
        assert np.array_equal(a, b)


def test_generate_mappings_good_hint_accepted():
    """A faithful hint (the fresh mapping upconverted trivially, i.e. itself)
    is accepted by the gate and produces an equivalent mapping."""
    from dbgphmm_tpu.multi_dbg.posterior import generate_mappings

    seq = b"TTAGGCTTCGATCGAATGCCTTAGGCTTACGTAGGAT"
    dbg = MultiDbg.from_styled_seqs(8, [StyledSequence.linear(seq)])
    params = PHMMParams.uniform(0.001)
    reads = [seq[2:30], seq[5:35]]
    fresh = generate_mappings(dbg, params, reads, n_active=8)
    refined = generate_mappings(dbg, params, reads, n_active=8, hint=fresh)
    np.testing.assert_allclose(
        refined.read_logps, fresh.read_logps, atol=0.1
    )
    for a, b in zip(refined.nodes, fresh.nodes):
        # same top-1 node at every position
        assert np.array_equal(a[:, 0], b[:, 0])


def test_hint_gate_anchored_to_last_fresh_decode():
    """Sub-gate degradation must not ratchet across stages: the gate also
    compares against ``anchor_logps`` (the last from-scratch decode), so a
    cumulative drop beyond the budget fires even when each single stage
    stays under it (ADVICE r2)."""
    from dbgphmm_tpu.multi_dbg.posterior import Mappings, generate_mappings

    seq = b"TTAGGCTTCGATCGAATGCCTTAGGCTTACGTAGGAT"
    dbg = MultiDbg.from_styled_seqs(8, [StyledSequence.linear(seq)])
    params = PHMMParams.uniform(0.001)
    reads = [seq[2:30], seq[5:35]]
    fresh = generate_mappings(dbg, params, reads, n_active=8)
    assert fresh.anchor_logps is not None
    np.testing.assert_array_equal(fresh.anchor_logps, fresh.read_logps)
    assert fresh.stages_since_anchor == 0

    # simulate a hint whose constrained value has already drifted 2 gates
    # below the anchor, while the per-stage check alone would pass: the
    # previous stage's read_logps sit just above the decode's true value
    gate = 5.0
    drifted_prev = fresh.read_logps - 1.0       # passes per-stage check
    anchor = fresh.read_logps + 2 * gate        # total drop > gate
    hint = Mappings(
        [a.copy() for a in fresh.nodes],
        [a.copy() for a in fresh.logps],
        drifted_prev, anchor, 3,
    )
    refined = generate_mappings(
        dbg, params, reads, n_active=8, hint=hint, hint_gate=gate
    )
    # gate fired -> regenerated from scratch -> re-anchored at the fresh
    # values and the stage counter reflects the hint chain
    np.testing.assert_allclose(refined.read_logps, fresh.read_logps, atol=1e-6)
    np.testing.assert_allclose(refined.anchor_logps, fresh.read_logps, atol=1e-6)
    assert refined.stages_since_anchor == 4

    # control: an accurate anchor does NOT fire, and is carried unchanged
    hint_ok = Mappings(
        [a.copy() for a in fresh.nodes],
        [a.copy() for a in fresh.logps],
        fresh.read_logps, fresh.read_logps.copy(), 3,
    )
    refined_ok = generate_mappings(
        dbg, params, reads, n_active=8, hint=hint_ok, hint_gate=gate
    )
    np.testing.assert_array_equal(refined_ok.anchor_logps, fresh.read_logps)
    assert refined_ok.stages_since_anchor == 4


def test_compact_stored_decode_matches_full_storage():
    """stored_k + bf16 storage changes only the decode's cell granularity:
    the read log-likelihood is bit-identical (it comes from the scan carry)
    and the decoded mapping's top nodes agree with full-width f32 storage."""
    m = linear_random_phmm(300, 7, PHMMParams.default())
    dm = to_device(m, dtype=jnp.float32)
    seq = generate(300, 7)
    reads = [seq[20:220], seq[60:260], seq[0:190]]
    codes, lens = pad_reads(reads)
    full = mappings_sparse_adaptive(
        dm, jnp.asarray(codes), jnp.asarray(lens), n_top=40, n_active=16
    )
    compact = mappings_sparse_adaptive(
        dm, jnp.asarray(codes), jnp.asarray(lens), n_top=40, n_active=16,
        stored_k=48, store_bf16=True,
    )
    np.testing.assert_array_equal(
        np.asarray(full[0]), np.asarray(compact[0])
    )  # logp from the carry: storage-invariant
    mn_f, mn_c = np.asarray(full[1]), np.asarray(compact[1])
    for b, L in enumerate(lens):
        agree = np.mean(mn_f[b, :L, 0] == mn_c[b, :L, 0])
        assert agree > 0.99, (b, agree)


def test_next_active_slot_selection_exact_above_2048():
    """The frontier step reads the top nodes' children from the carried f32
    attribute block by slot; the selection must be exact for node ids far
    above 2048 (a TF32 matrix product keeps 10 mantissa bits and would
    return neighbouring ids there)."""
    from dbgphmm_tpu.ops.adaptive import (
        _gather_attrs,
        _next_active,
        _next_active_attrs,
        _pack_model,
    )
    from dbgphmm_tpu.ops.sparse import SState

    m = linear_random_phmm(6000, 0, PHMMParams.default())
    dm = to_device(m, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    B, A = 3, 24
    nodes = rng.choice(np.arange(2049, 5999), size=(B, A), replace=False)
    nodes[:, -2:] = -1  # empty slots
    vals = jnp.asarray(rng.normal(size=(B, A)), dtype=jnp.float32)
    st = SState(
        nodes=jnp.asarray(nodes, dtype=jnp.int32), m=vals, i=vals - 1.0,
        d=vals - 2.0, mb=jnp.zeros(B), ib=jnp.zeros(B), e=jnp.zeros(B),
        off=jnp.zeros(B), off_c=jnp.zeros(B),
    )
    attrs = _gather_attrs(_pack_model(dm), st.nodes)
    got = np.asarray(_next_active_attrs(dm, st, attrs, n_top=8))
    want = np.asarray(_next_active(dm, st, n_top=8))
    np.testing.assert_array_equal(got, want)
    assert (got[got >= 0] > 2048).all()
