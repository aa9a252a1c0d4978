"""Multi-chip sharding tests on the 8-virtual-device CPU mesh
(SURVEY.md section 2.11: read-DP + candidate parallelism with psum merge)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dbgphmm_tpu.ops import forward_scores, pad_reads, to_device
from dbgphmm_tpu.parallel import (
    make_mesh,
    sharded_candidate_log_likelihoods,
    sharded_forward_total,
)
from dbgphmm_tpu.phmm import PHMMParams, linear_phmm


@pytest.fixture(scope="module")
def setup():
    assert len(jax.devices()) >= 8, "needs 8 virtual devices (conftest)"
    seq = b"ATTCGATCGTACGGTTAACG" * 3
    dm = to_device(linear_phmm(seq, PHMMParams.default()), dtype=jnp.float64)
    reads = [seq[i : i + 30] for i in range(0, 30, 3)]  # 10 reads
    codes, lens = pad_reads(reads)
    return dm, codes, lens


def test_sharded_total_matches_local(setup):
    dm, codes, lens = setup
    local = float(
        jnp.sum(forward_scores(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=True))
    )
    for shape in [(1, 8), (2, 4), (1, 4)]:
        mesh = make_mesh(shape[0] * shape[1], cand_axis=shape[0])
        total = sharded_forward_total(dm, codes, lens, mesh)
        assert total == pytest.approx(local, abs=1e-9), shape


def test_sharded_candidates_match_local(setup):
    dm, codes, lens = setup
    # 4 candidates with scaled init probs
    dms = [
        dataclasses.replace(dm, init_logp=dm.init_logp + jnp.log(s))
        for s in (1.0, 0.5, 0.25, 0.125)
    ]
    mesh = make_mesh(8, cand_axis=2)
    lls = sharded_candidate_log_likelihoods(dms, codes, lens, mesh)
    for i, d in enumerate(dms):
        local = float(
            jnp.sum(forward_scores(d, jnp.asarray(codes), jnp.asarray(lens), renorm=True))
        )
        assert lls[i] == pytest.approx(local, abs=1e-9)
    # scaling init by s multiplies every read's P by s -> total shifts by
    # n_reads * log(s)
    n = codes.shape[0]
    assert lls[1] - lls[0] == pytest.approx(n * np.log(0.5), abs=1e-6)


@pytest.fixture(scope="module")
def dbg_setup():
    """Small diploid DBG + reads + mappings: the production scoring inputs."""
    from dbgphmm_tpu.multi_dbg import MultiDbg
    from dbgphmm_tpu.multi_dbg.posterior import generate_mappings
    from dbgphmm_tpu.seq.collection import ReadCollection, StyledSequence

    h1 = b"TTAGGCTTCGATCGAATGCCAGGTTACGGATTCAAGGC"
    h2 = b"TTAGGCTTGGATCGAATGCCAGGTTACGGATTCAAGGC"
    dbg = MultiDbg.from_styled_seqs(
        8, [StyledSequence.linear(h1), StyledSequence.linear(h2)]
    )
    reads = ReadCollection(
        [h1[1:30], h2[3:33], h1[:25], h2[10:38], h1[5:35], h2[:20]]
    )
    params = PHMMParams.uniform(0.001)
    mappings = generate_mappings(dbg, params, reads)
    return dbg, reads, params, mappings


def _mapped_scoring_inputs(dbg, reads, params, mappings):
    from dbgphmm_tpu.ops.sparse import pad_mappings, precompute_positions
    from dbgphmm_tpu.phmm.template import make_template

    codes, lens = pad_reads(list(reads))
    template = make_template(dbg, params)
    width = max(n.shape[1] for n in mappings.nodes)
    map_nodes = pad_mappings(mappings, codes.shape[1], width)
    positions = precompute_positions(
        map_nodes, template.parent_idx, parent_exists=template.parent_exists
    )
    return codes, lens, template, positions


def _neighbor_candidates(dbg):
    base = dbg.get_copy_nums()
    cands = [list(base)]
    for e in range(min(3, len(base))):
        up = list(base)
        up[e] += 1
        cands.append(up)
    return cands


def test_sharded_mapped_candidates_match_local(dbg_setup):
    """The PRODUCTION scoring path (mapping-constrained kernel with
    precomputed positions) gives identical candidate log-likelihoods sharded
    over the ("cand", "reads") mesh and locally (f64 CPU exact)."""
    from dbgphmm_tpu.multi_dbg.posterior import _phmm_models_for_candidates
    from dbgphmm_tpu.ops.batch import candidate_log_likelihoods

    dbg, reads, params, mappings = dbg_setup
    codes, lens, template, positions = _mapped_scoring_inputs(
        dbg, reads, params, mappings
    )
    cands = _neighbor_candidates(dbg)
    models = _phmm_models_for_candidates(dbg, params, cands, template)
    local = candidate_log_likelihoods(
        models, codes, lens, dtype=jnp.float64, positions=positions
    )
    assert len(set(np.round(local, 6))) > 1, "candidates must be distinct"
    for shape in [(2, 4), (4, 2), (1, 8)]:
        mesh = make_mesh(shape[0] * shape[1], cand_axis=shape[0])
        sharded = candidate_log_likelihoods(
            models, codes, lens, dtype=jnp.float64, positions=positions,
            mesh=mesh,
        )
        np.testing.assert_allclose(sharded, local, rtol=0, atol=1e-9)


def test_sharded_pallas_scorer_matches_local(dbg_setup):
    """The full-scan kernel scorer (interpret mode on CPU) returns the same
    totals shard_mapped over the mesh and locally."""
    from dbgphmm_tpu.ops.pallas_mapped import PallasMappedScorer

    dbg, reads, params, mappings = dbg_setup
    codes, lens, template, positions = _mapped_scoring_inputs(
        dbg, reads, params, mappings
    )
    cands = _neighbor_candidates(dbg)
    local = PallasMappedScorer(template, positions, codes, lens, params,
                               interpret=True)
    l_tot = local.scores(cands)
    mesh = make_mesh(8, cand_axis=2)
    sharded = PallasMappedScorer(
        template, positions, codes, lens, params, mesh=mesh, interpret=True
    )
    s_tot = sharded.scores(cands)
    assert np.isfinite(l_tot).all()
    np.testing.assert_allclose(s_tot, l_tot, rtol=0, atol=1e-3)


def test_sharded_sample_posterior_matches_local(dbg_setup):
    """One full production inference step (sample_posterior with mappings:
    rescue neighbors, mapped scoring, multi-move) on the 8-device mesh equals
    the single-device run: same sample set, same scores, same argmax."""
    from dbgphmm_tpu.multi_dbg.posterior import sample_posterior

    dbg, reads, params, mappings = dbg_setup
    G = dbg.genome_size()
    post_local = sample_posterior(
        dbg, params, reads, mappings, G, 100, max_iter=3
    )
    mesh = make_mesh(8, cand_axis=2)
    post_sharded = sample_posterior(
        dbg, params, reads, mappings, G, 100, max_iter=3, mesh=mesh
    )
    assert post_sharded.max_copy_nums() == post_local.max_copy_nums()
    loc = {tuple(s.copy_nums): s.score for s in post_local.samples}
    shd = {tuple(s.copy_nums): s.score for s in post_sharded.samples}
    assert set(loc) == set(shd)
    for key in loc:
        assert shd[key].likelihood == pytest.approx(
            loc[key].likelihood, abs=1e-9
        )
        assert shd[key].p() == pytest.approx(loc[key].p(), abs=1e-9)


def test_sharded_generate_mappings_matches_local(dbg_setup):
    from dbgphmm_tpu.multi_dbg.posterior import generate_mappings

    dbg, reads, params, mappings = dbg_setup
    mesh = make_mesh(8, cand_axis=2)
    sharded = generate_mappings(dbg, params, reads, mesh=mesh)
    assert sharded.n_reads() == mappings.n_reads()
    for a, b in zip(mappings.nodes, sharded.nodes):
        w = min(a.shape[1], b.shape[1])
        np.testing.assert_array_equal(a[:, :w], b[:, :w])
        assert (a[:, w:] < 0).all() and (b[:, w:] < 0).all()


def test_sharded_generate_mappings_with_hint_matches_local(dbg_setup):
    """Hint-seeded regeneration (mappings_refine, the steady-state per-k
    path) under a mesh matches the local hint run read-for-read (ADVICE r2:
    mesh+hint generate_mappings had no test)."""
    from dbgphmm_tpu.multi_dbg.posterior import generate_mappings

    dbg, reads, params, mappings = dbg_setup
    local = generate_mappings(dbg, params, reads, hint=mappings)
    mesh = make_mesh(8, cand_axis=2)
    sharded = generate_mappings(dbg, params, reads, hint=mappings, mesh=mesh)
    assert sharded.n_reads() == local.n_reads()
    for a, b in zip(local.nodes, sharded.nodes):
        w = min(a.shape[1], b.shape[1])
        np.testing.assert_array_equal(a[:, :w], b[:, :w])
        assert (a[:, w:] < 0).all() and (b[:, w:] < 0).all()
    np.testing.assert_allclose(
        np.asarray(local.read_logps), np.asarray(sharded.read_logps),
        rtol=0, atol=1e-6,
    )


def test_uneven_read_count_padding(setup):
    dm, codes, lens = setup
    # 10 reads on an 8-way mesh: padding path
    mesh = make_mesh(8, cand_axis=1)
    total = sharded_forward_total(dm, codes, lens, mesh)
    local = float(
        jnp.sum(forward_scores(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=True))
    )
    assert total == pytest.approx(local, abs=1e-9)
