"""Full-scan GPU kernel (Pallas, Triton route) vs the f64 XLA positions
kernel.  On the CPU the kernel runs in interpret mode; the compiled kernel
is checked on a card by the ``gpu``-marked test (``python -m pytest -m gpu
tests/`` on a machine with an NVIDIA GPU) and by ``chip_smoke.py``.

Tolerances: the kernel computes in f32 with per-step renormalization, so a
read's log-likelihood carries ~1e-6 relative rounding from its ~L log-adds
(plus ~1e-4 absolute from the f32 output); the f64 reference is exact.  A
wrong transition, emission or dropped path moves a read by >= 1e-2 nats."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from dbgphmm_tpu.multi_dbg import MultiDbg
from dbgphmm_tpu.multi_dbg.posterior import generate_mappings
from dbgphmm_tpu.multi_dbg.neighbors import to_short_neighbors
from dbgphmm_tpu.ops import pad_reads, to_device
from dbgphmm_tpu.ops.pallas_mapped import (
    PallasMappedScorer,
    build_streams,
    eff_tables,
    log_params,
    pallas_mapped_scores,
)
from dbgphmm_tpu.ops.sparse import (
    forward_scores_mapped_pos,
    pad_mappings,
    precompute_positions,
)
from dbgphmm_tpu.phmm.params import PHMMParams
from dbgphmm_tpu.phmm.template import PHMMTemplate, make_template
from dbgphmm_tpu.seq.collection import ReadCollection, StyledSequence


@pytest.fixture(scope="module")
def setup():
    h1 = b"TTAGGCTTCGATCGAATGCCAGGTTACG"
    h2 = b"TTAGGCTTGGATCGAATGCCAGGTTACG"
    dbg = MultiDbg.from_styled_seqs(8, [StyledSequence.linear(h1), StyledSequence.linear(h2)])
    params = PHMMParams.uniform(0.001)
    reads = ReadCollection([h1[2:26], h2[3:27], h1[:24], h2[4:]])
    maps = generate_mappings(dbg, params, reads, n_active=12)
    codes, lens = pad_reads(list(reads), pad_to=32)
    tpl = make_template(dbg, params)
    mn = pad_mappings(maps, codes.shape[1], 12)
    pos = precompute_positions(mn, tpl.parent_idx, parent_exists=tpl.parent_exists)
    candidates = [dbg.get_copy_nums()] + [
        cn for cn, _i in to_short_neighbors(dbg, 8, 2)[:3]
    ]
    return dbg, params, tpl, pos, codes, lens, candidates


def _stream_args(streams, eff, linv):
    return [jnp.asarray(a) for a in (
        eff, linv, streams.lens, streams.codes, streams.emis, streams.numce,
        streams.selfp, streams.prevp, streams.curp, streams.dence,
    )]


def _reference_per_read(tpl, pos, codes, lens, cn):
    dm = to_device(tpl.model_for(cn), dtype=jnp.float64)
    return np.asarray(
        forward_scores_mapped_pos(
            dm, jnp.asarray(codes), jnp.asarray(lens),
            jnp.asarray(pos.map_nodes), jnp.asarray(pos.prev_pos),
            jnp.asarray(pos.cur_pos), jnp.asarray(pos.self_pos),
        )
    )


def test_pallas_matches_positions_kernel(setup):
    dbg, params, tpl, pos, codes, lens, candidates = setup
    streams = build_streams(tpl, pos, codes, lens)
    eff, linv = eff_tables(streams, candidates)

    out = np.asarray(
        pallas_mapped_scores(
            *_stream_args(streams, eff, linv), log_params(params),
            n_max_gaps=params.n_max_gaps, interpret=True,
        )
    )
    B = codes.shape[0]
    assert out.shape == (len(candidates), B)
    for c, cn in enumerate(candidates):
        ref = _reference_per_read(tpl, pos, codes, lens, cn)
        finite = np.isfinite(ref)
        assert np.all(np.isfinite(out[c][finite])), (c, out[c], ref)
        np.testing.assert_allclose(out[c][finite], ref[finite], atol=2e-3,
                                   rtol=1e-5)


def test_pallas_scorer_matches_score_candidates(setup):
    """PallasMappedScorer (the GPU scoring path) must rank and value
    candidates like the XLA mapped-pos scoring used on CPU."""
    from dbgphmm_tpu.ops.batch import candidate_log_likelihoods

    dbg, params, tpl, pos, codes, lens, candidates = setup
    # a read length that is no power of two
    codes_odd = codes[:, :27]
    pos_odd = precompute_positions(
        pos.map_nodes[:, :27], tpl.parent_idx, parent_exists=tpl.parent_exists
    )
    lens_odd = np.minimum(lens, 27)
    scorer = PallasMappedScorer(tpl, pos_odd, codes_odd, lens_odd, tpl.params,
                                interpret=True)
    got = scorer.scores(candidates)

    models = [tpl.model_for(cn) for cn in candidates]
    ref = candidate_log_likelihoods(
        models, codes_odd, lens_odd, positions=pos_odd
    )
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=1e-5)


def test_pallas_log_kernel_matches_f64(setup):
    """The log-space kernel must match the f64 XLA log kernel on both good
    candidates AND blocked ones (copy-0 cuts): very low but finite where the
    exact kernel is finite, -inf only where it is -inf."""
    dbg, params, tpl, pos, codes, lens, candidates = setup
    zero_mid = list(candidates[0])
    zero_mid[0] = 0  # zero out a used edge -> blocked reads
    cands = candidates + [zero_mid, [0] * dbg.n_edges_compact()]

    scorer = PallasMappedScorer(tpl, pos, codes, lens, tpl.params,
                                interpret=True)
    got = scorer.scores(cands)
    for c, cn in enumerate(cands):
        ref = _reference_per_read(tpl, pos, codes, lens, cn).sum()
        assert np.isfinite(got[c]) == np.isfinite(ref), (c, got[c], ref)
        if np.isfinite(ref):
            np.testing.assert_allclose(got[c], ref, atol=0.5, rtol=1e-4)
    assert not np.isfinite(got[-1])


def test_pallas_wide_mapping_width(setup):
    """Mapping widths above 64 slots (A0=80 buckets to A=128) still match
    the XLA positions kernel."""
    from dbgphmm_tpu.ops.batch import candidate_log_likelihoods

    dbg, params, tpl, pos, codes, lens, candidates = setup
    mn = pos.map_nodes
    B, L, A0 = mn.shape
    wide = np.full((B, L, 80), -1, dtype=mn.dtype)
    wide[:, :, :A0] = mn
    pos_w = precompute_positions(wide, tpl.parent_idx,
                                 parent_exists=tpl.parent_exists)
    models = [tpl.model_for(cn) for cn in candidates]
    ref = candidate_log_likelihoods(models, codes, lens, positions=pos_w)
    scorer = PallasMappedScorer(tpl, pos_w, codes, lens, tpl.params,
                                interpret=True)
    assert scorer.chunks[0].emis.shape[2] == 128
    got = scorer.scores(candidates)
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=1e-5)


def test_scorer_read_chunking_matches_single_chunk(setup):
    """Forcing a tiny read chunk (the device-memory bound) reproduces the
    unchunked scorer exactly."""
    from dbgphmm_tpu.ops.pallas_mapped import MappedPositionsLike

    dbg, params, tpl, pos, codes, lens, candidates = setup
    # tile to 20 reads so an 8-read chunk splits the batch three ways
    t = lambda a: np.concatenate([a] * 5, axis=0)
    codes, lens = t(codes), t(lens)
    pos = MappedPositionsLike(
        map_nodes=t(pos.map_nodes), prev_pos=t(pos.prev_pos),
        cur_pos=t(pos.cur_pos), self_pos=t(pos.self_pos),
    )
    one = PallasMappedScorer(tpl, pos, codes, lens, tpl.params,
                             interpret=True)
    chunked = PallasMappedScorer(tpl, pos, codes, lens, tpl.params,
                                 interpret=True, read_chunk=8)
    assert len(one.chunks) == 1
    assert len(chunked.chunks) == 3
    np.testing.assert_allclose(chunked.scores(candidates),
                               one.scores(candidates), atol=1e-4, rtol=1e-7)


def _chain_case(A: int, D: int, n: int = 300, nc: int = 24, B: int = 3,
                L: int = 40, seed: int = 0):
    """Synthetic graph where node v's parents are v-1 .. v-D, read along
    windows of ``A0`` consecutive nodes (A0 = 5/8 A: the slot width buckets
    up to A, so the kernel pads slots) with random holes; reads of unequal
    length (the shortest pads to L) follow the graph with substitutions."""
    rng = np.random.default_rng(seed)
    A0 = 5 * A // 8
    # degree columns bucket to {2, 5} as in make_template; the columns past
    # D are absent (build_streams trims them)
    off = np.arange(1, (2 if D <= 2 else 5) + 1)
    parent_idx = np.maximum(np.arange(n)[:, None] - off, 0).astype(np.int32)
    parent_exists = (np.arange(n)[:, None] >= off) & (off <= D)
    child_idx = np.minimum(np.arange(n)[:, None] + off, n - 1)
    child_exists = (np.arange(n)[:, None] + off < n) & (off <= D)
    emission = rng.integers(0, 4, n).astype(np.uint8)
    tpl = PHMMTemplate(
        params=PHMMParams.uniform(0.01), emission=emission,
        emittable=np.ones(n, bool), src_node=np.arange(n, dtype=np.int32),
        full_to_compact=(np.arange(n) * nc // n).astype(np.int32),
        parent_idx=parent_idx, parent_exists=parent_exists,
        child_idx=child_idx.astype(np.int32), child_exists=child_exists,
        n_nodes_graph=n,
    )
    start = rng.integers(0, n - L - A0, B)
    mn = (start[:, None, None] + np.arange(L)[None, :, None]
          + np.arange(A0)[None, None, :]).astype(np.int32)
    holes = rng.random(mn.shape) < 0.1
    holes[:, :, 0] = False
    mn = np.where(holes, -1, mn)
    codes = emission[start[:, None] + np.arange(L)[None, :]].astype(np.int32)
    codes = np.where(rng.random((B, L)) < 0.05, (codes + 1) % 4, codes)
    lens = np.array([L, L - 7, L - 15][:B], dtype=np.int32)
    for b in range(B):
        codes[b, lens[b]:] = -1
        mn[b, lens[b]:] = -1
    pos = precompute_positions(mn, parent_idx, parent_exists=parent_exists)
    cands = [np.ones(nc, dtype=np.int64).tolist()]
    for _ in range(4):
        cn = np.ones(nc, dtype=np.int64)
        cn[rng.choice(nc, 3, replace=False)] += rng.integers(1, 3, 3)
        cands.append(cn.tolist())
    return tpl, pos, codes.astype(np.int32), lens, cands


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("A", [16, 32, 64])
def test_kernel_matches_f64_reference(A, D):
    """Every width bucket and parent degree against the f64 reference, with
    padded slots, unequal read lengths, 3 reads and 5 candidates (padded to
    a launch of 8)."""
    tpl, pos, codes, lens, cands = _chain_case(A, D)
    scorer = PallasMappedScorer(tpl, pos, codes, lens, tpl.params,
                                interpret=True, sort_reads=False)
    s = scorer.chunks[0]
    assert s.emis.shape[2] == A and s.prevp.shape[1] == D
    assert scorer._launch_size(len(cands)) == 8
    got = scorer.scores(cands)
    ref = np.array([
        _reference_per_read(tpl, pos, codes, lens, cn).sum() for cn in cands
    ])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-3)


_GPU_PARITY = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
sys.path[:0] = [{repo!r}, {tests!r}]
jax.config.update("jax_enable_x64", True)
assert jax.devices()[0].platform == "gpu", jax.devices()
from test_pallas_mapped import _chain_case, _stream_args
from dbgphmm_tpu.ops.batch import candidate_log_likelihoods
from dbgphmm_tpu.ops.pallas_mapped import (
    build_streams, eff_tables, log_params, pallas_mapped_scores)
for A in (16, 32, 64):
    tpl, pos, codes, lens, cands = _chain_case(A, 3)
    s = build_streams(tpl, pos, codes, lens)
    eff, linv = eff_tables(s, cands)
    got = np.asarray(pallas_mapped_scores(
        *_stream_args(s, eff, linv), log_params(tpl.params),
        n_max_gaps=tpl.params.n_max_gaps)).sum(axis=1)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = candidate_log_likelihoods(
            [tpl.model_for(cn) for cn in cands], codes, lens,
            dtype=jnp.float64, positions=pos)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-3)
    print("A", A, "max abs err", float(np.abs(got - ref).max()))
"""


@pytest.mark.gpu
def test_compiled_kernel_matches_f64_reference_on_gpu(gpu):
    """The Triton-compiled kernel on the card against the f64 reference on
    the host CPU.  Runs in a child process: this test process is held to the
    CPU platform."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["XLA_FLAGS"] = ""
    r = subprocess.run(
        [sys.executable, "-c", _GPU_PARITY.format(
            repo=os.path.dirname(here), tests=here)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout + r.stderr
