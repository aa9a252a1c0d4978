"""f32 call-invariance audit (VERDICT r1 item 8; ref: src/prob.rs:181-203
"bit-identical" north star).

The accelerator path runs the DP in f32 with per-step renormalization + Kahan offset
tracking; the reference computes strict-logaddexp f64.  The *decisions* the
framework makes are argmax copy-number calls per k — this audit runs one
full small-genome inference at f64 and at f32 (both CPU) and asserts the
calls are identical at every k, recording the score deltas.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dbgphmm_tpu.multi_dbg import MultiDbg
from dbgphmm_tpu.multi_dbg.posterior import (
    generate_mappings,
    infer_posterior_by_extension,
    sample_posterior,
)
from dbgphmm_tpu.phmm.params import PHMMParams
from dbgphmm_tpu.seq.collection import ReadCollection, StyledSequence
from dbgphmm_tpu.seq.genome import Genome


def small_diploid():
    h1 = b"TTAGGCTTCGATCGAATGCCATTGCCTA"
    h2 = b"TTAGGCTTGGATCGAATGCCATTGCCTA"
    return Genome([StyledSequence.linear(h1), StyledSequence.linear(h2)])


def perfect_reads(genome, coverage=12, read_len=16, seed=1):
    rng = np.random.default_rng(seed)
    reads = []
    for s in genome:
        n = int(len(s.seq) * coverage / read_len)
        for _ in range(n):
            st = rng.integers(0, len(s.seq) - read_len + 1)
            reads.append(s.seq[st : st + read_len])
    return ReadCollection(reads)


def run_inference(dtype):
    g = small_diploid()
    dbg = MultiDbg.from_styled_seqs(8, [s for s in g])
    reads = perfect_reads(g)
    params = PHMMParams.uniform(0.001)
    per_k_calls = []
    per_k_best_scores = []

    def on_iter(dbg_k, posterior, paths, mappings):
        per_k_calls.append((dbg_k.k, tuple(posterior.max_copy_nums())))
        per_k_best_scores.append(posterior.max_sample().score.p())

    dbg_final, post, _p, _m = infer_posterior_by_extension(
        k_max=16,
        dbg_init=dbg,
        param_infer=params,
        param_error=params,
        reads=reads,
        genome_size_expected=g.genome_size(),
        genome_size_sigma=5,
        max_iter=10,
        p0=0.8,
        n_haplotypes=2,
        dtype=dtype,
        on_iter=on_iter,
    )
    haps = sorted(s.seq for s, _c in dbg_final.get_linear_haplotype_seqs())
    return per_k_calls, per_k_best_scores, haps, post.max_copy_nums()


def test_f32_argmax_calls_match_f64():
    calls64, scores64, haps64, final64 = run_inference(jnp.float64)
    calls32, scores32, haps32, final32 = run_inference(jnp.float32)
    # identical argmax copy-number calls at every k
    assert calls32 == calls64
    assert final32 == final64
    assert haps32 == haps64
    # score deltas stay small (documented in docs/ACCURACY_NOTES.md)
    deltas = [abs(a - b) for a, b in zip(scores64, scores32)]
    assert max(deltas) < 0.05, deltas


def test_f32_candidate_ranking_matches_f64():
    """Per-candidate scores keep their f64 RANKING under f32 — the quantity
    that picks hill-climb moves (ref: posterior.rs:504-530)."""
    g = small_diploid()
    dbg = MultiDbg.from_styled_seqs(8, [s for s in g])
    reads = perfect_reads(g, coverage=8)
    params = PHMMParams.uniform(0.001)
    posts = {}
    for dtype in (jnp.float64, jnp.float32):
        maps = generate_mappings(dbg, params, reads, dtype=dtype)
        posts[dtype] = sample_posterior(
            dbg, params, reads, maps, g.genome_size(), 5,
            max_iter=6, rescue_only=False, dtype=dtype,
        )
    p64, p32 = posts[jnp.float64], posts[jnp.float32]
    assert p64.max_copy_nums() == p32.max_copy_nums()
    # all samples seen by both runs rank identically
    common = [
        s.copy_nums for s in p64.samples
        if p32.contains(s.copy_nums)
    ]
    assert len(common) >= 3
    r64 = sorted(common, key=lambda cn: p64.find(cn).score.p())
    r32 = sorted(common, key=lambda cn: p32.find(cn).score.p())
    assert r64 == r32
