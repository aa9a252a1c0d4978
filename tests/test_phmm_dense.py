"""Dense device-kernel parity vs the reference's hand-computed golden values.

Golden values are copied from the reference's unit tests
(ref: src/hmmv2/forward.rs:575-618, src/hmmv2/backward.rs:576-627,
tests/hmm.rs) -- the 10bp linear mock PHMM over "ATTCGATCGT".
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dbgphmm_tpu.ops import (
    backward_tables,
    forward_scores,
    forward_tables,
    full_prob_backward,
    node_freqs_and_mappings,
    pad_reads,
    to_device,
)
from dbgphmm_tpu.phmm import PHMMParams, linear_phmm
from dbgphmm_tpu.phmm.model import linear_random_phmm

MOCK_SEQ = b"ATTCGATCGT"  # ref: graph/mocks.rs mock_linear


def dense_model(params, dtype=jnp.float64):
    return to_device(linear_phmm(MOCK_SEQ, params), dtype=dtype)


def run_forward_tables(dm, read, renorm=False):
    codes, lens = pad_reads([read])
    final, tabs = forward_tables(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=renorm)
    return final, tabs


def test_forward_zero_error_golden():
    dm = dense_model(PHMMParams.zero_error())
    final, tabs = run_forward_tables(dm, b"CGATC")
    # ref: forward.rs:580-584
    assert float(tabs.m[2, 0, 5]) == pytest.approx(-2.3026250931, abs=1e-5)
    assert float(tabs.m[3, 0, 6]) == pytest.approx(-2.3026250931, abs=1e-5)
    assert float(tabs.m[4, 0, 7]) == pytest.approx(-2.3026350932, abs=1e-5)
    assert float(final.e[0]) == pytest.approx(-13.8155605, abs=1e-5)
    # no insertions/deletions possible
    assert np.all(np.asarray(tabs.i) == -np.inf)
    assert np.all(np.asarray(tabs.d) == -np.inf)
    # CGATT cannot be emitted with zero error
    codes, lens = pad_reads([b"CGATT"])
    scores = forward_scores(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=False)
    assert float(scores[0]) == -np.inf


def test_forward_high_error_golden():
    dm = dense_model(PHMMParams.high_error())
    final, tabs = run_forward_tables(dm, b"CGATC")
    # ref: forward.rs:599-618
    assert float(final.e[0]) == pytest.approx(-15.212633254, abs=1e-5)
    assert float(tabs.m[4, 0, 7]) == pytest.approx(-3.8652938682, abs=1e-5)
    final2, tabs2 = run_forward_tables(dm, b"CGATT")
    assert float(final2.e[0]) == pytest.approx(-16.7862972, abs=1e-5)
    # prefix CGAT shares the same table e
    assert float(tabs2.e[3, 0]) == pytest.approx(float(tabs.e[3, 0]), abs=1e-5)


def test_backward_zero_error_golden():
    dm = dense_model(PHMMParams.zero_error())
    codes, lens = pad_reads([b"CGATC"])
    final, tabs = backward_tables(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=False)
    # ref: backward.rs:587-595; scan order: tabs[t] = B[len-1-t]
    # B[0].mb = full prob
    assert float(final.mb[0]) == pytest.approx(-13.8155605, abs=1e-5)
    # tables[4].m[6] (B[4]) = scan step t = 5-1-4 = 0
    assert float(tabs.m[0, 0, 6]) == pytest.approx(-11.5129354, abs=1e-5)
    assert float(tabs.m[0, 0, 2]) == pytest.approx(-11.5129354, abs=1e-5)
    assert float(tabs.m[1, 0, 5]) == pytest.approx(-11.5129454, abs=1e-5)
    assert float(tabs.m[1, 0, 1]) == pytest.approx(-11.5129454, abs=1e-5)
    assert float(tabs.m[2, 0, 4]) == pytest.approx(-11.5129554, abs=1e-5)
    assert float(tabs.m[3, 0, 3]) == pytest.approx(-11.5129654, abs=1e-5)
    assert float(tabs.m[4, 0, 2]) == pytest.approx(-11.5129754, abs=1e-5)
    # CGATT impossible backward too
    codes, lens = pad_reads([b"CGATT"])
    p = full_prob_backward(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=False)
    assert float(p[0]) == -np.inf


def test_backward_high_error_golden():
    dm = dense_model(PHMMParams.high_error())
    codes, lens = pad_reads([b"CGATC", b"CGATT"])
    final, tabs = backward_tables(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=False)
    # ref: backward.rs:618-627
    assert float(tabs.m[4, 0, 2]) == pytest.approx(-13.0679200, abs=1e-5)
    assert float(final.mb[0]) == pytest.approx(-15.2115765494, abs=1e-5)
    assert float(final.mb[1]) == pytest.approx(-16.7787277, abs=1e-5)


def test_forward_equals_backward():
    """P(x) from forward ~= from backward (ref: tests/hmm.rs:44-56, which uses
    epsilon=0.1: the two directions differ slightly by construction -- the
    backward recursion includes Begin->Del entry paths that the forward
    excludes, exactly as in the reference)."""
    dm = dense_model(PHMMParams.default())
    reads = [b"CGATC", b"ATTCGATCGT", b"TTAGC"]
    codes, lens = pad_reads(reads)
    pf = forward_scores(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=False)
    pb = full_prob_backward(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=False)
    np.testing.assert_allclose(np.asarray(pf), np.asarray(pb), atol=1e-3)


def test_renorm_matches_no_renorm():
    """f64 renormalized scan == plain scan to 1e-9 (oracle for the accelerator f32
    path's renormalization logic)."""
    dm = to_device(
        linear_random_phmm(100, 0, PHMMParams.default()), dtype=jnp.float64
    )
    reads = [b"CGATC", b"ATTCGATCGT"]
    codes, lens = pad_reads(reads)
    p1 = forward_scores(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=False)
    p2 = forward_scores(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=True)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-9)


def test_f32_close_to_f64():
    m = linear_random_phmm(200, 0, PHMMParams.default())
    dm64 = to_device(m, dtype=jnp.float64)
    dm32 = to_device(m, dtype=jnp.float32)
    reads = [bytes(MOCK_SEQ * 3)]
    codes, lens = pad_reads(reads)
    p64 = forward_scores(dm64, jnp.asarray(codes), jnp.asarray(lens), renorm=False)
    p32 = forward_scores(dm32, jnp.asarray(codes), jnp.asarray(lens), renorm=True)
    assert abs(float(p64[0]) - float(p32[0])) < 0.01 * abs(float(p64[0]))


def test_mapping_golden():
    """Top-3 mapping nodes (ref: forward.rs:640-658 hint golden)."""
    dm = dense_model(PHMMParams.high_error())
    codes, lens = pad_reads([b"CGATC"])
    logp, freqs, map_nodes, map_logp = node_freqs_and_mappings(
        dm, jnp.asarray(codes), jnp.asarray(lens), renorm=False, n_active=3
    )
    expected = [
        [3, 2, 4],
        [4, 3, 5],
        [5, 6, 4],
        [6, 7, 5],
        [7, 8, 6],
    ]
    got = np.asarray(map_nodes)[0, :5].tolist()
    assert got == expected


def test_node_freqs_sum_to_length_ish():
    """Total expected node usage ~ number of emitted bases (each emission is
    generated by exactly one M or I state; D states add a little)."""
    dm = dense_model(PHMMParams.default())
    read = b"ATTCGATCGT"
    codes, lens = pad_reads([read])
    logp, freqs, _mn, _ml = node_freqs_and_mappings(
        dm, jnp.asarray(codes), jnp.asarray(lens), renorm=False, n_active=3
    )
    total = float(np.asarray(freqs).sum())
    # insertions at begin state are not node states; total in [len-1, len+1]
    assert abs(total - len(read)) < 1.0


def test_batch_consistency():
    """Batched scoring == per-read scoring (padding correctness)."""
    dm = dense_model(PHMMParams.default())
    reads = [b"CGATC", b"ATTCGATCGT", b"AT"]
    codes, lens = pad_reads(reads)
    p_batch = forward_scores(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=False)
    for i, r in enumerate(reads):
        c1, l1 = pad_reads([r])
        p1 = forward_scores(dm, jnp.asarray(c1), jnp.asarray(l1), renorm=False)
        assert float(p1[0]) == pytest.approx(float(p_batch[i]), abs=1e-12)
