"""Per-read-chunk NC trimming + genome-locality read sort.

Trimming each read chunk's compact-id space to the edges its reads
reference shrinks the per-candidate eff table the kernel looks up every
step.  Trim + sort must be score-neutral: per-read sums are order-free and
the remap is a pure re-indexing.  (ref: src/hmmv2/forward.rs:79 — the hot
loop these kernels implement.)"""

import numpy as np
import pytest

from dbgphmm_tpu.multi_dbg import MultiDbg
from dbgphmm_tpu.multi_dbg.posterior import generate_mappings
from dbgphmm_tpu.ops import pad_reads
from dbgphmm_tpu.ops.pallas_mapped import PallasMappedScorer
from dbgphmm_tpu.ops.sparse import pad_mappings, precompute_positions
from dbgphmm_tpu.phmm.params import PHMMParams
from dbgphmm_tpu.phmm.template import make_template
from dbgphmm_tpu.seq import genome as G
from dbgphmm_tpu.seq.collection import ReadCollection


@pytest.fixture(scope="module")
def wide_nc_case():
    # single-unit diploid with SNP bubbles but no repeat ambiguity — the
    # production regime where reads reference only their local compact
    # neighborhoods (the real n4 k=40 chunks use 354/55 of 1,242 ids);
    # NC=544 -> nc_pad=1024, per-chunk used ~200 -> trim to 256
    g = G.tandem_repeat_polyploid_with_unique_homo_ends(
        8000, 1, 0, 0.0, 0, 200, 2, 0.015, 0
    )
    seqs = [s.seq for s in g]
    dbg = MultiDbg.from_styled_seqs(16, list(g))
    params = PHMMParams.uniform(0.001)
    rng = np.random.default_rng(0)
    reads = []
    for _ in range(16):
        h = seqs[int(rng.integers(len(seqs)))]
        st = int(rng.integers(0, max(1, len(h) - 400)))
        reads.append(h[st : st + 400])
    reads = ReadCollection(reads)
    maps = generate_mappings(dbg, params, reads, n_active=16)
    codes, lens = pad_reads(list(reads), pad_to=400)
    tpl = make_template(dbg, params)
    width = max(n.shape[1] for n in maps.nodes if n.size)
    mn = pad_mappings(maps, codes.shape[1], width)
    pos = precompute_positions(
        mn, tpl.parent_idx, parent_exists=tpl.parent_exists
    )
    base = list(dbg.get_copy_nums())
    cands = [base]
    for s in range(5):
        v = np.array(base)
        v[np.random.default_rng(s).integers(0, len(v), 3)] += 1
        cands.append(v.tolist())
    return dbg, tpl, pos, codes, lens, cands


def test_nc_trim_and_sort_score_neutral(wide_nc_case):
    dbg, tpl, pos, codes, lens, cands = wide_nc_case
    flat = PallasMappedScorer(
        tpl, pos, codes, lens, tpl.params, interpret=True,
        nc_trim=False, sort_reads=False, read_chunk=8,
    )
    trim = PallasMappedScorer(
        tpl, pos, codes, lens, tpl.params, interpret=True, read_chunk=8,
    )
    assert dbg.n_edges_compact() > 128  # the trim has headroom
    assert len(trim.chunks) > 1  # multiple read chunks exercised
    assert trim.chunks[0].ce_ids is not None, "trim did not trigger"
    assert trim.chunks[0].nc_pad < flat.chunks[0].nc_pad

    s_flat = flat.scores(cands)
    s_trim = trim.scores(cands)
    f = np.isfinite(s_flat)
    assert (f == np.isfinite(s_trim)).all()
    np.testing.assert_allclose(s_trim[f], s_flat[f], rtol=1e-5, atol=1e-4)
