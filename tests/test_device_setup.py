"""What the program picks from the platform it runs on: the candidate
scorer, the compile cache directory, and the chip smoke test's refusal to
run without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from dbgphmm_tpu import compile_cache
from dbgphmm_tpu.multi_dbg import MultiDbg
from dbgphmm_tpu.multi_dbg.posterior import generate_mappings
from dbgphmm_tpu.ops import batch, pad_reads
from dbgphmm_tpu.ops.pallas_mapped import PallasMappedScorer
from dbgphmm_tpu.ops.sparse import pad_mappings, precompute_positions
from dbgphmm_tpu.parallel import make_mesh
from dbgphmm_tpu.phmm.params import PHMMParams
from dbgphmm_tpu.phmm.template import make_template
from dbgphmm_tpu.seq.collection import ReadCollection, StyledSequence

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def scoring_inputs():
    h1 = b"TTAGGCTTCGATCGAATGCCAGGTTACG"
    h2 = b"TTAGGCTTGGATCGAATGCCAGGTTACG"
    dbg = MultiDbg.from_styled_seqs(
        8, [StyledSequence.linear(h1), StyledSequence.linear(h2)]
    )
    params = PHMMParams.uniform(0.001)
    reads = ReadCollection([h1[2:26], h2[3:27]])
    maps = generate_mappings(dbg, params, reads, n_active=12)
    codes, lens = pad_reads(list(reads))
    tpl = make_template(dbg, params)
    mn = pad_mappings(maps, codes.shape[1], 12)
    pos = precompute_positions(mn, tpl.parent_idx,
                               parent_exists=tpl.parent_exists)
    return tpl, pos, codes, lens, params


@pytest.mark.parametrize("platform, with_mesh, want", [
    ("gpu", False, PallasMappedScorer),
    ("gpu", True, PallasMappedScorer),
    ("cpu", False, batch.XlaMappedScorer),
    ("cpu", True, type(None)),
])
def test_scorer_selection_follows_platform(scoring_inputs, monkeypatch,
                                           platform, with_mesh, want):
    """The platform alone decides: no environment variable overrides it
    (the old DBGPHMM_PALLAS switch is set here and must be ignored)."""
    tpl, pos, codes, lens, params = scoring_inputs
    monkeypatch.setenv("DBGPHMM_PALLAS", "0")
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    mesh = make_mesh(4, cand_axis=2) if with_mesh else None
    scorer = batch.make_candidate_scorer(tpl, pos, codes, lens, params,
                                         mesh=mesh)
    assert type(scorer) is want
    if isinstance(scorer, PallasMappedScorer):
        # compiled for the card, never the interpreter
        assert scorer.interpret is False
        assert scorer.mesh is mesh


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_env(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == "sentinel"


def test_compile_cache_fixed_in_repo_path(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """No accelerator (or no repository beside the script): non-zero exit
    and no result line."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_xla_scorer_scores_in_fixed_launches(scoring_inputs):
    """XlaMappedScorer.scores splits any batch into launches of ``sub``
    candidates and agrees with one launch per candidate."""
    tpl, pos, codes, lens, params = scoring_inputs
    base = tpl.full_to_compact.max() + 1
    cands = [[1 + (i + e) % 2 for e in range(base)] for i in range(5)]
    sc = batch.XlaMappedScorer(tpl, pos, codes, lens, sub=2)
    got = sc.scores(cands)
    want = np.concatenate([sc.score_chunk([cn]) for cn in cands])
    assert got.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
