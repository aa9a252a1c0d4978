"""Chip smoke test: prove that the main path runs on one NVIDIA GPU.

    python chip_smoke.py               # phases a + b on one GPU
    python chip_smoke.py --devices 4   # phase c only, on four GPUs

Phases (one process; the CLI runs in-process, so only this process holds
the card):

a. Kernel parity at real width.  The selected candidate scorer on the card
   against the plain reference (the XLA positions kernel in f64 on the host
   CPU backend) on the ``data/bench`` fixture (n4 draft, k=40, 98 reads x
   10 kb, seeded mappings trimmed to width 32, 64 rescue-style candidates)
   and on a synthetic width-64 chain (KIR-class width).  Both scorers on
   the card are also timed on the fixture's batch.
b. The main path: ``infer`` from the k=40 draft to K=42 on the fixture's
   reads; all four ``.final.*`` outputs must be written.
c. (``--devices 4`` only) one sampling stage on a 2x2 ("cand", "reads")
   mesh against the same stage on one card.

Fails (non-zero exit, no result line) when JAX finds no GPU.  The last line
of stdout is one JSON object: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "data" / "bench"

# f32 tables with per-step renormalization over 10k steps against an f64
# reference: rounding grows ~linearly in read length; 1e-5 of a total
# log-likelihood leaves that headroom while catching any wrong transition,
# emission or dropped path (each moves a total by >= 1e-3 relative).
REL_TOL = 1e-5
N_CANDS = 64
N_REF_CANDS = 4  # candidates checked against the f64 host reference
WIDTH = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def device_header(jax) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    log(f"# nvidia-smi: {smi[0]}")
    d = jax.devices()[0]
    log(f"# device_kind={d.device_kind} count={len(jax.devices())} "
        f"jax={jax.__version__}")


def load_fixture():
    from dbgphmm_tpu.e2e import Dataset
    from dbgphmm_tpu.multi_dbg import output as out

    ds = Dataset.from_json_file(str(FIXTURE / "data.json"))
    dbg = out.from_dbg_file(str(FIXTURE / "data.dbg"))
    return ds, dbg


def bench_batch(ds, dbg):
    """(template, positions, codes, lens, candidates) of the fixture."""
    import numpy as np

    from dbgphmm_tpu.multi_dbg.posterior import Mappings
    from dbgphmm_tpu.multi_dbg.seed import seed_mappings_arrays
    from dbgphmm_tpu.ops.forward import pad_reads
    from dbgphmm_tpu.ops.sparse import pad_mappings, precompute_positions
    from dbgphmm_tpu.phmm.params import PHMMParams
    from dbgphmm_tpu.phmm.template import make_template

    reads = list(ds.reads)
    arrs = [a[:, :WIDTH] for a in seed_mappings_arrays(dbg, reads)]
    maps = Mappings(arrs, [np.zeros(a.shape) for a in arrs])
    codes, lens = pad_reads(reads)
    tpl = make_template(dbg, PHMMParams.uniform(0.0003))
    mn = pad_mappings(maps, codes.shape[1], max(a.shape[1] for a in arrs))
    pos = precompute_positions(mn, tpl.parent_idx,
                               parent_exists=tpl.parent_exists)
    # distinct rescue-style candidates: +-1 bumps of compact edges around
    # the draft assignment (deterministic)
    nc = dbg.n_edges_compact()
    base = np.asarray(dbg.get_copy_nums(), dtype=np.int64)
    rng = np.random.default_rng(7)
    cands = [base.tolist()]
    while len(cands) < N_CANDS:
        cn = base.copy()
        e = rng.choice(nc, 4, replace=False)
        cn[e] = np.maximum(cn[e] + rng.choice([-1, 1], 4), 0)
        cands.append(cn.tolist())
    return tpl, pos, codes, lens, cands


def synthetic_batch(A: int = 64, n: int = 100_000, nc: int = 4096,
                    B: int = 16, L: int = 10_000, seed: int = 0):
    """A chain graph read along windows of A consecutive nodes: every slot's
    parent sits one slot over, so the kernel runs at full width A."""
    import numpy as np

    from dbgphmm_tpu.ops.sparse import precompute_positions
    from dbgphmm_tpu.phmm.params import PHMMParams
    from dbgphmm_tpu.phmm.template import PHMMTemplate

    rng = np.random.default_rng(seed)
    D = 2
    parent_idx = np.zeros((n, D), dtype=np.int32)
    parent_idx[:, 0] = np.maximum(np.arange(n) - 1, 0)
    parent_exists = np.zeros((n, D), dtype=bool)
    parent_exists[1:, 0] = True
    child_idx = np.zeros((n, D), dtype=np.int32)
    child_idx[:, 0] = np.minimum(np.arange(n) + 1, n - 1)
    child_exists = np.zeros((n, D), dtype=bool)
    child_exists[:-1, 0] = True
    emission = rng.integers(0, 4, n).astype(np.uint8)
    tpl = PHMMTemplate(
        params=PHMMParams.uniform(0.001), emission=emission,
        emittable=np.ones(n, bool), src_node=np.arange(n, dtype=np.int32),
        full_to_compact=(np.arange(n) * nc // n).astype(np.int32),
        parent_idx=parent_idx, parent_exists=parent_exists,
        child_idx=child_idx, child_exists=child_exists, n_nodes_graph=n,
    )
    start = rng.integers(0, n - L - A, B)
    mn = (start[:, None, None] + np.arange(L)[None, :, None]
          + np.arange(A)[None, None, :]).astype(np.int32)
    codes = emission[start[:, None] + np.arange(L)[None, :]].astype(np.int32)
    err = rng.random((B, L)) < 0.01  # 1% substitutions
    codes = np.where(err, (codes + 1) % 4, codes).astype(np.int32)
    lens = np.full(B, L, dtype=np.int32)
    pos = precompute_positions(mn, parent_idx, parent_exists=parent_exists)
    cands = [np.ones(nc, dtype=np.int64).tolist()]
    for c in range(1, 8):
        cn = np.ones(nc, dtype=np.int64)
        cn[rng.choice(nc, 8, replace=False)] += rng.integers(1, 3, 8)
        cands.append(cn.tolist())
    return tpl, pos, codes, lens, cands


def reference_totals(tpl, pos, codes, lens, cands):
    """Plain reference: the XLA positions kernel in f64 on the host CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dbgphmm_tpu.ops.batch import candidate_log_likelihoods

    with jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(candidate_log_likelihoods(
            [tpl.model_for(cn) for cn in cands], codes, lens,
            dtype=jnp.float64, positions=pos,
        ))


def check_parity(name, got, ref):
    import numpy as np

    rel = np.abs(got - ref) / np.abs(ref)
    worst = float(rel.max())
    log(f"# parity {name}: worst relative error {worst:.3e} "
        f"(tol {REL_TOL:.0e}); argmax card={int(np.argmax(got))} "
        f"ref={int(np.argmax(ref))}")
    if not (np.isfinite(got).all() and worst <= REL_TOL
            and np.argmax(got) == np.argmax(ref)):
        raise AssertionError(f"parity {name} failed: got={got} ref={ref}")
    return worst


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def phase_a() -> None:
    import jax

    from dbgphmm_tpu.ops.batch import XlaMappedScorer, make_candidate_scorer

    log("# phase a: kernel parity at real width")
    ds, dbg = load_fixture()
    t0 = time.perf_counter()
    tpl, pos, codes, lens, cands = bench_batch(ds, dbg)
    log(f"# fixture: n={dbg.n_edges_full()} full edges, "
        f"NC={dbg.n_edges_compact()}, {len(lens)} reads x {codes.shape[1]}, "
        f"width {pos.map_nodes.shape[2]}, {len(cands)} candidates "
        f"(host setup {time.perf_counter() - t0:.1f}s)")

    scorer = make_candidate_scorer(tpl, pos, codes, lens, tpl.params)
    log(f"# selected scorer: {type(scorer).__name__} "
        f"(platform {jax.default_backend()})")
    got, t_cold = timed(scorer.scores, cands)
    got, t_warm = timed(scorer.scores, cands)
    log(f"# {type(scorer).__name__}: {len(cands)} candidates x {len(lens)} "
        f"reads: first call {t_cold:.3f}s (compile incl.), warm {t_warm:.3f}s")
    got_x = None
    if not isinstance(scorer, XlaMappedScorer):
        xla = XlaMappedScorer(tpl, pos, codes, lens)
        got_x, tx_cold = timed(xla.scores, cands)
        got_x, tx_warm = timed(xla.scores, cands)
        log(f"# XlaMappedScorer: first call {tx_cold:.3f}s, warm "
            f"{tx_warm:.3f}s; kernel speedup {tx_warm / t_warm:.2f}x")
        del xla
    ref = reference_totals(tpl, pos, codes, lens, cands[:N_REF_CANDS])
    if got_x is not None:
        err_x = abs(got_x[:N_REF_CANDS] - ref) / abs(ref)
        log(f"# XlaMappedScorer (f32) vs f64 reference: worst relative "
            f"error {err_x.max():.3e}")
    check_parity("data/bench width 32", got[:N_REF_CANDS], ref)
    if hasattr(scorer, "chunks"):
        from dbgphmm_tpu.ops.pallas_mapped import eff_tables, pallas_mapped_scores

        s = scorer.chunks[0]
        eff, linv = eff_tables(s, cands)
        args = [jax.numpy.asarray(a) for a in (
            eff, linv, s.lens, s.codes, s.emis, s.numce, s.selfp, s.prevp,
            s.curp, s.dence)] + [scorer.lt_log]
        compiled = pallas_mapped_scores.lower(
            *args, n_max_gaps=scorer.n_max_gaps).compile()
        log(f"# memory_analysis (A={s.emis.shape[2]}, C={len(cands)}, "
            f"B={s.emis.shape[1]}): {compiled.memory_analysis()}")
    del scorer

    tpl, pos, codes, lens, cands = synthetic_batch()
    scorer = make_candidate_scorer(tpl, pos, codes, lens, tpl.params)
    got, t = timed(scorer.scores, cands)
    log(f"# synthetic width 64: {len(cands)} candidates x {len(lens)} reads "
        f"in {t:.3f}s (compile incl.)")
    check_parity("synthetic width 64", got,
                 reference_totals(tpl, pos, codes, lens, cands))


def phase_b() -> None:
    ds, dbg = load_fixture()
    k_max = dbg.k + 2
    log(f"# phase b: infer on {FIXTURE.name}, k={dbg.k} -> K={k_max}")
    with tempfile.TemporaryDirectory() as out_dir:
        _infer(ds, k_max, Path(out_dir))


def _infer(ds, k_max: int, out_dir: Path) -> None:
    from dbgphmm_tpu import cli

    fasta = out_dir / "reads.fa"
    ds.reads.to_fasta(str(fasta))
    prefix = out_dir / "infer"
    t0 = time.time()
    cli.main([
        "infer", "-d", str(FIXTURE / "data.dbg"), "-K", str(k_max),
        "-G", str(ds.genome_size()), "-p", "0.0003", "-e", "0.0003",
        "-I", "2", "-o", str(prefix), str(fasta),
    ])
    t_end = time.time()
    # each stage's time: from the previous stage's dump to this one's
    stages = sorted(out_dir.glob("infer.k*.dbg"),
                    key=lambda p: p.stat().st_mtime)
    last = t0
    for p in stages:
        m = p.stat().st_mtime
        log(f"# stage {p.name.split('.')[1]}: {m - last:.1f}s")
        last = m
    log(f"# final sampling + outputs: {t_end - last:.1f}s; "
        f"infer total {t_end - t0:.1f}s")
    if len(stages) < 2:
        raise AssertionError(f"expected two k-stages, got {stages}")
    for ext in ("dbg", "gfa", "inspect", "euler.fa"):
        f = Path(f"{prefix}.final.{ext}")
        if not (f.exists() and f.stat().st_size > 0):
            raise AssertionError(f"missing output {f}")
    log("# wrote infer.final.{dbg,gfa,inspect,euler.fa}")


def phase_c(n_devices: int = 4) -> None:
    """One sampling stage on a 2x2 mesh against the same stage on one card."""
    import numpy as np

    from dbgphmm_tpu import cli
    from dbgphmm_tpu.multi_dbg.posterior import (
        generate_mappings, sample_posterior,
    )
    from dbgphmm_tpu.phmm.params import PHMMParams

    log(f"# phase c: one stage on a 2x2 mesh vs one card ({n_devices} devices)")
    ds, dbg = load_fixture()
    params = PHMMParams.uniform(0.0003)
    G = ds.genome_size()
    mesh = cli._make_mesh_from_arg("2x2")
    runs = {}
    for name, m in (("one card", None), ("2x2 mesh", mesh)):
        t0 = time.time()
        maps = generate_mappings(dbg, params, ds.reads, mesh=m)
        post = sample_posterior(dbg, params, ds.reads, maps, G, 100,
                                max_iter=2, mesh=m)
        runs[name] = post
        log(f"# {name}: {len(post.samples)} samples, best "
            f"p={post.max_sample().score.p():.4f} in {time.time() - t0:.1f}s")
    one, shard = runs["one card"], runs["2x2 mesh"]
    if shard.max_copy_nums() != one.max_copy_nums():
        raise AssertionError("mesh accepted other copy numbers")
    common = [s for s in one.samples if shard.contains(s.copy_nums)]
    a = np.array([s.score.likelihood for s in common])
    b = np.array([shard.find(s.copy_nums).score.likelihood for s in common])
    # a candidate no read path survives scores -inf on both sides
    fin = np.isfinite(a)
    if (fin != np.isfinite(b)).any() or (a[~fin] != b[~fin]).any():
        raise AssertionError("mesh and one card disagree on -inf scores")
    worst = float((np.abs(a[fin] - b[fin]) / np.abs(a[fin])).max())
    log(f"# mesh vs one card: same accepted copy numbers; {len(common)} "
        f"common samples ({int(fin.sum())} finite), worst relative "
        f"likelihood difference {worst:.3e}")
    if not worst <= REL_TOL:
        raise AssertionError(f"mesh scores differ by {worst:.3e}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the mesh phase, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX platform "
                 f"{jax.devices()[0].platform!r})")
    if len(jax.devices()) < args.devices:
        sys.exit(f"chip_smoke: {args.devices} GPUs asked, "
                 f"{len(jax.devices())} found")
    sys.path.insert(0, str(ROOT))
    from dbgphmm_tpu.compile_cache import enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    device_header(jax)
    t0 = time.time()
    if args.devices == 4:
        phase_c(args.devices)
    else:
        phase_a()
        log(f"# phase a done at {time.time() - t0:.1f}s")
        phase_b()
    log(f"# all phases done in {time.time() - t0:.1f}s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
