"""Validate the >DENSE_COMPUTE_MAX_NODES (65,536) mapping regime at
production scale (ref: scripts/sim.sh:160,196-228 G=40-80kb diploid
configs).

Past 65,536 full edges, `generate_mappings` switches from the
dense-compute/compact-store decode (exact forward over all n nodes) to the
evolving top-K frontier (`mappings_sparse_adaptive` with n_top=64).  This
script builds a production-scale diploid DBG (G ~ 80kb total, n > 65,536
full edges), samples 10kb reads from the genome with the graph-PHMM
sampler, and measures:

1. per-read log-likelihood gap: frontier decode vs exact dense-compute
   decode (forced by raising the threshold);
2. mapping agreement: top-1 node match rate and active-set overlap;
3. downstream effect: mapped-scorer candidate scores under both mappings.

Run on the GPU (the dense-compute pass is O(B*L*n)); writes a summary to
stdout for docs/ACCURACY_NOTES.md.

Usage (from the repo root): PYTHONPATH=. python scripts/validate_large_n_mapping.py
"""

import sys
import time

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

from dbgphmm_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp

from dbgphmm_tpu.multi_dbg import MultiDbg
from dbgphmm_tpu.ops import pad_reads, to_device
from dbgphmm_tpu.ops.adaptive import mappings_sparse_adaptive
from dbgphmm_tpu.phmm.params import PHMMParams
from dbgphmm_tpu.phmm.sample import (
    SampleProfile,
    sample_positioned_reads_phmm,
)
from dbgphmm_tpu.seq import genome as genome_gen


def main():
    k = 40
    # ~40kb per haplotype diploid (500bp unit x 80), 2% divergence — the
    # sim.sh production class
    g = genome_gen.tandem_repeat_polyploid_with_unique_homo_ends(
        500, 80, 0, 0.02, 1, 300, 2, 0.02, 0
    )
    seqs = [s.seq for s in g]
    print(f"# genome: {len(seqs)} haplotypes, total {g.genome_size()} bp")

    t0 = time.time()
    dbg = MultiDbg.from_styled_seqs(k, list(g))
    n = dbg.n_edges_full()
    print(f"# DBG k={k}: n_full_edges={n} (built in {time.time()-t0:.0f}s)")
    assert n > 65536, f"need n > 65536, got {n} — raise n_unit"

    params = PHMMParams.uniform(0.001)
    model = dbg.to_phmm(params, mode="non_zero")
    dm = to_device(model, dtype=jnp.float32)

    # 4kb reads, small batch: the forced-dense reference pass is O(B*L*n)
    # with per-step top_k over n=80k lanes — the heaviest op this framework
    # runs; keep its footprint bounded
    reads = [
        r.seq
        for r in sample_positioned_reads_phmm(
            seqs, params,
            SampleProfile(n_reads=4, length=4400, seed=0), has_revcomp=False,
        )
        if len(r.seq) >= 2000
    ]
    print(f"# {len(reads)} reads, lengths {[len(r) for r in reads]}")
    codes, lens = pad_reads(reads)
    codes_d, lens_d = jnp.asarray(codes), jnp.asarray(lens)

    n_active, max_ratio = 128, 30.0

    # (a) exact dense score-only forward as the oracle, ON CPU IN f64 —
    # the decision quantity round-1b's failure mode corrupted was the
    # mapped LIKELIHOOD (mapped score 1e5 below dense when the frontier
    # lost true cells).  The oracle runs on the host backend in f64 —
    # exact, just slower.
    from dbgphmm_tpu.ops.forward import forward_scores

    cpu = jax.devices("cpu")[0]
    t0 = time.time()
    with jax.default_device(cpu):
        dm64 = to_device(model, dtype=jnp.float64)
        lp_d = np.asarray(
            forward_scores(
                dm64, jax.device_put(jnp.asarray(codes), cpu),
                jax.device_put(jnp.asarray(lens), cpu), renorm=True,
            )
        )
    t_dense = time.time() - t0
    print(f"# dense f64 forward (CPU oracle): {t_dense:.1f}s "
          f"logp={lp_d[:4].round(1)}")

    # (b) frontier decode (the production >65536 path)
    t0 = time.time()
    lp_f, mn_f, ml_f = mappings_sparse_adaptive(
        dm, codes_d, lens_d, n_top=64, n_active=n_active,
        max_ratio=max_ratio, n_warmup=16,
    )
    lp_f = np.asarray(lp_f)
    mn_f = np.asarray(mn_f)
    del ml_f
    t_frontier = time.time() - t0
    print(f"# frontier decode: {t_frontier:.1f}s logp={lp_f[:4].round(1)}")

    gaps = np.abs(lp_f - lp_d[: len(lp_f)])
    print(f"# per-read |logp gap| frontier-decode-vs-dense: "
          f"max={gaps.max():.3f} mean={gaps.mean():.3f}")

    # (c) downstream: mapped-scorer likelihood under the frontier mapping
    # must reproduce the dense likelihood of the true assignment
    from dbgphmm_tpu.ops.sparse import forward_scores_mapped

    model_n = dbg.to_phmm(params, mode="normal")
    dmn = to_device(model_n, dtype=jnp.float32)
    # two candidates: the truth, and a perturbation (one repeat-interior
    # compact edge copy 1->2).  The mapping-restricted likelihood sits a few
    # nats BELOW dense (score-ratio trimming sheds ~0.004 nats/position of
    # mass); what decides hill-climb moves is the BETWEEN-CANDIDATE score
    # difference under the SHARED mapping, which must match dense.
    import dataclasses

    from dbgphmm_tpu.multi_dbg.neighbors import to_short_neighbors

    truth = dbg.get_copy_nums()
    nbrs = to_short_neighbors(dbg, max_cycle_size=10, max_flip=2)
    assert nbrs, "no flow-consistent neighbors found"
    pert = nbrs[0][0]
    deltas = {}
    for name, cn in (("true", truth), ("pert", pert)):
        work = dbg.copy()
        work.set_copy_nums(cn)
        mm = work.to_phmm(params, mode="normal")
        dmn = to_device(mm, dtype=jnp.float32)
        sc_mapped = np.asarray(
            forward_scores_mapped(
                dmn, codes_d, lens_d, jnp.asarray(mn_f), renorm=True
            )
        )
        with jax.default_device(cpu):
            dmn64 = to_device(mm, dtype=jnp.float64)
            sc_dense = np.asarray(
                forward_scores(
                    dmn64, jax.device_put(jnp.asarray(codes), cpu),
                    jax.device_put(jnp.asarray(lens), cpu), renorm=True,
                )
            )
        deltas[name] = (sc_mapped, sc_dense)
        gap = np.abs(sc_mapped - sc_dense)
        print(f"# {name}: mapped={sc_mapped.round(1)} dense={sc_dense.round(1)}"
              f" restriction gap max={gap.max():.2f}")
    d_mapped = deltas["true"][0].sum() - deltas["pert"][0].sum()
    d_dense = deltas["true"][1].sum() - deltas["pert"][1].sum()
    print(f"# candidate score DIFFERENTIAL (true - perturbed): "
          f"mapped={d_mapped:.3f} dense={d_dense:.3f} "
          f"|err|={abs(d_mapped - d_dense):.3f}")

    ok = gaps.max() < 1.0 and abs(d_mapped - d_dense) < 1.0 and (
        (d_mapped > 0) == (d_dense > 0)
    )
    print(f"# VERDICT: {'OK' if ok else 'DISAGREEMENT — investigate'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
