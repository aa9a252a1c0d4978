"""Timings of the two device hot paths on one GPU (not yet a benchmark:
there are no cells, repetitions or limits).

* candidate scoring on the real ``data/bench`` graph (n4 draft, k=40, 98
  reads x 10 kb, seeded mappings trimmed to width 32, 64 rescue-style
  candidates) through the scorer the platform selects;
* forward-backward mapping decode at k=10k scale (a synthetic n=100k-state
  chain, 384 reads x 10 kb, the evolving-frontier kernel).

Reference baseline: sparse forward ~0.3 s per 1kb read single-core M1
(ref: src/hmmv2/speed.rs:307-315) -> ~0.33 reads/s for a 10kb read.

Prints one JSON line per measurement, each naming the device and its power
limit.  Exits non-zero without a GPU.
"""

import json
import subprocess
import sys
import time

import numpy as np

BASELINE_READS_PER_SEC = 1.0 / (0.3 * 10)  # 10kb read, ref sparse forward


def _device(jax) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def scoring(jax):
    from chip_smoke import bench_batch, load_fixture
    from dbgphmm_tpu.ops.batch import make_candidate_scorer

    ds, dbg = load_fixture()
    tpl, pos, codes, lens, cands = bench_batch(ds, dbg)
    scorer = make_candidate_scorer(tpl, pos, codes, lens, tpl.params)
    scorer.scores(cands)  # compile + warm
    t0 = time.perf_counter()
    scorer.scores(cands)
    dt = time.perf_counter() - t0
    thr = len(cands) * len(lens) / dt
    return {
        "metric": "real_graph_scorings_per_sec_k40",
        "value": thr,
        "unit": f"10kb-read scorings/s ({type(scorer).__name__}; n4 draft "
                f"n={dbg.n_edges_full()} full edges, "
                f"NC={dbg.n_edges_compact()}, width "
                f"{pos.map_nodes.shape[2]}, C={len(cands)} x "
                f"{len(lens)} reads)",
        "vs_baseline": thr / BASELINE_READS_PER_SEC,
    }


def fwd_bwd(jax):
    import jax.numpy as jnp

    from dbgphmm_tpu.ops.adaptive import mappings_sparse_adaptive
    from dbgphmm_tpu.ops.forward import to_device
    from dbgphmm_tpu.phmm.model import PHMMModel
    from dbgphmm_tpu.phmm.params import PHMMParams

    rng = np.random.default_rng(0)
    n, D, B, L = 100_000, 2, 384, 10_000
    parent_idx = np.zeros((n, D), dtype=np.int32)
    parent_logt = np.full((n, D), -np.inf)
    parent_idx[:, 0] = np.maximum(np.arange(n) - 1, 0)
    parent_logt[:, 0] = 0.0
    child_idx = np.zeros((n, D), dtype=np.int32)
    child_logt = np.full((n, D), -np.inf)
    child_idx[:, 0] = np.minimum(np.arange(n) + 1, n - 1)
    child_logt[:-1, 0] = 0.0
    emission = rng.integers(0, 4, n).astype(np.uint8)
    model = PHMMModel(
        PHMMParams.uniform(0.001), emission, np.full(n, -np.log(n)),
        parent_idx, parent_logt, child_idx, child_logt,
    )
    dm = to_device(model, dtype=jnp.float32)
    start = rng.integers(0, n - L, B)
    codes = jnp.asarray(emission[start[:, None] + np.arange(L)[None, :]]
                        .astype(np.int32))
    lens = jnp.full((B,), L, dtype=jnp.int32)
    kw = dict(n_top=64, n_active=64, max_ratio=30.0, n_warmup=16,
              stored_k=64, store_bf16=True)
    np.asarray(mappings_sparse_adaptive(dm, codes, lens, **kw)[0])
    t0 = time.perf_counter()
    logp = np.asarray(mappings_sparse_adaptive(dm, codes, lens, **kw)[0])
    dt = time.perf_counter() - t0
    assert np.all(np.isfinite(logp))
    return {
        "metric": "fwd_bwd_mapping_reads_per_sec_k10k",
        "value": B / dt,
        "unit": f"10kb-read fwd-bwd decodes/s (n=100k states, "
                f"sparse-adaptive, n_top=64, B={B}, bf16 compact-stored "
                f"tables)",
        "vs_baseline": (B / dt) / BASELINE_READS_PER_SEC,
    }


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench: no GPU (JAX platform {jax.devices()[0].platform!r})")
    from dbgphmm_tpu.compile_cache import enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    device = _device(jax)
    for measure in (scoring, fwd_bwd):
        print(json.dumps(dict(measure(jax), device=device)), flush=True)


if __name__ == "__main__":
    main()
