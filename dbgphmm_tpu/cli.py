"""Command-line interface (ref: src/bin/dbgphmm.rs + experiment binaries).

Production subcommands (matching the reference's flags):

* ``raw-dbg``  counts -> GFA                    (ref: bin/dbgphmm.rs RawDbg)
* ``draft``    reads -> k0 draft DBG            (ref: bin/dbgphmm.rs Draft)
* ``infer``    k0 DBG -> K_MAX posterior loop   (ref: bin/dbgphmm.rs Infer)
* ``euler``    DBG -> assembled FASTA           (ref: bin/dbgphmm.rs Euler)

Simulation subcommands (ref: bin/draft.rs, bin/infer.rs):

* ``sim-draft``  generate synthetic dataset (+ optional draft + true paths)
* ``sim-infer``  run inference against a dataset.json with truth tracking
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def _setup_jax(use_cpu: bool):
    import jax

    if use_cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from .compile_cache import enable_compile_cache

    enable_compile_cache()


def _make_mesh_from_arg(spec):
    """--mesh 'CxR' or 'N' -> ("cand", "reads") Mesh, or None."""
    if not spec:
        return None
    from .parallel.sharding import make_mesh

    if "x" in spec:
        c, r = (int(v) for v in spec.split("x", 1))
    else:
        c, r = 1, int(spec)
    return make_mesh(c * r, cand_axis=c)


def cmd_raw_dbg(args):
    from .hashdbg import HashDbg
    from .multi_dbg import MultiDbg
    from .multi_dbg import output as out
    from .seq.collection import ReadCollection

    reads = ReadCollection.from_fasta(args.read_fasta)
    hd = HashDbg.from_fragment_seqs(args.k, reads)
    hd.remove_rare_kmers(args.min_count)
    hd.remove_deadends(args.min_deadend_count)
    hd.to_gfa_file(args.gfa_output)
    print(f"# wrote {args.gfa_output} ({hd.n()} kmers)")


def cmd_draft(args):
    from .multi_dbg import output as out
    from .multi_dbg.draft import create_draft_from_reads
    from .seq.collection import ReadCollection

    reads = ReadCollection.from_fasta(args.read_fasta)
    print(f"# n_reads={len(reads)}")
    dbg = create_draft_from_reads(
        args.k, reads, args.p_error, args.genome_size,
        n_haplotypes=args.n_haplotypes,
        min_count=args.min_count, min_deadend_count=args.min_deadend_count,
    )
    out.to_dbg_file(dbg, args.dbg_output)
    print(f"# wrote {args.dbg_output} ({dbg})")
    if args.gfa_output:
        out.to_gfa_file(dbg, args.gfa_output)


def _run_inference(dbg, reads, args, paths_true=None, mappings=None):
    from .multi_dbg import output as out
    from .multi_dbg.posterior import infer_posterior_by_extension
    from .phmm.params import PHMMParams

    prefix = str(args.output_prefix)

    def _true_compact_copy_nums(dbg_k, paths):
        """Per-compact-edge true copy numbers from surviving full-edge paths
        (ref: posterior/output.rs:188-190 'diff to true' column).  When a
        mid-run purge removed some true paths, the diff stays alive for the
        still-contained subset (VERDICT r4 item 8) — the INSPECT numbers
        then measure distance to the SURVIVING haplotypes only."""
        if paths is None:
            return None
        alive = [p for p in paths if p is not None]
        if not alive:
            return None
        cn = [0] * dbg_k.n_edges_full()
        for p in alive:
            for e in p:
                cn[e] += 1
        return [
            cn[dbg_k.edges_in_full(ec)[0]] for ec in range(dbg_k.n_edges_compact())
        ]

    def on_iter(dbg_k, posterior, paths, mappings):
        k = dbg_k.k
        copy_nums_true = _true_compact_copy_nums(dbg_k, paths)
        out.to_dbg_file(dbg_k, f"{prefix}.k{k}.dbg")
        out.to_map_file(dbg_k, f"{prefix}.k{k}.map.mpz", reads, mappings)
        out.to_post_file(posterior, f"{prefix}.k{k}.post")
        out.to_gfa_file(dbg_k, f"{prefix}.k{k}.gfa")
        out.to_inspect_file(dbg_k, f"{prefix}.k{k}.inspect", posterior, copy_nums_true)
        print(f"# k={k} dumped {prefix}.k{k}.*")

    dbg_final, posterior, paths, mappings = infer_posterior_by_extension(
        k_max=args.k_max,
        dbg_init=dbg,
        param_infer=PHMMParams.uniform(args.p_infer),
        param_error=PHMMParams.uniform(args.p_error),
        reads=reads,
        genome_size_expected=args.genome_size,
        genome_size_sigma=args.genome_size_sigma,
        max_iter=args.max_iter,
        p0=args.p0,
        on_iter=on_iter,
        paths=paths_true,
        mappings=mappings,
        verbose=True,
        mesh=_make_mesh_from_arg(getattr(args, "mesh", None)),
    )
    out.to_dbg_file(dbg_final, f"{prefix}.final.dbg")
    out.to_gfa_file(dbg_final, f"{prefix}.final.gfa")
    out.to_inspect_file(
        dbg_final,
        f"{prefix}.final.inspect",
        posterior,
        _true_compact_copy_nums(dbg_final, paths),
    )
    dbg_final.to_fasta_linear(f"{prefix}.final.euler.fa")
    print(f"# wrote {prefix}.final.*")
    return dbg_final, posterior


def cmd_infer(args):
    from .multi_dbg import output as out
    from .seq.collection import ReadCollection

    reads = ReadCollection.from_fasta(args.read_fasta)
    dbg = out.from_dbg_file(args.dbg_input)
    mappings = None
    if getattr(args, "map_input", None):
        # restart from a dumped .map/.mpz instead of recomputing the
        # initial mappings (ref: bin/infer.rs:44-48 --map)
        mappings = out.from_map_file(args.map_input)
        if mappings.n_reads() != len(reads):
            raise SystemExit(
                f"--map {args.map_input}: {mappings.n_reads()} mapped reads "
                f"but {len(reads)} reads in {args.read_fasta} (truncated "
                f"dump or wrong file?)"
            )
    _run_inference(dbg, reads, args, mappings=mappings)


def cmd_euler(args):
    from .multi_dbg import output as out

    dbg = out.from_dbg_file(args.dbg)
    dbg.to_fasta_linear(args.fasta_out)
    print(f"# wrote {args.fasta_out}")


def cmd_sim_draft(args):
    """(ref: bin/draft.rs) Generate dataset + optional draft DBG."""
    from .e2e import ReadType, generate_dataset
    from .multi_dbg import output as out
    from .multi_dbg.draft import create_draft_from_dataset
    from .phmm.params import PHMMParams
    from .seq import genome as genome_gen

    g = genome_gen.tandem_repeat_polyploid_with_unique_homo_ends(
        args.unit_size, args.n_unit, args.unit_seed, args.div_init,
        args.div_seed, args.end_length, args.ploidy, args.div_hap, args.hap_seed,
    )
    ds = generate_dataset(
        g, args.read_seed, args.coverage, args.read_length,
        ReadType.FRAGMENT_WITH_REVCOMP if args.fragment else ReadType.FULL_LENGTH_WITH_REVCOMP,
        PHMMParams.uniform(args.p_error),
    )
    prefix = str(args.output_prefix)
    ds.write_files(prefix)
    print(f"# dataset: {len(ds.reads)} reads {ds.coverage():.1f}x -> {prefix}.json")
    if args.k:
        dbg = create_draft_from_dataset(args.k, ds)
        out.to_dbg_file(dbg, f"{prefix}.dbg")
        try:
            paths = dbg.paths_from_styled_seqs(ds.genome)
            out.to_paths_file(paths, f"{prefix}.paths")
            print(f"# draft contains true genome: wrote {prefix}.paths")
        except Exception as e:
            print(f"# true paths not in draft: {e}")
        print(f"# wrote {prefix}.dbg ({dbg})")


def cmd_sim_infer(args):
    """(ref: bin/infer.rs) Inference against dataset.json with truth diff."""
    from .e2e import Dataset
    from .multi_dbg import output as out

    ds = Dataset.from_json_file(args.dataset_json)
    dbg = out.from_dbg_file(args.dbg_input)
    paths_true = None
    partial = dbg.paths_from_styled_seqs_partial(ds.genome)
    n_ok = sum(1 for p in partial if p is not None)
    if n_ok == len(partial):
        paths_true = partial
    elif n_ok > 0:
        # keep tracking the still-contained haplotypes (VERDICT r4 item 8:
        # a mid-run purge that broke one haplotype must not silently kill
        # the truth diff for the other)
        paths_true = partial
        print(f"# warning: {len(partial) - n_ok}/{len(partial)} true "
              f"haplotype path(s) missing from the k={dbg.k} checkpoint "
              "graph (lost by an earlier purge — see 'TRUTH LOST'/"
              "'TRUTH-PURGE' lines in the run log); tracking the "
              f"{n_ok} still-contained path(s)")
    else:
        # distinguish the two causes (VERDICT r4 item 8): a draft that
        # never contained the truth vs a mid-run purge that removed true
        # edges before this checkpoint (the purge event itself is logged
        # by the infer loop at the stage it happens)
        if getattr(args, "map_input", None):
            print(f"# warning: true genome k-mers missing from the k={dbg.k} "
                  "checkpoint graph (lost by an earlier purge — see 'TRUTH "
                  "LOST' lines in the run log); truth diff disabled")
        else:
            print("# warning: true genome k-mers missing from draft "
                  "(cleaning dropped truth; run cannot be truth-graded)")
    args.genome_size = args.genome_size or ds.genome_size()
    mappings = None
    if getattr(args, "map_input", None):
        # restart from a per-k checkpoint: -d out.kK.dbg --map out.kK.map.mpz
        # (ref: bin/infer.rs:44-48; truth diff re-derives from the dataset)
        mappings = out.from_map_file(args.map_input)
        if mappings.n_reads() != len(ds.reads):
            raise SystemExit(
                f"--map {args.map_input}: {mappings.n_reads()} mapped reads"
                f" but {len(ds.reads)} reads in the dataset"
            )
    dbg_final, posterior = _run_inference(
        dbg, ds.reads, args, paths_true, mappings=mappings
    )
    # accuracy report
    haps = sorted(s.seq for s, _c in dbg_final.get_linear_haplotype_seqs())
    truth = sorted(s.seq for s in ds.genome)
    print(f"# assembled={len(haps)} truth={len(truth)} exact={haps == truth}")


def cmd_sample(args):
    """(ref: bin/sample.rs) Posterior sampling around a given DBG at fixed k."""
    from .multi_dbg import output as out
    from .multi_dbg.posterior import generate_mappings, sample_posterior
    from .phmm.params import PHMMParams
    from .seq.collection import ReadCollection

    reads = ReadCollection.from_fasta(args.read_fasta)
    dbg = out.from_dbg_file(args.dbg_input)
    params = PHMMParams.uniform(args.p_error)
    mesh = _make_mesh_from_arg(getattr(args, "mesh", None))
    mappings = generate_mappings(dbg, params, reads, mesh=mesh)
    post = sample_posterior(
        dbg, params, reads, mappings, args.genome_size, args.genome_size_sigma,
        max_iter=args.max_iter, rescue_only=not args.full, verbose=True,
        mesh=mesh,
    )
    out.to_post_file(post, f"{args.output_prefix}.post")
    out.to_inspect_file(dbg, f"{args.output_prefix}.inspect", post)
    print(f"# wrote {args.output_prefix}.post/.inspect "
          f"({len(post.samples)} samples, best p={post.max_sample().score.p():.3f})")


def cmd_mapping(args):
    """(ref: bin/mapping.rs) Dump per-read per-base mapping tables."""
    from .multi_dbg import output as out
    from .multi_dbg.posterior import generate_mappings
    from .phmm.params import PHMMParams
    from .seq.collection import ReadCollection

    reads = ReadCollection.from_fasta(args.read_fasta)
    dbg = out.from_dbg_file(args.dbg_input)
    maps = generate_mappings(
        dbg, PHMMParams.uniform(args.p_error), reads, n_active=args.n_active
    )
    out.to_map_file(dbg, args.map_output, reads, maps)
    print(f"# wrote {args.map_output}")


def cmd_freq(args):
    """(ref: bin/freq.rs) Node usage frequencies of reads on a DBG."""
    from .multi_dbg import output as out
    from .multi_dbg.posterior import generate_mappings
    from .phmm.params import PHMMParams
    from .seq.collection import ReadCollection

    reads = ReadCollection.from_fasta(args.read_fasta)
    dbg = out.from_dbg_file(args.dbg_input)
    maps = generate_mappings(dbg, PHMMParams.uniform(args.p_error), reads)
    freqs = maps.to_node_freqs(dbg.n_edges_full())
    with open(args.output, "w") as f:
        f.write("# edge_in_full\tkmer\tcopy_num\tfreq\n")
        for e in range(dbg.n_edges_full()):
            f.write(f"{e}\t{dbg.kmer_full(e).decode()}\t{dbg.copy_num(e)}\t{freqs[e]:.4f}\n")
    print(f"# wrote {args.output}")


def cmd_table(args):
    """(ref: bin/table.rs) Per-read log-likelihood table under a DBG."""
    import jax.numpy as jnp

    from .multi_dbg import output as out
    from .ops import forward_scores, pad_reads, to_device
    from .phmm.params import PHMMParams
    from .seq.collection import ReadCollection

    reads = ReadCollection.from_fasta(args.read_fasta)
    dbg = out.from_dbg_file(args.dbg_input)
    model = dbg.to_phmm(PHMMParams.uniform(args.p_error))
    dm = to_device(model, dtype=jnp.float64)
    codes, lens = pad_reads(list(reads))
    scores = forward_scores(dm, jnp.asarray(codes), jnp.asarray(lens), renorm=True)
    import numpy as np

    total = 0.0
    for i, s in enumerate(np.asarray(scores)):
        print(f"read {i}\tlen={lens[i]}\tlogP={float(s):.4f}")
        total += float(s)
    print(f"# total logP(R|X) = {total:.4f}")


def cmd_edit_dist(args):
    """(ref: bin/edit_dist.rs) Edit distance between assembly and truth."""
    from .seq.io import parse_fasta
    from .utils import edit_distance

    a = sorted(seq for _n, _d, seq in parse_fasta(args.fasta_a))
    b = sorted(seq for _n, _d, seq in parse_fasta(args.fasta_b))
    print(f"# {len(a)} vs {len(b)} sequences")
    for i, (x, y) in enumerate(zip(a, b)):
        d = edit_distance(x, y)
        print(f"pair {i}\tlen {len(x)} vs {len(y)}\tedit_dist={d}")


def cmd_modify_dbg(args):
    """(ref: bin/modify_dbg.rs) Apply an INSPECT sample's copy numbers."""
    from .multi_dbg import output as out

    dbg = out.from_dbg_file(args.dbg_input)
    inspect = out.parse_inspect_file(args.inspect)
    sample = inspect["samples"][args.sample_id]
    dbg.set_copy_nums(sample["copy_nums"])
    out.to_dbg_file(dbg, args.dbg_output)
    print(f"# applied sample {args.sample_id} -> {args.dbg_output}")


def cmd_inspect(args):
    """(ref: bin/inspect.rs) Re-score a DBG's CURRENT copy numbers and the
    TRUE copy numbers (from the dataset's genome paths) against the reads —
    the quick "is the truth better than what the climb found?" tool."""
    from .e2e import Dataset
    from .multi_dbg import output as out
    from .multi_dbg.posterior import generate_mappings, score_candidates

    ds = Dataset.from_json_file(args.dataset_json)
    dbg = out.from_dbg_file(args.dbg)
    print(f"k={dbg.k} |E|={dbg.n_edges_full()}")
    params = ds.params

    cn_orig = dbg.get_copy_nums()
    paths_true = dbg.paths_from_styled_seqs(ds.genome)
    assert paths_true is not None and all(p is not None for p in paths_true), (
        "k-mer in genome is missing from the DBG"
    )
    cn_full = [0] * dbg.n_edges_full()
    for p in paths_true:
        for e in p:
            cn_full[e] += 1
    cn_true = [
        cn_full[dbg.edges_in_full(ec)[0]] for ec in range(dbg.n_edges_compact())
    ]
    mappings = generate_mappings(dbg, params, ds.reads)
    from .ops import pad_reads
    from .ops.sparse import pad_mappings

    codes, lens = pad_reads(list(ds.reads))
    width = max(a.shape[1] for a in mappings.nodes)
    mn = pad_mappings(mappings, codes.shape[1], width)
    scores = score_candidates(
        dbg, params, ds.reads, [cn_orig, cn_true], ds.genome_size(),
        args.sigma, codes=codes, lens=lens, map_nodes=mn,
    )
    for name, cn, sc in (("orig", cn_orig, scores[0]), ("true", cn_true, scores[1])):
        print(f"{name}\t{sc.p():.4f}\t{sc.likelihood:.4f}\t{sc.to_json()}\t{cn}")
    work = dbg.copy()
    work.set_copy_nums(cn_true)
    out.to_map_file(work, f"{args.output_prefix}.true.map", ds.reads, mappings)
    print(f"# wrote {args.output_prefix}.true.map")


def cmd_sample_from_true(args):
    """(ref: bin/sample_from_true.rs) Posterior sampling around the TRUE
    copy numbers of a dataset's genome -- checks that the truth is a local
    optimum and how the posterior mass spreads around it."""
    from .e2e import Dataset
    from .multi_dbg import MultiDbg
    from .multi_dbg import output as out
    from .multi_dbg.posterior import generate_mappings, sample_posterior

    ds = Dataset.from_json_file(args.dataset_json)
    dbg = MultiDbg.from_styled_seqs(args.k, list(ds.genome))
    print(f"# true DBG: {dbg}")
    mappings = generate_mappings(dbg, ds.params, ds.reads)
    post = sample_posterior(
        dbg, ds.params, ds.reads, mappings, ds.genome_size(),
        args.genome_size_sigma, max_iter=args.max_iter,
        rescue_only=False, verbose=True,
    )
    true_cn = dbg.get_copy_nums()
    best = post.max_copy_nums()
    print(f"# truth is argmax: {best == true_cn}")
    out.to_inspect_file(dbg, f"{args.output_prefix}.inspect", post, true_cn)
    out.to_post_file(post, f"{args.output_prefix}.post")
    print(f"# wrote {args.output_prefix}.inspect/.post")


def cmd_extend_mapping(args):
    """(ref: bin/extend_mapping.rs; posterior/test.rs:145-237
    test_mapping_extension) At each k: carry the mapping across purge/k+1
    extension, compare its likelihood against a freshly computed mapping,
    and dump both as .map files."""
    import numpy as np

    from .e2e import Dataset
    from .multi_dbg import output as out
    from .multi_dbg.posterior import Mappings, generate_mappings
    from .ops import pad_reads
    from .ops.batch import candidate_log_likelihoods
    from .phmm.params import PHMMParams

    ds = Dataset.from_json_file(args.dataset_json)
    dbg = out.from_dbg_file(args.dbg_input)
    params = PHMMParams.uniform(args.p_infer)
    reads = ds.reads
    paths = dbg.paths_from_styled_seqs(ds.genome)
    mappings = generate_mappings(dbg, params, reads)
    prefix = str(args.output_prefix)
    codes, lens = pad_reads(list(reads))

    def lists_to_mappings(maps_arrays, read_logps=None):
        # purge_and_extend returns padded per-read arrays; placeholder nan
        # weights mark the raw upconverted hint as not-a-real-posterior
        # (real probs come from the refine step below)
        nodes = list(maps_arrays)
        return Mappings(nodes, [np.full(a.shape, np.nan) for a in nodes],
                        read_logps)

    def likelihood_with(mps):
        from .ops.sparse import pad_mappings

        width = max(a.shape[1] for a in mps.nodes)
        mn = pad_mappings(mps, codes.shape[1], width)
        model = dbg.to_phmm(params)
        return float(
            candidate_log_likelihoods([model], codes, lens, map_nodes=mn)[0]
        )

    while dbg.k < args.k_max:
        # true copy numbers from genome paths
        cn_full = [0] * dbg.n_edges_full()
        for p in paths:
            if p is None:
                continue
            for e in p:
                cn_full[e] += 1
        cn = [
            cn_full[dbg.edges_in_full(ec)[0]]
            for ec in range(dbg.n_edges_compact())
        ]
        dbg.set_copy_nums(cn)
        zero_edges = [
            e for e in range(dbg.n_edges_compact())
            if dbg.copy_num_of_edge_in_compact(e) == 0
        ]
        t0 = time.time()
        dbg, paths, maps_ext = dbg.purge_and_extend(
            zero_edges, args.k_max, True, paths, list(mappings.nodes)
        )
        t_extend = time.time() - t0
        # refine: re-run the decode seeded with the extended mapping before
        # scoring and before carrying it to the next k
        # (ref: posterior/test.rs:184-187)
        hint = lists_to_mappings(maps_ext, getattr(mappings, "read_logps", None))
        t0 = time.time()
        mappings = generate_mappings(dbg, params, reads, hint=hint, verbose=True)
        t_refine = time.time() - t0

        t0 = time.time()
        mappings_true = generate_mappings(dbg, params, reads)
        t_map = time.time() - t0

        out.to_map_file(dbg, f"{prefix}.k{dbg.k}.extend.map", reads, mappings)
        out.to_map_file(dbg, f"{prefix}.k{dbg.k}.true.map", reads, mappings_true)
        out.to_dbg_file(dbg, f"{prefix}.k{dbg.k}.dbg")
        out.to_gfa_file(dbg, f"{prefix}.k{dbg.k}.gfa")

        p_extend = likelihood_with(mappings)
        p_true = likelihood_with(mappings_true)
        print(
            f"k={dbg.k} p_extend={p_extend:.4f} p_true={p_true:.4f} "
            f"t_extend={t_extend * 1e3:.0f}ms t_refine={t_refine * 1e3:.0f}ms "
            f"t_map={t_map * 1e3:.0f}ms"
        )


def cmd_speed_test(args):
    """(ref: bin/speed_test.rs, hmmv2/speed.rs) Kernel micro-benchmarks."""
    import bench  # repo-root bench module when run from repo; else inline

    bench.main()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dbgphmm",
        description="Bayesian genome assembler on JAX (dbgphmm_tpu)",
    )
    p.add_argument("--cpu", action="store_true", help="force JAX CPU backend")
    p.add_argument(
        "--dist", default=None, metavar="ADDR:PORT,N,I",
        help="multi-host launch: jax.distributed coordinator address, total"
             " process count, and this process's id (under a cluster"
             " scheduler JAX recognizes, such as SLURM, ',,' lets all three"
             " auto-detect). Combine with --mesh to span every host's"
             " devices; reads shard across hosts.",
    )
    p.add_argument(
        "--mesh", default=None, metavar="CxR",
        help="shard over a device mesh: 'CxR' (candidates x reads, e.g. 2x4)"
             " or a device count N (reads-sharded 1xN); replaces the"
             " reference's -t thread count (rayon read fan-out)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    rd = sub.add_parser("raw-dbg", help="construct raw DBG from reads -> GFA")
    rd.add_argument("-k", type=int, required=True)
    rd.add_argument("-m", "--min-count", type=int, default=2)
    rd.add_argument("-M", "--min-deadend-count", type=int, required=True)
    rd.add_argument("read_fasta")
    rd.add_argument("-g", "--gfa-output", required=True)
    rd.set_defaults(fn=cmd_raw_dbg)

    d = sub.add_parser("draft", help="construct draft DBG from reads")
    d.add_argument("-k", type=int, required=True)
    d.add_argument("-m", "--min-count", type=int, default=2)
    d.add_argument("-M", "--min-deadend-count", type=int, required=True)
    d.add_argument("-p", "--p-error", type=float, default=0.001)
    d.add_argument("-G", "--genome-size", type=int, required=True)
    d.add_argument("-P", "--n-haplotypes", type=int, default=None)
    d.add_argument("read_fasta")
    d.add_argument("-d", "--dbg-output", required=True)
    d.add_argument("-g", "--gfa-output", default=None)
    d.set_defaults(fn=cmd_draft)

    inf = sub.add_parser("infer", help="posterior inference k0 -> K")
    inf.add_argument("-d", "--dbg-input", required=True)
    inf.add_argument(
        "--map", dest="map_input", default=None,
        help="restart from a dumped .map/.mpz mappings file (ref: bin/infer.rs:44-48)",
    )
    inf.add_argument("-o", "--output-prefix", required=True)
    inf.add_argument("-K", "--k-max", type=int, required=True)
    inf.add_argument("-G", "--genome-size", type=int, required=True)
    inf.add_argument("-S", "--genome-size-sigma", type=int, default=100)
    inf.add_argument("read_fasta")
    inf.add_argument("-p", "--p-error", type=float, default=0.001)
    inf.add_argument("-e", "--p-infer", type=float, default=0.00001)
    inf.add_argument("--p0", type=float, default=0.8)
    inf.add_argument("-I", "--max-iter", type=int, default=50)
    inf.add_argument("-c", "--max-cycle-size", type=int, default=1000)
    inf.set_defaults(fn=cmd_infer)

    eu = sub.add_parser("euler", help="emit assembly FASTA from DBG")
    eu.add_argument("-d", "--dbg", required=True)
    eu.add_argument("fasta_out")
    eu.set_defaults(fn=cmd_euler)

    sd = sub.add_parser("sim-draft", help="generate synthetic dataset (+ draft)")
    sd.add_argument("-k", type=int, default=None)
    sd.add_argument("--unit-size", type=int, default=20)
    sd.add_argument("--n-unit", type=int, default=20)
    sd.add_argument("--unit-seed", type=int, default=0)
    sd.add_argument("--div-init", type=float, default=0.0)
    sd.add_argument("--div-seed", type=int, default=0)
    sd.add_argument("--end-length", type=int, default=100)
    sd.add_argument("--ploidy", "-P", type=int, default=2)
    sd.add_argument("--div-hap", type=float, default=0.02)
    sd.add_argument("--hap-seed", type=int, default=0)
    sd.add_argument("--read-seed", type=int, default=0)
    sd.add_argument("-C", "--coverage", type=int, default=10)
    sd.add_argument("-L", "--read-length", type=int, default=1000)
    sd.add_argument("-p", "--p-error", type=float, default=0.001)
    sd.add_argument("--fragment", action="store_true")
    sd.add_argument("-o", "--output-prefix", required=True)
    sd.set_defaults(fn=cmd_sim_draft)

    si = sub.add_parser("sim-infer", help="inference against dataset.json")
    si.add_argument("dataset_json")
    si.add_argument("-d", "--dbg-input", required=True)
    si.add_argument("-o", "--output-prefix", required=True)
    si.add_argument("-K", "--k-max", type=int, required=True)
    si.add_argument("-G", "--genome-size", type=int, default=None)
    si.add_argument("-S", "--genome-size-sigma", type=int, default=100)
    si.add_argument("-p", "--p-error", type=float, default=0.001)
    si.add_argument("-e", "--p-infer", type=float, default=0.00001)
    si.add_argument("--p0", type=float, default=0.8)
    si.add_argument("-I", "--max-iter", type=int, default=50)
    si.add_argument("--map", dest="map_input", default=None,
                    help="restart mappings from a dumped .map/.mpz")
    si.set_defaults(fn=cmd_sim_infer)

    sp = sub.add_parser("sample", help="posterior sampling at fixed k")
    sp.add_argument("-d", "--dbg-input", required=True)
    sp.add_argument("-o", "--output-prefix", required=True)
    sp.add_argument("-G", "--genome-size", type=int, required=True)
    sp.add_argument("-S", "--genome-size-sigma", type=int, default=100)
    sp.add_argument("-p", "--p-error", type=float, default=0.001)
    sp.add_argument("-I", "--max-iter", type=int, default=50)
    sp.add_argument("--full", action="store_true", help="full neighbor sets")
    sp.add_argument("read_fasta")
    sp.set_defaults(fn=cmd_sample)

    mp = sub.add_parser("mapping", help="dump per-read mapping tables")
    mp.add_argument("-d", "--dbg-input", required=True)
    mp.add_argument("-p", "--p-error", type=float, default=0.001)
    mp.add_argument("-n", "--n-active", type=int, default=40)
    mp.add_argument("read_fasta")
    mp.add_argument("-o", "--map-output", required=True)
    mp.set_defaults(fn=cmd_mapping)

    fr = sub.add_parser("freq", help="node usage frequencies")
    fr.add_argument("-d", "--dbg-input", required=True)
    fr.add_argument("-p", "--p-error", type=float, default=0.001)
    fr.add_argument("read_fasta")
    fr.add_argument("-o", "--output", required=True)
    fr.set_defaults(fn=cmd_freq)

    tb = sub.add_parser("table", help="per-read likelihood table")
    tb.add_argument("-d", "--dbg-input", required=True)
    tb.add_argument("-p", "--p-error", type=float, default=0.001)
    tb.add_argument("read_fasta")
    tb.set_defaults(fn=cmd_table)

    ed = sub.add_parser("edit-dist", help="edit distance between FASTAs")
    ed.add_argument("fasta_a")
    ed.add_argument("fasta_b")
    ed.set_defaults(fn=cmd_edit_dist)

    md = sub.add_parser("modify-dbg", help="apply INSPECT sample copy numbers")
    md.add_argument("-d", "--dbg-input", required=True)
    md.add_argument("--inspect", required=True)
    md.add_argument("--sample-id", type=int, default=0)
    md.add_argument("-o", "--dbg-output", required=True)
    md.set_defaults(fn=cmd_modify_dbg)

    ins = sub.add_parser(
        "inspect", help="re-score current vs true copy numbers on a dataset"
    )
    ins.add_argument("-d", "--dbg", required=True)
    ins.add_argument("dataset_json")
    ins.add_argument("-s", "--sigma", type=int, default=200)
    ins.add_argument("-o", "--output-prefix", default="inspect")
    ins.set_defaults(fn=cmd_inspect)

    sft = sub.add_parser("sample-from-true", help="posterior around the true DBG")
    sft.add_argument("dataset_json")
    sft.add_argument("-k", type=int, required=True)
    sft.add_argument("-S", "--genome-size-sigma", type=int, default=100)
    sft.add_argument("-I", "--max-iter", type=int, default=10)
    sft.add_argument("-o", "--output-prefix", required=True)
    sft.set_defaults(fn=cmd_sample_from_true)

    em = sub.add_parser(
        "extend-mapping",
        help="compare mapping upconversion across k vs fresh mapping",
    )
    em.add_argument("dataset_json")
    em.add_argument("-d", "--dbg-input", required=True)
    em.add_argument("-K", "--k-max", type=int, required=True)
    em.add_argument("-p", "--p-infer", type=float, default=0.001)
    em.add_argument("-o", "--output-prefix", required=True)
    em.set_defaults(fn=cmd_extend_mapping)

    st = sub.add_parser("speed-test", help="kernel micro-benchmarks")
    st.set_defaults(fn=cmd_speed_test)

    return p


def main(argv=None):
    # SIGUSR1 -> all-thread stack dump on stderr: lets the supervisor (or a
    # human) diagnose a host-side stall non-destructively before restarting
    # (round 5: a k=69 stage hung at ~50% CPU with no log progress and no
    # way to see where)
    try:
        import faulthandler
        import signal as _signal

        faulthandler.register(_signal.SIGUSR1, all_threads=True)
    except Exception:
        pass
    args = build_parser().parse_args(argv)
    if getattr(args, "dist", None):
        from .parallel.multihost import initialize, parse_dist_arg

        addr, n, i = (
            (None, None, None) if args.dist.strip(",") == ""
            else parse_dist_arg(args.dist)
        )
        initialize(addr, n, i)
    _setup_jax(args.cpu)
    t0 = time.time()
    print(f"# started_at={time.strftime('%Y-%m-%d %H:%M:%S')}")
    print(f"# version=dbgphmm_tpu")
    print(f"# args={vars(args)}")
    args.fn(args)
    print(f"# finished_at={time.strftime('%Y-%m-%d %H:%M:%S')} elapsed={time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
